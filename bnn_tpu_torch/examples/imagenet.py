"""ImageNet-style distributed recipe-driven QAT trainer (counterpart of
``examples/imagenet.py``)::

    python -m bnn_tpu_torch.examples.imagenet --synthetic \\
        --recipe examples/recipes/imagenet-baseline.yaml --step 0 --epochs 90
    torchrun --standalone --nproc-per-node 4 -m bnn_tpu_torch.examples.imagenet \\
        --synthetic --model-parallel 2 --zero1          # one rank a card
    python -m bnn_tpu_torch.examples.imagenet --device cpu ...   # plain PyTorch

One process a device under ``torchrun``, whose environment gives the world
(a plain run is a world of one): a ``(data, model)`` mesh over the ranks
(``parallel.make_mesh``), the model placed on it (``shard_model``: BatchNorm
over the whole batch, gradients averaged over ``data``, ``--model-parallel``
splitting out-channels over ``model``), ``--zero1`` splitting the optimizer's
moments over ``data``, ``--accum-steps``, ``--bf16`` (bf16 compute, f32
masters) and ``--remat`` in ``parallel.make_train_step``. ``-b`` is the
global batch: each rank takes its rows of it (with ``--accum-steps``, its
share of each microbatch: :func:`accumulation_order`). The model is the reference's
ImageNet configuration, a pre-activation PReLU ResNet (``--arch``,
``--stem-type``), binarized by step ``--step`` of ``--recipe``
(``BinaryChef``), whose optimizer and lr schedule it trains with where the
step declares them (else the CLI's: ``make_optimizer``, ``make_scheduler``).
``--resume`` restores the model, the optimizer's moments and the schedule's
position; ``--evaluate`` validates once and trains nothing; every rank takes
part in each epoch's checkpoint (``save_checkpoint`` gathers the shards,
rank 0 writes).

``--pipeline N`` trains a GPipe pipeline of N stages over a ``(pipe, data)``
mesh (``HeteroPipeline``) on its flat parameter buffer (``train_pipelined``).

Data: ``--data DIR`` holding ``{train,val}_{x,y}.npy``; a uint8 store goes
through ``NativeDataLoader`` (each data rank its own shard of every epoch)
and ``prefetch_to_device(mesh=, host_shards=True)``, a float one through
:func:`npy_batches`. Else ``--synthetic`` batches (:func:`synthetic_batches`,
the JAX trainer's numbers in NCHW).

The JAX trainer's multi-host flags are ``torchrun``'s rendezvous here, and
passing one is an error that says so: ``--coordinator HOST:PORT`` is
``torchrun --rdzv-endpoint HOST:PORT`` (or ``--master-addr`` /
``--master-port``), ``--num-hosts N`` is ``torchrun --nnodes N`` and
``--host-id K`` is ``torchrun --node-rank K``. ``--dist-backend`` (the
reference's flag) is NCCL on CUDA and gloo on the CPU by default; two ranks
on one card take ``--device cuda:0 --dist-backend gloo``.
"""
from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

import bnn_tpu_torch as bt
from bnn_tpu_torch.data import NativeDataLoader, prefetch_to_device
from bnn_tpu_torch.engine import (RecipeError, ScheduledAdam, ScheduledAdamW,
                                  ScheduledSGD)
from bnn_tpu_torch.models.layers import PreBasicBlock
from bnn_tpu_torch.parallel import (HeteroPipeline, make_eval_step, make_mesh,
                                    make_pipeline_mesh, make_train_step,
                                    shard_model, shard_optimizer_zero1)
from bnn_tpu_torch.parallel.mesh import Spec, _tag, cli_world, rank_device
from bnn_tpu_torch.utils import (AverageMeter, ProgressMeter, gather_replicated,
                                 load_checkpoint, restore_into, restore_optimizer,
                                 save_checkpoint)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# the JAX trainer's multi-host flags and the torchrun flag that replaces each
TORCHRUN_FLAGS = {
    "coordinator": "torchrun --rdzv-endpoint HOST:PORT (or --master-addr/--master-port)",
    "num_hosts": "torchrun --nnodes N",
    "host_id": "torchrun --node-rank K",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="bnn_tpu_torch ImageNet QAT training")
    p.add_argument("--data", default=None, help="dataset directory")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("-a", "--arch", default="resnet18",
                   choices=["resnet18", "resnet34", "resnet50"])
    p.add_argument("--stem-type", default="basic", choices=["basic", "dabnn"])
    p.add_argument("--recipe", default="examples/recipes/imagenet-baseline.yaml")
    p.add_argument("--step", type=int, default=0,
                   help="recipe step to train (reference imagenet.py:154-156)")
    p.add_argument("--epochs", type=int, default=None,
                   help="epoch budget (default: the recipe step's 'epochs' "
                        "if declared, else 90)")
    p.add_argument("-b", "--batch-size", type=int, default=256,
                   help="global batch size across all ranks")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--optimizer", default="adamw", choices=["adamw", "adam", "sgd"])
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--scheduler", default="cosine", choices=["cosine", "multistep"])
    p.add_argument("--warmup-epochs", type=int, default=5)
    p.add_argument("--milestones", type=int, nargs="*", default=[30, 60, 80])
    p.add_argument("--resume", default=None)
    p.add_argument("-e", "--evaluate", action="store_true",
                   help="evaluate the model on the validation set and exit")
    p.add_argument("--out", default="./checkpoint/imagenet")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--print-freq", type=int, default=50)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--steps-per-epoch", type=int, default=None,
                   help="override synthetic epoch length")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="size of the tensor-parallel mesh axis")
    p.add_argument("--pipeline", type=int, default=1,
                   help="pipeline-parallel stages (GPipe over a 'pipe' mesh "
                        "axis via HeteroPipeline; 1 = off); composes with data "
                        "parallelism on the remaining ranks, not with "
                        "--model-parallel/--zero1/--accum-steps")
    p.add_argument("--microbatches", type=int, default=4,
                   help="GPipe microbatches per step (with --pipeline)")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient-accumulation microbatches per step")
    p.add_argument("--zero1", action="store_true",
                   help="shard optimizer moments over the data axis (ZeRO-1)")
    p.add_argument("--bf16", action="store_true",
                   help="mixed-precision QAT: bf16 compute, f32 masters")
    p.add_argument("--remat", action="store_true",
                   help="recompute activations in the backward pass")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (cuda:LOCAL_RANK under torchrun), 'cuda:0' (every "
                        "rank on one card, with --dist-backend gloo) or 'cpu'")
    p.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                   help="torch.distributed backend (default: nccl on CUDA, gloo "
                        "on the CPU)")
    # the JAX trainer's multi-host rendezvous: torchrun's here (refused below)
    p.add_argument("--coordinator", default=None, help=TORCHRUN_FLAGS["coordinator"])
    p.add_argument("--num-hosts", type=int, default=None, help=TORCHRUN_FLAGS["num_hosts"])
    p.add_argument("--host-id", type=int, default=None, help=TORCHRUN_FLAGS["host_id"])
    args = p.parse_args(argv)
    for flag, instead in TORCHRUN_FLAGS.items():
        if getattr(args, flag) is not None:
            p.error(f"--{flag.replace('_', '-')} is torchrun's rendezvous in this "
                    f"trainer: launch with {instead}")
    return args


def make_scheduler(args, steps_per_epoch: int):
    """The lr at each optimizer step: a linear warmup from 0 over
    ``--warmup-epochs``, then cosine decay over the remaining epochs or
    decay by 0.1 at each of ``--milestones`` (absolute epochs, shifted left
    by the warmup; those inside it are dropped), as the JAX trainer's optax
    schedule."""
    lr = args.lr
    warmup = args.warmup_epochs * steps_per_epoch
    if args.scheduler == "cosine":
        total = max(1, (args.epochs - args.warmup_epochs) * steps_per_epoch)

        def main(t):
            return lr * (0.5 * (1 + math.cos(math.pi * min(t, total) / total)))
    else:
        bounds = sorted({m * steps_per_epoch - warmup for m in args.milestones
                         if m * steps_per_epoch > warmup})

        def main(t):
            v = lr
            for b in bounds:
                if t >= b:
                    v *= 0.1
            return v

    def schedule(t):
        t = int(t)
        if t < warmup:
            return (0.0 - lr) * (1 - t / warmup) + lr
        return main(t - warmup)

    return schedule


def make_optimizer(args, schedule):
    """``params -> optimizer`` of the CLI's choice over ``schedule``; weight
    decay is zeroed for binarized steps > 0, like the reference (decaying
    binary weights fights the binarizer)."""
    wd = args.weight_decay if args.step == 0 else 0.0
    if args.optimizer == "adamw":
        return lambda params: ScheduledAdamW(params, schedule, weight_decay=wd)
    if args.optimizer == "adam":
        return lambda params: ScheduledAdam(params, schedule)
    return lambda params: ScheduledSGD(params, schedule, momentum=0.9)


def synthetic_batches(batch: int, steps: int, seed: int = 0, size: int = 224):
    """The JAX trainer's synthetic numbers (``(batch, size, size, 3)`` normal
    images, labels in [0, 1000)), the images in NCHW and the labels int64."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        # rng.normal(0, 1)'s draws; cast and transposed in one pass
        z = rng.standard_normal((batch, size, size, 3))
        x = np.empty((batch, 3, size, size), np.float32)
        x[...] = z.transpose(0, 3, 1, 2)
        yield x, rng.integers(0, 1000, batch).astype(np.int64)


def npy_batches(data_dir: str, split: str, batch: int, shuffle: bool, seed: int = 0):
    """Float batches of ``{split}_x.npy`` (NHWC) and ``{split}_y.npy``, in
    NCHW."""
    xs = np.load(os.path.join(data_dir, f"{split}_x.npy"), mmap_mode="r")
    ys = np.load(os.path.join(data_dir, f"{split}_y.npy"))
    idx = np.arange(len(xs))
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    for b in range(0, len(idx) - batch + 1, batch):
        sel = np.sort(idx[b:b + batch])
        x = np.asarray(xs[sel], np.float32).transpose(0, 3, 1, 2)
        yield np.ascontiguousarray(x), ys[sel].astype(np.int64)


def accumulation_order(batches, accum_steps: int, n_data: int):
    """Global batches with their rows reordered for ``--accum-steps`` over a
    data axis: each data rank keeps one contiguous block of rows
    (``shard_batch``) and the train step cuts it into ``accum_steps``
    microbatches, so microbatch ``k`` of rank ``r`` is made share ``r`` of the
    global microbatch ``k`` (rows ``k * b / accum_steps`` on). BatchNorm
    then reduces over the global microbatch, as with one rank."""
    for batch in batches:
        if accum_steps == 1 or n_data == 1:
            yield batch
            continue
        yield tuple(np.ascontiguousarray(
            a.reshape(accum_steps, n_data, -1, *a.shape[1:]).swapaxes(0, 1)
            .reshape(a.shape)) for a in batch)


def build_model(args, chef) -> nn.Module:
    """The pre-activation PReLU ResNet of ``--arch`` and ``--stem-type``,
    weights from ``--seed``, binarized by ``chef``'s step ``--step``."""
    model = getattr(bt.models, args.arch)(
        block_type=PreBasicBlock, activation=nn.PReLU, stem_type=args.stem_type,
        generator=torch.Generator().manual_seed(args.seed))
    return chef.run_step(model, args.step)


def resnet_pipeline_stages(model, n: int):
    """Split a (binarized) ResNet into ``n`` contiguous pipeline stages of its
    natural units (stem, layer1..4, head). The stages wrap the model's own
    submodules, so writing a stage's state writes the model's."""
    units = [nn.Sequential(model.conv1, model.bn1, model.relu, model.maxpool)
             if model.stem_type == "basic" else nn.Sequential(model.conv1)]
    units += [getattr(model, f"layer{i}") for i in (1, 2, 3, 4)]
    units.append(nn.Sequential(model.avgpool, nn.Flatten(), model.fc))
    if not 1 < n <= len(units):
        raise ValueError(f"--pipeline {n}: the ResNet splits into 2 to {len(units)} stages")
    groups = np.array_split(np.arange(len(units)), n)
    return [nn.Sequential(*[units[i] for i in g]) for g in groups]


def pipeline_step(pipe, flat, optimizer, x, y, microbatches: int):
    """One GPipe step on this rank's row ``flat`` (the optimizer's one
    parameter): the pipelined forward with the stages' buffer writes
    (``return_state``), then the optimizer on the parameter lanes only. The
    row mixes parameters with BatchNorm running statistics, so the
    optimizer sees ``new_row * param_mask``: a decoupled weight decay never
    shrinks the statistics, which come back from the forward as they are
    (their gradient is 0, so Adam's update is too). Returns the loss and the
    top-1 share."""
    optimizer.zero_grad(set_to_none=True)
    logits, new = pipe.apply(flat, x, n_microbatches=microbatches, return_state=True)
    loss = torch.nn.functional.cross_entropy(logits, y)
    loss.backward()
    mask = pipe.param_mask
    with torch.no_grad():
        flat.copy_(new * mask)
        optimizer.step()
        flat.add_(new * (1 - mask))
    top1 = (logits.argmax(-1) == y).float().mean()
    return loss.detach(), top1


def train_pipelined(args, model, chef, device, is_host0: bool) -> None:
    """GPipe pipeline-parallel training over a ``(pipe, data)`` mesh, on
    ``HeteroPipeline``'s flat parameter buffer (an elementwise optimizer on
    it is the per-leaf update), BatchNorm running statistics carried through
    the schedule. The flat optimizer state rides in the checkpoint as
    ``opt_state['pipeline_flat']`` (its moments whole), so a pipeline run
    resumes from it; the model's state is written back into the model, so
    the checkpoint also serves the sequential trainer (``--evaluate``)."""
    if args.data:
        raise ValueError("--pipeline trains on synthetic data only (use the "
                         "data- and tensor-parallel path for dataset runs)")
    world = dist.get_world_size()
    if world % args.pipeline:
        raise ValueError(f"--pipeline {args.pipeline} does not divide {world} ranks")
    mesh = make_pipeline_mesh(pipe=args.pipeline, data=world // args.pipeline,
                              device=device)
    if is_host0:
        print(f"==> pipeline mesh {mesh.shape} over {world} ranks")
    if args.batch_size % args.microbatches:
        raise ValueError(f"-b {args.batch_size} does not split into "
                         f"{args.microbatches} microbatches")

    start_epoch, payload = 0, None
    if args.resume:
        # the model's state first, so that the flat buffer starts from it;
        # the flat optimizer state below, once the buffer exists
        payload = load_checkpoint(args.resume)
        skipped = restore_into(model, payload, strict=False)
        if skipped and is_host0:
            print(f"==> pipeline resume skipped {len(skipped)} mismatched entries")
        start_epoch = int(payload.get("metadata", {}).get("epoch", 0))

    model.train()
    stages = resnet_pipeline_stages(model, args.pipeline)
    pipe = HeteroPipeline(stages, x_shape=(3, args.image_size, args.image_size),
                          mesh=mesh)
    steps_per_epoch = args.steps_per_epoch or 256
    if args.epochs is None:
        args.epochs = chef.epochs(args.step) or 90
    try:
        tx = chef.make_tx(args.step, steps_per_epoch)
    except RecipeError:
        tx = make_optimizer(args, make_scheduler(args, steps_per_epoch))
    flat = nn.Parameter(pipe.flat_params.clone())
    _tag(flat, mesh, Spec("pipe", None))  # moments gathered whole by pipe row
    optimizer = tx([flat])
    saved = (payload or {}).get("opt_state") or {}
    if saved.get("pipeline_flat") is not None:
        skipped = restore_optimizer(optimizer, {"opt_state": saved["pipeline_flat"]},
                                    strict=False)
        if is_host0:
            print("==> pipeline resume restored optimizer state" if not skipped else
                  "==> checkpoint optimizer state incompatible with this pipeline "
                  "config; moments reset")

    def checkpoint_now(epoch_done: int) -> None:
        # every rank gathers the pipe-sharded rows (and moments) first: a
        # collective; then the stages' states go back into the model's own
        # modules and rank 0 writes
        flat_full = gather_replicated(flat).detach()
        moments = gather_replicated(optimizer)
        for module, state in zip(stages, pipe.unflatten_stage_states(flat_full)):
            module.load_state_dict(state)
        if dist.get_rank() == 0:
            save_checkpoint(args.out, model, opt_state={"pipeline_flat": moments},
                            metadata={"epoch": epoch_done, "arch": args.arch,
                                      "step": args.step, "pipeline": args.pipeline})
        dist.barrier()

    for epoch in range(start_epoch, args.epochs):
        losses = AverageMeter("Loss", ":.4e")
        top1m = AverageMeter("Acc@1", ":6.2f")
        batches = synthetic_batches(args.batch_size, steps_per_epoch,
                                    seed=args.seed + epoch, size=args.image_size)
        start = time.perf_counter()
        for i, (xb, yb) in enumerate(prefetch_to_device(batches, device=device)):
            loss, top1 = pipeline_step(pipe, flat, optimizer, xb, yb, args.microbatches)
            losses.update(float(loss), len(yb))
            top1m.update(float(top1) * 100.0, len(yb))
            if is_host0 and i % args.print_freq == 0:
                print(f"PipeEpoch[{epoch}][{i}/{steps_per_epoch}] {losses} {top1m}")
        seconds = time.perf_counter() - start
        checkpoint_now(epoch + 1)
        if is_host0:
            print(f" * PipeEpoch {epoch}: Loss {losses.avg:.4f} Acc@1 {top1m.avg:.3f} "
                  f"({steps_per_epoch * args.batch_size / seconds:.1f} images/s, "
                  f"{1e3 * seconds / steps_per_epoch:.2f} ms a step)")
    if is_host0:
        print(f"==> pipelined training done; checkpoint at {args.out}")


def validate(args, model, eval_step, mesh, val_loader):
    """One pass over the validation split; returns (acc1, acc5) in percent
    (the reference's ``validate()``)."""
    model.eval()
    tot = {"loss": 0.0, "top1": 0.0, "top5": 0.0, "count": 0.0}
    if val_loader is not None:
        val_it = prefetch_to_device(iter(val_loader), mesh=mesh, host_shards=True)
    elif args.data and not args.synthetic:
        val_it = prefetch_to_device(npy_batches(args.data, "val", args.batch_size, False),
                                    mesh=mesh)
    else:
        val_it = prefetch_to_device(synthetic_batches(args.batch_size, 8, seed=999,
                                                      size=args.image_size), mesh=mesh)
    for xb, yb in val_it:
        m = eval_step(model, xb, yb)
        for k in tot:
            tot[k] += float(m[k])
    return (100.0 * tot["top1"] / tot["count"], 100.0 * tot["top5"] / tot["count"])


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the trainer runs on CUDA by default and no CUDA device "
                           "is available; pass --device cpu")
    device = rank_device(device)
    with cli_world(device, args.dist_backend) as (rank, _):
        return run(args, device, rank == 0)


def run(args, device: torch.device, is_host0: bool):
    chef = bt.BinaryChef(args.recipe)
    model = build_model(args, chef)
    if is_host0:
        print(f"==> {args.arch} binarized with step {args.step} of {args.recipe}")

    if args.pipeline > 1:
        if args.model_parallel != 1 or args.zero1 or args.accum_steps != 1:
            raise ValueError("--pipeline composes with data parallelism only in this "
                             "trainer (no --model-parallel, --zero1, --accum-steps)")
        if args.evaluate:
            raise ValueError("eval-only runs use the sequential path: pipeline "
                             "checkpoints hold the model's state, so pass "
                             "--evaluate --resume CKPT without --pipeline")
        return train_pipelined(args, model.to(device), chef, device, is_host0)

    mesh = make_mesh(model=args.model_parallel, device=device)
    if is_host0:
        print(f"==> mesh {mesh.shape} over {dist.get_world_size()} ranks")

    steps_per_epoch = args.steps_per_epoch or 256
    train_loader = val_loader = None
    if args.data and not args.synthetic:
        xs = np.load(os.path.join(args.data, "train_x.npy"), mmap_mode="r")
        ys = np.load(os.path.join(args.data, "train_y.npy"))
        steps_per_epoch = len(ys) // args.batch_size
        if xs.dtype == np.uint8:
            # the native loader: each data rank assembles its own rows of the
            # global batch from its shard of every epoch (the ranks of one
            # data coordinate, which differ on the model axis, the same)
            n_data = mesh.size("data")
            if args.batch_size % n_data:
                raise ValueError(f"-b {args.batch_size} does not split over "
                                 f"{n_data} data ranks")
            shard = dict(process_index=mesh.index("data"), process_count=n_data)
            train_loader = NativeDataLoader(
                xs, ys, args.batch_size // n_data, mean=IMAGENET_MEAN,
                std=IMAGENET_STD, pad=4, flip=True, seed=args.seed, **shard)
            steps_per_epoch = len(train_loader)
            vxs = np.load(os.path.join(args.data, "val_x.npy"), mmap_mode="r")
            vys = np.load(os.path.join(args.data, "val_y.npy"))
            val_loader = NativeDataLoader(
                vxs, vys, args.batch_size // n_data, shuffle=False,
                mean=IMAGENET_MEAN, std=IMAGENET_STD, **shard)

    # a recipe step may declare its optimizer, lr schedule and epochs; the
    # CLI's flags are the fallback
    if args.epochs is None:
        args.epochs = chef.epochs(args.step) or 90
    try:
        tx = chef.make_tx(args.step, steps_per_epoch)
        if is_host0:
            print(f"==> optimizer from recipe step {args.step}")
    except RecipeError:
        tx = make_optimizer(args, make_scheduler(args, steps_per_epoch))
    model.train()
    shard_model(model, mesh)
    optimizer = tx(model.parameters())
    shard_model(optimizer, mesh)
    if args.zero1:
        shard_optimizer_zero1(optimizer, mesh)
    train_step = make_train_step(accum_steps=args.accum_steps,
                                 compute_dtype=torch.bfloat16 if args.bf16 else None,
                                 remat=args.remat)
    eval_step = make_eval_step()

    start_epoch, best_acc1 = 0, 0.0
    if args.resume:
        payload = load_checkpoint(args.resume)
        skipped = restore_into(model, payload, strict=False)
        if skipped and is_host0:
            print(f"==> resume skipped {len(skipped)} mismatched entries")
        if payload.get("opt_state") is not None:
            # the moments and step counts; the counts carry the schedule's
            # position, so the lr continues where it stopped
            opt_skipped = restore_optimizer(optimizer, payload, strict=False)
            if opt_skipped and is_host0:
                print(f"==> resume skipped {len(opt_skipped)} optimizer entries")
        elif is_host0:
            print("==> checkpoint has no optimizer state; moments reset")
        meta = payload.get("metadata", {})
        start_epoch = int(meta.get("epoch", 0))
        best_acc1 = float(meta.get("best_acc1", 0.0))

    if args.evaluate:
        acc1, acc5 = validate(args, model, eval_step, mesh, val_loader)
        if is_host0:
            print(f" * Evaluate: Acc@1 {acc1:.3f} Acc@5 {acc5:.3f}")
        return acc1

    for epoch in range(start_epoch, args.epochs):
        model.train()
        losses = AverageMeter("Loss", ":.4e")
        top1 = AverageMeter("Acc@1", ":6.2f")
        batch_time = AverageMeter("Time", ":6.3f")
        progress = ProgressMeter(steps_per_epoch, [batch_time, losses, top1],
                                 prefix=f"Epoch[{epoch}]")
        if train_loader is not None:
            # per-epoch reshuffle; the batch assembly overlaps the steps
            train_loader.set_epoch(epoch)
            it = prefetch_to_device(iter(train_loader), mesh=mesh, host_shards=True)
        else:
            if args.data and not args.synthetic:
                batches = npy_batches(args.data, "train", args.batch_size, True,
                                      seed=args.seed + epoch)
            else:
                batches = synthetic_batches(args.batch_size, steps_per_epoch,
                                            seed=args.seed + epoch, size=args.image_size)
            it = prefetch_to_device(accumulation_order(
                batches, args.accum_steps, mesh.size("data")), mesh=mesh)
        step_s, start = 0.0, time.perf_counter()
        end = start
        for i, (xb, yb) in enumerate(it):
            t0 = time.perf_counter()
            metrics = train_step(model, optimizer, xb, yb)
            losses.update(float(metrics["loss"]), args.batch_size)  # waits for the step
            top1.update(float(metrics["top1"]) * 100.0, args.batch_size)
            now = time.perf_counter()
            step_s += now - t0
            batch_time.update(now - end)
            end = now
            if is_host0 and i % args.print_freq == 0:
                progress.display(i)
        seconds = time.perf_counter() - start
        if is_host0:
            print(f" * Epoch {epoch}: {steps_per_epoch} steps of {args.batch_size} "
                  f"images in {seconds:.3f} s ({steps_per_epoch * args.batch_size / seconds:.1f}"
                  f" images/s); {1e3 * step_s / steps_per_epoch:.2f} ms a step in "
                  "train_step")

        acc1, acc5 = validate(args, model, eval_step, mesh, val_loader)
        if is_host0:
            print(f" * Epoch {epoch}: Acc@1 {acc1:.3f} Acc@5 {acc5:.3f}")
        is_best = acc1 > best_acc1
        best_acc1 = max(acc1, best_acc1)
        # every rank: the shards are gathered whole, rank 0 writes
        save_checkpoint(args.out, model, opt_state=optimizer,
                        metadata={"epoch": epoch + 1, "arch": args.arch,
                                  "best_acc1": best_acc1, "step": args.step},
                        is_best=is_best)
    return best_acc1


if __name__ == "__main__":
    main()
