"""Serve the flagship binary ResNet-18 from a QAT checkpoint (counterpart of
``examples/serve.py``)::

    python -m bnn_tpu_torch.examples.serve --ckpt PATH      # restore + serve
    python -m bnn_tpu_torch.examples.serve                  # random weights
    python -m bnn_tpu_torch.examples.serve --continuous     # a request stream
    python -m bnn_tpu_torch.examples.serve --device cpu     # plain versions
    python -m bnn_tpu_torch.examples.serve --export PATH    # write a bundle
    python -m bnn_tpu_torch.examples.serve --load PATH      # serve a bundle
    torchrun --standalone --nproc-per-node 2 -m bnn_tpu_torch.examples.serve \\
        --data-parallel 2                                   # one rank a card

Inside ``Predictor``: deploy (packed / int8 binary layers, folded
epilogues), BN folds, the classifier head stored as int8
(``quantize_float_bits=8``), on the card the fused stem, stage and block
kernels, then bf16. ``--ckpt`` takes a directory written by
``bnn_tpu_torch.utils.save_checkpoint``. ``--continuous`` sends a Poisson
stream of single-image requests through ``ContinuousBatcher``, which joins
them into the predictor's batch. ``--export`` writes the frozen serving
bundle (``inference/export.py``: the traced program with its weights) and
exits; ``--load`` serves such a bundle without building a model, on the
device type it was exported on (pass the same ``--device``).

Multi-device serving, one process a device under ``torchrun`` (the world
comes from its environment): ``--data-parallel N`` splits each batch's rows
over N ranks with the weights replicated; ``--tensor-parallel N`` shards
every eligible deployed layer's packed weights by out-channel over N ranks
(each layer gathers its output; served unfused, since the block kernels
reduce over whole channels). The two compose (``--data-parallel 2
--tensor-parallel 2`` on 4 ranks), and with ``--ckpt``, ``--export`` (every
rank takes part, rank 0 writes a mesh bundle), ``--load`` (a mesh bundle on
a world of its size) and ``--continuous``. Every rank serves the same
requests, drawn from the same seed; only rank 0 prints. With
``--continuous`` rank 0 alone runs the batcher, whose batches depend on
timing: it broadcasts each batch it forms (its row count, then the rows),
the other ranks run the same forwards, and a row count of 0 stops them.
``--dist-backend`` is NCCL on CUDA and gloo on the CPU by default; two
ranks on one card take ``--device cuda:0 --dist-backend gloo`` (NCCL refuses
two ranks on one device).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

import bnn_tpu_torch as bt
from bnn_tpu_torch.inference import ContinuousBatcher, Predictor, load_serving
from bnn_tpu_torch.ops import (BasicInputBinarizer, BasicScaleBinarizer,
                               XNORWeightBinarizer)
from bnn_tpu_torch.parallel.mesh import cli_world, make_mesh, rank_device


def build_model(num_classes: int) -> torch.nn.Module:
    """The CIFAR-10 example's config: binary body, float first and last
    layers, torch-parity ternary sign (a zero_to_one sign after a ReLU would
    be a constant +1)."""
    model = bt.models.resnet18(num_classes=num_classes,
                               generator=torch.Generator().manual_seed(0))
    return bt.prepare_binary_model(
        model,
        bt.BConfig(activation_pre_process=BasicInputBinarizer,
                   activation_post_process=BasicScaleBinarizer,
                   weight_pre_process=XNORWeightBinarizer),
        ignore_layers_name=["_first_", "_last_"])


class LeadBatches:
    """The predictor as rank 0's ``ContinuousBatcher`` calls it in a world of
    several ranks: each batch's row count, then its rows, broadcast from
    rank 0 before the forward, which every rank runs (:func:`follow_batches`
    on the others). :meth:`stop` sends the row count 0."""

    def __init__(self, predictor):
        self.predictor = predictor
        self.batch_size = predictor.batch_size
        self.device = predictor.device

    def __call__(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        dist.broadcast(torch.tensor([x.shape[0]], device=self.device), 0)
        dist.broadcast(x.contiguous(), 0)
        return self.predictor(x)

    def stop(self) -> None:
        dist.broadcast(torch.tensor([0], device=self.device), 0)


def follow_batches(predictor, shape) -> None:
    """The other ranks' side of :class:`LeadBatches`: every batch rank 0
    forms, through the same forward, until the row count 0."""
    while True:
        n = torch.zeros(1, dtype=torch.int64, device=predictor.device)
        dist.broadcast(n, 0)
        if int(n) == 0:
            return
        x = torch.empty((int(n), *shape), dtype=torch.float32, device=predictor.device)
        dist.broadcast(x, 0)
        predictor(x)


def serve_stream(predictor, args, shape, say=print) -> None:
    """A Poisson stream of single-image requests through the continuous
    batcher, as many images as ``--requests`` full batches."""
    rng = np.random.default_rng(0)
    n = max(args.requests, 1) * args.batch_size
    predictor(np.zeros((1, *shape), np.float32)).cpu()  # first call, off the clock
    t0 = time.perf_counter()
    with ContinuousBatcher(predictor, max_delay_ms=5.0) as srv:
        futs = []
        for _ in range(n):
            futs.append(srv.submit(rng.standard_normal((1, *shape), np.float32)))
            time.sleep(float(rng.exponential(1.0 / args.stream_rps)))
        for f in futs:
            f.result(timeout=300)
        st = srv.stats()
    wall = time.perf_counter() - t0
    say(f"stream: {st.requests} requests ({st.rows} images) in {wall:.2f}s = "
        f"{st.rows / wall:.0f} img/s at {args.stream_rps:.0f} rps offered; "
        f"{st.batches} batches, occupancy {st.mean_occupancy * 100:.0f}%, "
        f"latency p50 {st.latency_percentile(50):.1f} ms / "
        f"p99 {st.latency_percentile(99):.1f} ms")


def serve_loop(predictor, args, shape=None, say=print) -> None:
    shape = tuple(shape) if shape is not None else (3, args.size, args.size)
    if args.continuous:
        if not dist.is_initialized() or dist.get_world_size() == 1:
            serve_stream(predictor, args, shape, say)
        elif dist.get_rank() == 0:
            lead = LeadBatches(predictor)
            try:
                serve_stream(lead, args, shape, say)
            finally:
                lead.stop()
        else:
            follow_batches(predictor, shape)
        return
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        n = int(rng.integers(1, args.batch_size + 1))  # ragged request sizes
        x = rng.standard_normal((n, *shape), np.float32)
        t0 = time.perf_counter()
        logits = predictor(x)
        top1 = logits.argmax(-1).cpu()  # waits for the card
        say(f"request {i}: {n} images -> top-1 {top1.tolist()} "
            f"({(time.perf_counter() - t0) * 1e3:.1f} ms incl. host)")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=None, help="QAT checkpoint directory")
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--export", default=None, metavar="PATH",
                    help="write a serving bundle (program + weights) and exit")
    ap.add_argument("--load", default=None, metavar="PATH",
                    help="serve from an exported bundle instead of building "
                         "a model")
    ap.add_argument("--data-parallel", type=int, default=1,
                    help="split each batch's rows over N ranks")
    ap.add_argument("--tensor-parallel", type=int, default=1,
                    help="shard packed weights by out-channel over N ranks")
    ap.add_argument("--continuous", action="store_true",
                    help="serve a single-image request stream through the "
                         "continuous batcher instead of batched requests")
    ap.add_argument("--stream-rps", type=float, default=200.0,
                    help="offered load for --continuous (requests/s, "
                         "Poisson arrivals)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels; cuda:LOCAL_RANK under torchrun), "
                         "'cuda:0' (every rank on one card) or 'cpu' (their "
                         "plain versions)")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="torch.distributed backend (default: nccl on CUDA, "
                         "gloo on the CPU)")
    return ap.parse_args(argv)


def main(argv=None):
    """The CLI; returns the predictor (or loaded bundle) it served or
    exported."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the server runs on CUDA by default and no CUDA device "
                           "is available; pass --device cpu")
    # a world for mesh flags, and under torchrun (a mesh bundle's --load)
    if (args.data_parallel * args.tensor_parallel > 1 or dist.is_initialized()
            or "WORLD_SIZE" in os.environ):
        device = rank_device(device)
        with cli_world(device, args.dist_backend) as (rank, _):
            return serve(args, device, print if rank == 0 else (lambda *a, **k: None))
    return serve(args, device, print)


def serve(args, device: torch.device, say):
    if args.load:
        predictor = load_serving(args.load, device=device)
        mesh = "" if predictor.mesh is None else f", mesh {predictor.mesh.shape}"
        say(f"loaded bundle {args.load}: platforms {list(predictor.platforms)}, "
            f"batch {predictor.batch_size}{mesh}, state "
            f"{predictor.state_bytes() / 1e6:.2f} MB")
        args.batch_size = predictor.batch_size
        serve_loop(predictor, args, shape=predictor.input_shape, say=say)
        return predictor
    on_card = device.type == "cuda"
    common = dict(batch_size=args.batch_size, use_pallas=on_card, fuse=on_card,
                  quantize_float_bits=8, device=device)
    if args.data_parallel * args.tensor_parallel > 1:
        common["mesh"] = make_mesh(data=args.data_parallel, model=args.tensor_parallel,
                                   device=device)
        if args.tensor_parallel > 1:
            # the block kernels reduce over whole channels: served unfused
            common.update(tensor_parallel=True, fuse=False)
    if args.ckpt:
        predictor = Predictor.from_checkpoint(
            args.ckpt, lambda: build_model(args.num_classes), **common)
    else:
        predictor = Predictor(build_model(args.num_classes), **common)
    mode = (f"CUDA kernels on {torch.cuda.get_device_name(device)}" if on_card
            else "plain PyTorch versions on the CPU")
    if predictor.mesh is not None:
        mode += f", mesh {predictor.mesh.shape} over {dist.get_world_size()} ranks"
    if predictor.tensor_parallel:
        mode += (f", {len(predictor.tp_layers)}/{predictor.tp_total} deployed layers "
                 f"tensor-sharded over {args.tensor_parallel} ranks")
    say(f"serving state: {predictor.state_bytes() / 1e6:.2f} MB, "
        f"batch {args.batch_size}, {mode}")
    if args.export:
        predictor.export(args.export, input_shape=(3, args.size, args.size))
        say(f"exported serving bundle to {args.export} "
            f"(serve it with --load {args.export})")
        return predictor
    serve_loop(predictor, args, say=say)
    return predictor


if __name__ == "__main__":
    main()
