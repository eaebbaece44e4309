"""Ranks of the port's distributed tests (``tests/test_torch_parallel.py``,
``test_torch_pipeline.py``, ``test_torch_tp_serving.py``,
``test_torch_mesh_bundle.py``, and the serve CLI and ImageNet trainer of
``test_torch_serve_parallel.py`` and ``test_torch_imagenet_example.py``),
beside the JAX package's ``tests/distributed_worker.py``.

A test's module-scoped fixture writes the inputs (tensors made from numpy
with a seed, JAX weights as ``{dotted JAX path: tensor}``) to a directory,
starts one process per rank with :func:`start_world`, computes its JAX
references meanwhile, and reads each rank's results back. A rank imports
torch and the port only, never JAX:

    python tests/torch_distributed_worker.py <suite> <rank> <world> <dir>

Each rank joins a gloo world through a ``file://`` store in ``<dir>`` (no
port to race for under xdist), with a 60 s timeout on the rendezvous and
on every collective, runs every case of its suite in order on one thread,
and writes ``rank<r>.pt`` (a dict of results) or ``rank<r>.err`` (the
traceback). The parent waits with a deadline, then kills what is left. Two
test files read one world through :func:`shared_world`: its first caller in
the run starts it, the others wait for its results.
"""
from __future__ import annotations

import copy
import datetime
import math
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the parent's side ----------------------------------------------------

class World:
    """The processes of one world and where their results land."""

    def __init__(self, suite: str, world: int, workdir, inputs: dict):
        self.workdir = str(workdir)
        self.world = world
        os.makedirs(self.workdir, exist_ok=True)
        torch.save(inputs, os.path.join(self.workdir, "inputs.pt"))
        env = {k: v for k, v in os.environ.items()
               if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "MASTER_ADDR",
                            "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
        env["OMP_NUM_THREADS"] = "1"
        self.logs = [open(os.path.join(self.workdir, f"rank{r}.log"), "w")
                     for r in range(world)]
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), suite, str(r), str(world),
             self.workdir], stdout=self.logs[r], stderr=subprocess.STDOUT, env=env)
            for r in range(world)]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        """Kill the ranks if the parent's side failed before reading them."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in self.logs:
            f.close()

    def results(self, timeout: float = 300.0) -> list:
        """Each rank's result dict, in rank order; raises with the ranks'
        errors or on the deadline (the ranks are killed)."""
        deadline = time.monotonic() + timeout
        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
            for p in self.procs:
                p.wait()
            raise RuntimeError(f"ranks still running after {timeout} s:\n{self._errors()}")
        finally:
            for f in self.logs:
                f.close()
        if any(p.returncode for p in self.procs):
            raise RuntimeError(f"ranks failed:\n{self._errors()}")
        return [torch.load(os.path.join(self.workdir, f"rank{r}.pt"), weights_only=True)
                for r in range(self.world)]

    def _errors(self) -> str:
        out = []
        for r in range(self.world):
            for name in (f"rank{r}.err", f"rank{r}.log"):
                path = os.path.join(self.workdir, name)
                if os.path.exists(path):
                    out.append(f"--- {name}\n{open(path).read()[-3000:]}")
        return "\n".join(out)


def start_world(suite: str, world: int, workdir, inputs: dict) -> World:
    return World(suite, world, workdir, inputs)


def shared_world(suite: str, world: int, tmp_path_factory, make_inputs,
                 timeout: float = 600.0) -> list:
    """The ranks' results of one world that several test files read: the
    first fixture to ask (on any xdist worker of the run) makes its inputs
    with ``make_inputs(dir)``, starts it and keeps the results in the run's
    shared temporary directory; the others wait for them there."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # the run's directory, above each worker's own
    d = os.path.join(str(root), f"shared-{suite}")
    done, failed = os.path.join(d, "results.pt"), os.path.join(d, "failed")
    try:
        os.makedirs(d)  # exactly one fixture makes it
    except FileExistsError:
        deadline = time.monotonic() + timeout
        while not os.path.exists(done):
            if os.path.exists(failed):
                raise RuntimeError(f"the shared {suite} world failed:\n"
                                   + open(failed).read())
            if time.monotonic() > deadline:
                raise RuntimeError(f"no results of the shared {suite} world after "
                                   f"{timeout} s")
            time.sleep(0.5)
        return torch.load(done, weights_only=True)
    try:
        with start_world(suite, world, os.path.join(d, "world"), make_inputs(d)) as w:
            results = w.results(timeout)
        torch.save(results, done + ".tmp")
        os.replace(done + ".tmp", done)
        return results
    except BaseException:
        with open(failed, "w") as f:
            f.write(traceback.format_exc())
        raise


# -- shared by the ranks --------------------------------------------------

def _port():
    sys.path.insert(0, ROOT)
    import bnn_tpu_torch as bt
    from bnn_tpu_torch.ops import binarizers as tops

    bc = bt.BConfig(tops.BasicInputBinarizer, tops.BasicScaleBinarizer,
                    tops.XNORWeightBinarizer)
    return bt, bc


def make_model(bt, bc, flat=None, dtype=torch.float32):
    """tests/test_parallel.py's make_model in the port, with JAX's weights."""
    nn = torch.nn
    net = nn.Sequential(
        nn.Conv2d(3, 32, 3, padding=1), bt.nn.BatchNorm2d(32), nn.PReLU(32),
        nn.Conv2d(32, 64, 3, stride=2, padding=1), bt.nn.BatchNorm2d(64), nn.PReLU(64),
        nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(64, 10))
    net = bt.prepare_binary_model(net, bconfig=bc, ignore_layers_name=["_first_"])
    if flat is not None:
        bt.utils.load_jax_state(net, {k: v.numpy() for k, v in flat.items()})
    return net.to(dtype)


def _specs(placement_or_specs) -> dict:
    specs = getattr(placement_or_specs, "specs", placement_or_specs)
    return {k: [list(e) if isinstance(e, tuple) else e for e in s]
            for k, s in specs.items()}


def _grads(bt, model, mesh) -> dict:
    from bnn_tpu_torch.parallel.mesh import gather_tensor, placement_of

    placement = placement_of(model)
    out = {}
    for name, p in model.named_parameters():
        g = p.grad.detach()
        spec = placement.specs.get(name) if placement else None
        out[name] = gather_tensor(g, spec, mesh) if spec and spec.names() else g.clone()
    return out


def _params(bt, model) -> dict:
    full = bt.utils.gather_replicated(model)
    names = {n for n, _ in model.named_parameters()}
    return {k: v.detach().clone() for k, v in full.items() if k in names}


# -- suite: parallel (tests/test_torch_parallel.py) ---------------------------

def suite_parallel(rank, world, inp):
    bt, bc = _port()
    P = bt.parallel
    res = {}

    # mesh shapes and guards
    res["shapes"] = [P.make_mesh(device="cpu").shape, P.make_mesh(model=2, device="cpu").shape,
                     P.make_mesh(data=2, model=2, device="cpu").shape]
    errs = []
    for kw in (dict(data=3), dict(model=3), dict(data=2, model=4)):
        try:
            P.make_mesh(device="cpu", **kw)
            errs.append("")
        except ValueError as e:
            errs.append(str(e))
    res["mesh_errors"] = errs
    dp = P.make_mesh(device="cpu")
    tp = P.make_mesh(data=2, model=2, device="cpu")

    # batch rows
    rows = torch.arange(16)
    res["rows_dp"] = P.shard_batch(rows, dp)
    res["rows_tp"] = P.shard_batch(rows, tp)
    res["host_rows"] = P.shard_host_batch(rows[rank::world], dp)
    res["rows_spec"] = [list(P.spec_of(res["rows_dp"])), list(P.spec_of(res["rows_tp"]))]

    # the rules on the zoo's shapes: QAT and deployed ResNet-18 on 2x2
    for tag, min_size in (("1024", 1024), ("64", 64)):
        qat = bt.prepare_binary_model(bt.models.resnet18(num_classes=16), bc,
                                      ignore_layers_name=["_first_", "_last_"])
        dep = bt.inference.deploy(copy.deepcopy(qat).eval())
        res[f"rules_qat_{tag}"] = _specs({k: P.spec_of(v) for k, v in
                                          P.shard_state(qat, tp, min_size=min_size).items()})
        res[f"rules_dep_{tag}"] = _specs({k: P.spec_of(v) for k, v in
                                          P.shard_state(dep, tp, min_size=min_size).items()})
    # a custom rule in the port's layout: conv and linear weights split on
    # their out-channels (dim 0) over the data axis
    custom = ((r"\bweight$", lambda m, t: P.Spec("data") if t.ndim > 1 else None),)
    res["rules_custom"] = _specs({k: P.spec_of(v) for k, v in P.shard_state(
        make_model(bt, bc), P.make_mesh(device="cpu"), rules=custom).items()})

    x, y = inp["x"], inp["y"]
    step = P.make_train_step()

    # the data-parallel step (SGD 0.1, one step), BatchNorm over the batch
    m = make_model(bt, bc, inp["flat"])
    m.train()
    opt = torch.optim.SGD(m.parameters(), 0.1)
    P.shard_model(m, dp)
    P.shard_model(opt, dp)
    xb, yb = P.shard_batch((x, y), dp)
    res["dp_loss"] = step(m, opt, xb, yb)["loss"]
    res["dp_params"] = _params(bt, m)
    res["dp_state"] = bt.utils.gather_replicated(m)

    # the tensor-parallel forward (eval, f32) on 2x2, default and small gates
    for tag, min_size in (("1024", 1024), ("64", 64)):
        m = make_model(bt, bc, inp["flat"])
        m.eval()
        P.shard_model(m, tp, min_size=min_size)
        with torch.no_grad():
            res[f"tp_fwd_{tag}"] = m(x)
        res[f"tp_specs_{tag}"] = _specs(m._bnn_placement)
    # ... and the train-mode gradient in float64, over the data axis too
    m = make_model(bt, bc, inp["flat"], torch.float64)
    m.train()
    P.shard_model(m, tp, min_size=64)
    opt = torch.optim.SGD(m.parameters(), 0.1)
    xb, yb = P.shard_batch((x.double(), y), tp)
    res["tp_loss"] = step(m, opt, xb, yb)["loss"]
    res["tp_grads"] = _grads(bt, m, tp)

    # XNOR's alpha under the out-channel sharding
    w = inp["xnor_w"]
    local = P.shard_state(torch.nn.Conv2d(32, 64, 3, bias=False).requires_grad_(False),
                          tp, min_size=1)["weight"]
    binar = bt.ops.XNORWeightBinarizer()
    full = binar(w)
    i = tp.index("model")
    res["xnor_local"] = binar(w[i * 32:(i + 1) * 32])
    res["xnor_slice"] = full[i * 32:(i + 1) * 32]
    res["xnor_spec"] = list(P.spec_of(local))

    # ZeRO-1: the dimension each parameter is cut on, then two AdamW steps
    # against the unsharded step (float64: a noise-level gradient, as an
    # output scale's under a train-mode BN, turns into a whole Adam step)
    def adamw(model):
        return torch.optim.AdamW(model.parameters(), 1e-3, weight_decay=1e-4)

    for tag, mesh, min_size in (("dp", dp, 64), ("tp", tp, 64)):
        m = make_model(bt, bc, inp["flat"], torch.float64)
        m.train()
        opt = adamw(m)
        P.shard_model(m, mesh, min_size=min_size if tag == "tp" else 1024)
        P.shard_model(opt, mesh)
        P.shard_optimizer_zero1(opt, mesh, min_size=min_size)
        names = {id(p): n for n, p in m.named_parameters()}
        res[f"zero1_dims_{tag}"] = {names[id(p)]: d for p, _, d, _, _ in opt._bnn_zero1.entries}
        xb, yb = P.shard_batch((x.double(), y), mesh)
        losses = [float(step(m, opt, xb, yb)["loss"]) for _ in range(2)]
        res[f"zero1_losses_{tag}"] = losses
        res[f"zero1_params_{tag}"] = _params(bt, m)
        res[f"zero1_moment_shapes_{tag}"] = {
            names[id(p)]: list(opt.state[p]["exp_avg"].shape)
            for p, _, _, _, _ in opt._bnn_zero1.entries}
    ref = make_model(bt, bc, inp["flat"], torch.float64)
    ref.train()
    ropt = adamw(ref)
    res["zero1_ref_losses"] = [float(step(ref, ropt, x.double(), y)["loss"]) for _ in range(2)]
    res["zero1_ref_params"] = {k: v.detach().clone() for k, v in ref.named_parameters()}

    # a ZeRO-1 checkpoint restores and continues (test_parallel.py:428)
    ckpt = os.path.join(sys.argv[4], "zero1_ckpt")
    sched = lambda t: 5e-2 * 0.5 * (1 + math.cos(math.pi * min(t, 24) / 24))  # noqa: E731

    def build():
        model = make_model(bt, bc, inp["flat"])
        model.train()
        o = bt.engine.ScheduledAdamW(model.parameters(), sched)
        P.shard_model(model, dp)
        P.shard_model(o, dp)
        P.shard_optimizer_zero1(o, dp, min_size=64)
        return model, o

    x32, y32 = inp["x32"], inp["y32"]

    def run(model, o, lo, hi):
        out = []
        for k in range(lo, hi):
            idx = torch.arange(16) + (k % 2) * 16
            xb, yb = P.shard_batch((x32[idx], y32[idx]), dp)
            out.append(float(step(model, o, xb, yb)["loss"]))
        return out

    ma, oa = build()
    res["ckpt_full"] = run(ma, oa, 0, 12)
    mb, ob = build()
    run(mb, ob, 0, 6)
    # every rank; rank 0 writes, and each returns once the file is in place
    bt.utils.save_checkpoint(ckpt, mb, opt_state=ob)
    from bnn_tpu_torch.utils.checkpoint import PAYLOAD

    res["ckpt_in_place"] = os.path.exists(os.path.join(ckpt, PAYLOAD))
    try:  # rank 0 cannot write under a file: every rank raises
        bt.utils.save_checkpoint(os.path.join(ckpt, PAYLOAD, "under_a_file"), mb)
        res["ckpt_failed_write"] = ""
    except (OSError, RuntimeError) as e:
        res["ckpt_failed_write"] = type(e).__name__
    mc, oc = build()
    payload = bt.utils.load_checkpoint(ckpt)
    res["ckpt_saved_shapes"] = {k: list(v["exp_avg"].shape)
                                for k, v in payload["opt_state"]["state"].items()}
    bt.utils.restore_into(mc, payload)
    res["ckpt_skipped"] = bt.utils.restore_optimizer(oc, payload)
    P.shard_model(mc, dp)
    P.shard_model(oc, dp)
    P.shard_optimizer_zero1(oc, dp, min_size=64)
    res["ckpt_resumed"] = run(mc, oc, 6, 12)

    # the loader's host shards through prefetch_to_device(mesh=, host_shards=True)
    loader = bt.data.NativeDataLoader(np.arange(32, dtype=np.uint8).reshape(32, 1, 1, 1)
                                      .repeat(8, 1).repeat(8, 2).repeat(3, 3),
                                      np.arange(32), batch_size=4, seed=0, pad=0,
                                      flip=False, mean=(0.0,), std=(1 / 255,))
    loader.set_epoch(3)
    res["loader_indices"] = torch.as_tensor(loader._epoch_indices())
    got = []
    for xb, yb in bt.data.prefetch_to_device(iter(loader), mesh=dp, host_shards=True):
        got.append(yb)
        res["loader_spec"] = list(P.spec_of(yb))
    res["loader_labels"] = torch.cat(got)
    batches = [(torch.arange(8) * 10 + k, torch.arange(8)) for k in range(2)]
    res["prefetch_rows"] = [b[0] for b in bt.data.prefetch_to_device(iter(batches), mesh=dp)]
    return res


# -- suite: pipeline (tests/test_torch_pipeline.py) ---------------------------

def suite_pipeline(rank, world, inp):
    bt, bc = _port()
    P = bt.parallel
    res = {}
    x = inp["lin_x"]

    # the homogeneous pipeline: 4 binary Linear(16, 16) stages
    def lin_stages(n, flats):
        out = []
        for f in flats[:n]:
            s = bt.layers.Linear(16, 16, bconfig=bc)
            bt.utils.load_jax_state(s, {k: v.numpy() for k, v in f.items()})
            out.append(s)
        return out

    for pipe, data in ((4, 1), (2, 2)):
        mesh = P.make_pipeline_mesh(pipe, data, device="cpu")
        stages = lin_stages(pipe, inp["lin_flats"])
        stacked = P.shard_stacked_state(P.stack_stage_states(stages), mesh)
        stacked = {k: v.requires_grad_() for k, v in stacked.items()}
        fn = P.make_stage_fn(stages[0])
        n_micro = 4 // data
        y = P.pipeline_apply(fn, stacked, x, mesh=mesh, n_microbatches=n_micro)
        (y ** 2).sum().backward()
        res[f"lin_y_{pipe}x{data}"] = y.detach()
        res[f"lin_grads_{pipe}x{data}"] = {k: v.grad[0] for k, v in stacked.items()}
        res[f"lin_stage_{pipe}x{data}"] = mesh.index("pipe")
        # the same whole stacked state on every rank
        whole = P.stack_stage_states(stages)
        res[f"lin_y_whole_{pipe}x{data}"] = P.pipeline_apply(
            fn, whole, x, mesh=mesh, n_microbatches=n_micro).detach()
    mesh = P.make_pipeline_mesh(4, 1, device="cpu")
    eight = P.stack_stage_states(lin_stages(4, inp["lin_flats"]) * 2)
    fn = P.make_stage_fn(bt.layers.Linear(16, 16, bconfig=bc))
    two = P.stack_stage_states(lin_stages(2, inp["lin_flats"]))
    mesh22 = P.make_pipeline_mesh(2, 2, device="cpu")
    errs = []
    for call in (lambda: P.pipeline_apply(fn, eight, x, mesh=mesh, n_microbatches=4),
                 lambda: P.pipeline_apply(fn, two, x, mesh=mesh22, n_microbatches=16)):
        try:
            call()
            errs.append("")
        except ValueError as e:
            errs.append(str(e))
    res["lin_errors"] = errs

    # the heterogeneous pipeline: the ResNet-like and float stages over
    # pipe=4; the BatchNorm stages over pipe=4 and, merged in pairs, over
    # pipe=2 x data=2
    for name, pipe, data in (("resnet", 4, 1), ("float", 4, 1), ("bn", 4, 1), ("bn", 2, 2)):
        stages = _hetero_stages(bt, bc, name, inp[f"h_{name}_flats"])
        sts = stages if pipe == 4 else _merge_pairs(stages)
        if name == "bn":  # the stages' mode is the pipeline's from here on
            for st in sts:
                st.train()
        mesh = P.make_pipeline_mesh(pipe, data, device="cpu")
        key = f"h_{name}_{pipe}x{data}"
        xs = inp[f"h_{name}_x"]
        pipe_obj = P.HeteroPipeline(sts, tuple(xs.shape[1:]), mesh)
        res[key + "_io"] = [list(map(list, io)) for io in pipe_obj.io_shapes]
        if name == "bn":
            y, new = pipe_obj.apply(pipe_obj.flat_params, xs,
                                    n_microbatches=4 // data, return_state=True)
            whole = bt.utils.gather_replicated(new)
            res[key + "_states"] = pipe_obj.unflatten_stage_states(whole)
            res[key + "_old"] = pipe_obj.unflatten_stage_states(
                bt.utils.gather_replicated(pipe_obj.flat_params))
            continue
        flat = pipe_obj.flat_params.detach().clone().requires_grad_()
        logits = pipe_obj.apply(flat, xs, n_microbatches=2)
        loss = torch.nn.functional.cross_entropy(logits, inp[f"h_{name}_y"])
        loss.backward()
        s = mesh.index("pipe")
        res[key + "_loss"] = loss.detach()
        res[key + "_grads"] = pipe_obj._unflatten(flat.grad[0], s)
        res[key + "_stage"] = s
        res[key + "_y"] = logits.detach()
        res[key + "_y4"] = pipe_obj.apply(pipe_obj.flat_params, xs, n_microbatches=4).detach()
        if name == "resnet":
            # the state round trip, and the guards
            whole = bt.utils.gather_replicated(pipe_obj.flat_params)
            mods = pipe_obj.stage_modules(whole)
            h = xs
            with torch.no_grad():
                for mod in mods:
                    h = mod(h)
            res[key + "_rebuilt"] = h
            res[key + "_per_rank_row"] = list(pipe_obj.flat_params.shape)
            errs = []
            for call in (lambda: pipe_obj.apply(pipe_obj.flat_params, xs[:, :, :12, :12],
                                                n_microbatches=4),
                         lambda: P.HeteroPipeline(sts[:3], tuple(xs.shape[1:]), mesh)):
                try:
                    call()
                    errs.append("")
                except ValueError as e:
                    errs.append(str(e))
            res[key + "_errors"] = errs
            # Adam on the flat row: the loss falls, padding lanes stay 0
            flat = pipe_obj.flat_params.detach().clone().requires_grad_()
            opt = torch.optim.Adam([flat], 5e-3)
            losses = []
            for _ in range(13):
                opt.zero_grad()
                loss = torch.nn.functional.cross_entropy(
                    pipe_obj.apply(flat, inp["h_resnet_x_train"], n_microbatches=2),
                    inp[f"h_{name}_y"])
                loss.backward()
                opt.step()
                losses.append(float(loss))
            res[key + "_train_losses"] = losses
            n = sum(math.prod(sh) for sh in pipe_obj._shapes[s])
            res[key + "_pad"] = flat.detach()[0, n:]
    return res


def _merge_pairs(stages):
    return [torch.nn.Sequential(*stages[i:i + 2]) for i in range(0, len(stages), 2)]


def _hetero_stages(bt, bc, name, flats):
    """tests/test_hetero_pipeline.py's stages in the port, with JAX's weights."""
    nn = torch.nn
    if name == "resnet":
        from bnn_tpu_torch.models.layers import BasicBlock

        def shortcut(cin, cout):
            return nn.Sequential(nn.AvgPool2d(2, 2, ceil_mode=True, count_include_pad=False),
                                 nn.Conv2d(cin, cout, 1, bias=False), bt.nn.BatchNorm2d(cout))

        stages = [nn.Sequential(nn.Conv2d(3, 8, 3, padding=1, bias=False),
                                bt.nn.BatchNorm2d(8), nn.ReLU()),
                  BasicBlock(8, 8),
                  BasicBlock(8, 16, stride=2, downsample=shortcut(8, 16)),
                  nn.Sequential(BasicBlock(16, 32, stride=2, downsample=shortcut(16, 32)),
                                nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(32, 5))]
        stages = [bt.prepare_binary_model(s, bc, ignore_layers_name=["_first_", "_last_"])
                  for s in stages]
    elif name == "float":
        stages = [nn.Sequential(nn.Conv2d(3, 8, 3, padding=1), nn.Tanh()),
                  nn.Sequential(nn.Conv2d(8, 16, 3, stride=2, padding=1), nn.Tanh()),
                  nn.Sequential(nn.Conv2d(16, 32, 3, stride=2, padding=1), nn.Tanh()),
                  nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(32, 5))]
    else:
        stages = [nn.Sequential(nn.Conv2d(3, 8, 3, padding=1), bt.nn.BatchNorm2d(8), nn.ReLU()),
                  nn.Sequential(nn.Conv2d(8, 16, 3, stride=2, padding=1),
                                bt.nn.BatchNorm2d(16), nn.ReLU()),
                  nn.Sequential(nn.Conv2d(16, 16, 3, padding=1), bt.nn.BatchNorm2d(16), nn.ReLU()),
                  nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(16, 4))]
    for s, f in zip(stages, flats):
        bt.utils.load_jax_state(s, {k: v.numpy() for k, v in f.items()})
        s.eval()
    return stages


# -- suite: tp_serving (tests/test_torch_tp_serving.py) -----------------------

def bin_model(bt, bc, flat):
    """tests/test_tp_serving.py's _bin_model in the port."""
    nn = torch.nn
    net = nn.Sequential(
        nn.Conv2d(3, 32, 3, padding=1), bt.nn.BatchNorm2d(32), nn.PReLU(32),
        nn.Conv2d(32, 64, 3, stride=2, padding=1), bt.nn.BatchNorm2d(64), nn.PReLU(64),
        nn.Conv2d(64, 64, 1), nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(64, 16))
    net = bt.prepare_binary_model(net, bconfig=bc, ignore_layers_name=["_first_"])
    bt.utils.load_jax_state(net, {k: v.numpy() for k, v in flat.items()})
    return net


def suite_tp_serving(rank, world, inp):
    bt, bc = _port()
    P = bt.parallel
    from bnn_tpu_torch.inference import (Predictor, ici_bytes_per_layer,
                                         pack_chain_weights, packed_tp_chain,
                                         reference_chain, tag_tensor_parallel)

    res = {}
    common = dict(batch_size=8, dtype=None, fuse=False, space_to_depth=False)
    x = inp["x"]
    meshes = {"dp": P.make_mesh(device="cpu")}
    if world == 4:
        meshes["2x2"] = P.make_mesh(data=2, model=2, device="cpu")
    meshes["model"] = P.Mesh({"model": world}, device="cpu")
    for tag, mesh in meshes.items():
        if mesh.size("data") > 1:
            res[f"dp_{tag}"] = Predictor(bin_model(bt, bc, inp["flat"]), mesh=mesh, **common)(x)
        if mesh.size("model") > 1:
            tp = Predictor(bin_model(bt, bc, inp["flat"]), mesh=mesh,
                           tensor_parallel=True, **common)
            res[f"tp_{tag}"] = tp(x)
            res[f"tp_layers_{tag}"] = tp.tp_layers
            res[f"tp_bytes_{tag}"] = [tp.state_bytes(), tp.local_state_bytes()]
            sd = tp.model.state_dict()
            res[f"tp_packed_{tag}"] = {name: [sd[f"{name}.w_packed"].numel()
                                              * sd[f"{name}.w_packed"].element_size(),
                                              list(sd[f"{name}.w_packed"].shape)]
                                       for name in tp.tp_layers}
    rep = Predictor(bin_model(bt, bc, inp["flat"]), device="cpu", **common)
    res["replicated"] = rep(x)
    res["replicated_bytes"] = rep.state_bytes()
    sd = rep.model.state_dict()
    res["replicated_packed"] = {k[:-len(".w_packed")]: v.numel() * v.element_size()
                                for k, v in sd.items() if k.endswith(".w_packed")}

    # the untagged, non-dividing layers
    nn = torch.nn
    odd = bt.prepare_binary_model(
        nn.Sequential(nn.Conv2d(3, 6, 3, padding=1), nn.AdaptiveAvgPool2d(1),
                      nn.Flatten(), nn.Linear(6, 10)), bconfig=bc)
    res["untagged"] = tag_tensor_parallel(bt.inference.deploy(odd), meshes["model"])

    # ResNet-18 under tensor parallelism against the replicated unfused one
    if world == 4:
        def r18():
            m = bt.prepare_binary_model(bt.models.resnet18(num_classes=16), bc,
                                        ignore_layers_name=["_first_", "_last_"])
            bt.utils.load_jax_state(m, {k: v.numpy() for k, v in inp["r18_flat"].items()})
            return m
        mesh = meshes["2x2"]
        tp = Predictor(r18(), mesh=mesh, tensor_parallel=True, **common)
        res["r18_tp"] = tp(inp["r18_x"])
        res["r18_layers"] = len(tp.tp_layers)
        res["r18_ref"] = Predictor(r18(), device="cpu", **common)(inp["r18_x"])

    # the guards
    errs = []
    for kw in (dict(mesh=meshes["dp"], tensor_parallel=True),
               dict(mesh=meshes["model"], tensor_parallel=True, fuse=True),
               dict(mesh=meshes["dp"], batch_size=3 if world == 2 else 6)):
        try:
            Predictor(bin_model(bt, bc, inp["flat"]), **{**common, **kw})
            errs.append("")
        except ValueError as e:
            errs.append(str(e))
    res["predictor_errors"] = errs

    # the packed chain, bit for bit, and what it hands its collectives
    sizes = inp["chain_sizes"].tolist()
    layers = pack_chain_weights([w.numpy() for w in inp["chain_w"]],
                                [s.numpy() for s in inp["chain_s"]],
                                [a.numpy() for a in inp["chain_a"]])
    for tag, mesh in (("model", meshes["model"]), ("2x2", meshes.get("2x2"))):
        if mesh is None:
            continue
        fn = packed_tp_chain(layers, mesh)
        res[f"chain_{tag}"] = fn(inp["chain_x"])
        res[f"chain_transport_{tag}"] = [
            {k: (str(v) if k == "dtype" else v) for k, v in r.items()}
            for r in fn.transport]
        m, p = inp["chain_x"].shape[0], mesh.size("model")
        res[f"chain_ici_{tag}"] = [ici_bytes_per_layer(m, k, p)["packed_ring"]
                                   for k in sizes[:-1]]
    res["chain_ref"] = reference_chain(layers)(inp["chain_x"])
    errs = []
    bad = pack_chain_weights([np.sign(np.random.default_rng(0).standard_normal((96, 96)))
                              .astype(np.float32)])
    for call in (lambda: packed_tp_chain(bad, meshes["model"]),
                 lambda: ici_bytes_per_layer(16, 100, world)):
        try:
            call()
            errs.append("")
        except ValueError as e:
            errs.append(str(e))
    res["chain_errors"] = errs
    return res


# -- suite: mesh_bundle (tests/test_torch_mesh_bundle.py) ---------------------

def suite_mesh_bundle(rank, world, inp):
    """Mesh bundles: each meshed Predictor exported, loaded as a fresh
    ExportedServer in this world, both called on the same rows; the
    exportable gather against collectives.gather."""
    bt, bc = _port()
    P = bt.parallel
    from torch._subclasses.fake_tensor import FakeTensorMode

    from bnn_tpu_torch.inference import Predictor, load_serving
    from bnn_tpu_torch.parallel.collectives import gather, mesh_gather

    res = {}
    common = dict(batch_size=4, dtype=None, fuse=False, space_to_depth=False)
    x = inp["x"]
    meshes = {"dp4": (P.make_mesh(device="cpu"), False),
              "2x2": (P.make_mesh(data=2, model=2, device="cpu"), True),
              "model4": (P.make_mesh(data=1, model=4, device="cpu"), True)}
    for tag, (mesh, tp) in meshes.items():
        pred = Predictor(bin_model(bt, bc, inp["flat"]), mesh=mesh, tensor_parallel=tp,
                         **common)
        live, live6 = pred(x), pred(x[:6])
        path = os.path.join(inp["dir"], tag)
        pred.export(path, (3, 8, 8))
        res[f"{tag}_live_after"] = pred(x)
        server = load_serving(path)
        res[f"{tag}_live"], res[f"{tag}_live6"] = live, live6
        res[f"{tag}_loaded"], res[f"{tag}_loaded6"] = server(x), server(x[:6])
        res[f"{tag}_mesh"] = [list(server.mesh.axis_names),
                              [server.mesh.size(a) for a in server.mesh.axis_names]]
        res[f"{tag}_gathers"] = sum(
            n.target is torch.ops.bnn_tpu_torch.mesh_gather.default
            for n in server.program.graph.nodes)
        res[f"{tag}_tp_layers"] = len(pred.tp_layers) if tp else 0
        res[f"{tag}_bytes"] = [server.state_bytes(), pred.local_state_bytes(),
                               pred.state_bytes()]
        if tag == "dp4":
            try:
                pred.export(os.path.join(inp["dir"], "refused"), (3, 8, 8),
                            platforms=["cpu"])
                res["platforms_error"] = ""
            except ValueError as e:
                res["platforms_error"] = str(e)

    # the exportable gather against the eager one, on the 2x2 mesh's axes
    mesh = meshes["2x2"][0]
    t = torch.arange(24.0).reshape(2, 3, 4) + 100 * rank
    res["gather_equal"] = [torch.equal(mesh_gather(t, mesh, a, dim), gather(t, mesh.group(a), dim))
                           for a in ("data", "model") for dim in (0, 1, -1)]
    with FakeTensorMode() as mode:
        fake = mode.from_tensor(t)
        res["gather_fake_shape"] = list(mesh_gather(fake, mesh, "model", 1).shape)
    return res


# -- suite: cli (tests/test_torch_serve_parallel.py and
#    tests/test_torch_imagenet_example.py share this world) ------------------

SERVE_ARGS = ["--device", "cpu", "--num-classes", "10", "--size", "32",
              "--batch-size", "4", "--requests", "2"]
RECIPE = os.path.join(ROOT, "examples", "recipes", "imagenet-baseline.yaml")
# no optimizer section: the trainer falls back to its CLI optimizer
FALLBACK_RECIPE = os.path.join(ROOT, "examples", "recipes", "xnor-net.yaml")
TRAIN_ARGS = ["--synthetic", "--device", "cpu", "--image-size", "32", "-b", "8",
              "--steps-per-epoch", "2", "--print-freq", "1"]
PIPE_ARGS = ["--pipeline", "2", "--microbatches", "2", "--recipe", FALLBACK_RECIPE,
             "--lr", "0.01", "--weight-decay", "0.5", "--warmup-epochs", "0",
             "--steps-per-epoch", "1"]


def cli_inputs(d) -> dict:
    """The cli world's inputs: a checkpoint of the serve CLI's model (BN
    statistics, output scales random) for --ckpt."""
    sys.path.insert(0, ROOT)
    import bnn_tpu_torch as bt
    from bnn_tpu_torch.examples import serve

    model = serve.build_model(10)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, bt.nn.BatchNorm2d):
                m.running_mean.copy_(0.3 * torch.randn(m.num_features, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(m.num_features, generator=gen))
                m.weight.copy_(1 + 0.3 * torch.randn(m.num_features, generator=gen))
                m.bias.copy_(0.3 * torch.randn(m.num_features, generator=gen))
    ckpt = os.path.join(str(d), "ckpt")
    bt.utils.save_checkpoint(ckpt, model, metadata={"epoch": 1})
    return {"dir": str(d), "ckpt": ckpt}


def _printed(main, argv) -> str:
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _record_losses(imagenet) -> list:
    losses = []
    real = imagenet.make_train_step

    def recording(**kw):
        step = real(**kw)

        def run(model, opt, x, y):
            out = step(model, opt, x, y)
            losses.append(float(out["loss"]))
            return out
        return run

    imagenet.make_train_step = recording
    return losses


def _record_pipeline(imagenet) -> dict:
    """Each pipeline step's loss beside HeteroPipeline.apply's and the
    sequential stages' on the same row and batch, whether the BatchNorm
    lanes of the row are the forward's statistics after the step, and
    whether the parameter lanes moved."""
    import torch.nn.functional as F

    from bnn_tpu_torch.utils import gather_replicated

    rec = {"losses": [], "apply": [], "sequential": [], "stats_kept": [], "moved": []}
    real = imagenet.pipeline_step

    def recording(pipe, flat, optimizer, x, y, microbatches):
        before = flat.detach().clone()
        with torch.no_grad():
            rec["apply"].append(float(F.cross_entropy(
                pipe.apply(before, x, n_microbatches=microbatches), y)))
            stages = pipe.stage_modules(gather_replicated(flat).detach())
            seq = []
            for xm, ym in zip(x.chunk(microbatches), y.chunk(microbatches)):
                h = xm
                for m in stages:
                    h = m(h)
                seq.append(F.cross_entropy(h, ym))
            rec["sequential"].append(float(torch.stack(seq).mean()))
        captured = []
        apply = pipe.apply
        pipe.apply = lambda *a, **k: captured.append(apply(*a, **k)) or captured[-1]
        try:
            loss, top1 = real(pipe, flat, optimizer, x, y, microbatches)
        finally:
            pipe.apply = apply
        mask = pipe.param_mask[0] > 0
        new = captured[0][1][0]
        rec["losses"].append(float(loss))
        rec["stats_kept"].append(torch.equal(flat.detach()[0][~mask], new[~mask]))
        rec["moved"].append(bool((flat.detach()[0][mask] != before[0][mask]).any()))
        return loss, top1

    imagenet.pipeline_step = recording
    return rec


def suite_cli(rank, world, inp):
    """The serve CLI and the ImageNet trainer, each main(argv) in a world of
    two gloo ranks, every rank's printed lines kept."""
    _port()
    from bnn_tpu_torch.examples import imagenet, serve

    d = inp["dir"]
    res = {"ckpt": inp["ckpt"]}
    for tag, extra in (("dp", ["--data-parallel", "2"]), ("tp", ["--tensor-parallel", "2"]),
                       ("tp_ckpt", ["--tensor-parallel", "2", "--ckpt", inp["ckpt"]]),
                       ("dp_ckpt", ["--data-parallel", "2", "--ckpt", inp["ckpt"]])):
        res[f"serve_{tag}"] = _printed(serve.main, SERVE_ARGS + extra)
    for tag, flag in (("dp", "--data-parallel"), ("tp", "--tensor-parallel")):
        path = os.path.join(d, f"bundle_{tag}")
        res[f"export_{tag}"] = _printed(serve.main, SERVE_ARGS + [flag, "2", "--export", path])
        res[f"load_{tag}"] = _printed(serve.main, SERVE_ARGS + ["--load", path])
    res["continuous"] = _printed(serve.main, SERVE_ARGS + [
        "--data-parallel", "2", "--continuous", "--stream-rps", "500"])
    res["continuous_load"] = _printed(serve.main, SERVE_ARGS + [
        "--load", os.path.join(d, "bundle_tp"), "--continuous", "--stream-rps", "500"])

    losses = _record_losses(imagenet)
    for tag, extra in (("mp", ["--model-parallel", "2"]),
                       ("zero1", ["--zero1", "--accum-steps", "2"])):
        del losses[:]
        res[f"train_{tag}"] = _printed(imagenet.main, TRAIN_ARGS + extra + [
            "--epochs", "1", "--recipe", RECIPE, "--out", os.path.join(d, f"train_{tag}")])
        res[f"losses_{tag}"] = list(losses)
    pipe = _record_pipeline(imagenet)
    out = os.path.join(d, "train_pp")
    res["train_pp"] = _printed(imagenet.main, TRAIN_ARGS + PIPE_ARGS + [
        "--epochs", "1", "--out", out])
    res["train_pp_resume"] = _printed(imagenet.main, TRAIN_ARGS + PIPE_ARGS + [
        "--epochs", "2", "--out", out, "--resume", out])
    res["pipeline"] = pipe
    return res


SUITES = {"parallel": suite_parallel, "pipeline": suite_pipeline,
          "tp_serving": suite_tp_serving, "mesh_bundle": suite_mesh_bundle,
          "cli": suite_cli}


def main():
    suite, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    try:
        torch.distributed.init_process_group(
            "gloo", init_method=f"file://{os.path.join(workdir, 'store')}",
            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
        inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=True)
        res = SUITES[suite](rank, world, inp)
        res["jax_imported"] = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "bnn_tpu"))
        tmp = os.path.join(workdir, f"rank{rank}.pt.tmp")
        torch.save(res, tmp)
        os.replace(tmp, os.path.join(workdir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
