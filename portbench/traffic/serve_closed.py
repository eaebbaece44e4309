"""Closed-loop serving: one client sends a host batch of float32 NCHW
images through ``Predictor.__call__``, reads the logits back to the host,
then sends the next. The batches come from a pool of distinct batches made
on the device from the seed at set-up and held in pinned host memory, as a
server's receive buffers would be; request ``i`` sends batch ``i mod pool``.

Mix parameters: ``batch`` (images a request), ``pool`` (distinct batches),
``warmup`` (requests at set-up), ``sample`` (requests of the window whose
results are compared), ``sample_range`` (they are drawn from the seed among
the window's first so many), ``slice`` (requests in a traced run's profiled
slice), ``rows`` (rows of a compared request that the check keeps) and
``predictor`` (keyword arguments of ``Predictor`` beyond its defaults).

End-to-end: ``serve_images_per_s`` (images whose logits reached the host,
over the window) and ``serve_p95_ms`` (95th percentile of request latency,
from the call into ``Predictor.__call__`` to the logits on the host).

``correct``: on the compared requests, forward hooks on the served model's
modules that the configuration's family watches (``watched_names``: for a
ResNet its stages, blocks and binary layers) keep each one's input and
output on the host; after the window the plain reference follows the
program module by module from those tensors (:func:`numbers`, the family's
``serve_pairs``). A binary network turns any rounding of a value near a
sign into a flipped sign, and the flips spread through the next binary
layers until the logits of a bf16 forward and of an fp8 one differ from
float32's by the same few percent; within one block, from the same input,
they stay in proportion to the precision. A module four binary convs deep
(a ResNet stage in ``fused_chain``) is past that point, so a cell serves no
such module.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import arch, program, weights
from ..core import Context, Record
from ..reference.common import exact_matmul
from ..trace import profile_slice

POOL_STREAM = 1


class Server:
    """The program at the cell's size and the request pool."""

    def __init__(self, ctx: Context):
        cfg, mix = ctx.config, ctx.mix
        self.ctx, self.batch = ctx, mix["batch"]
        state = weights.make_state(cfg, ctx.seed, ctx.device)
        self.state = {k: v.cpu() for k, v in state.items()}
        shape = (cfg["in_channels"], cfg["image_size"], cfg["image_size"])
        images = weights.make_images(ctx.seed, mix["pool"] * self.batch, shape,
                                     ctx.device, POOL_STREAM)
        pin = ctx.device.type == "cuda"
        self.pool = []
        for i in range(mix["pool"]):
            xb = images[i * self.batch:(i + 1) * self.batch].cpu()
            self.pool.append(xb.pin_memory() if pin else xb)
        del images
        model = program.qat_model(cfg, state, ctx.device)
        del state
        self.pred = program.predictor(model, cfg, self.batch, ctx.device,
                                      **mix.get("predictor", {}))
        self.family = arch.family(cfg)
        self.watched = self.family.watched_names(cfg)
        rng = np.random.default_rng([ctx.seed % (1 << 63), 19])
        self.rows = torch.as_tensor(np.sort(rng.choice(
            self.batch, min(mix["rows"], self.batch), replace=False)))

    def request(self, i: int, keep: Optional[dict] = None, check: bool = False):
        """Serve request ``i``: (host seconds in the call, latency, logits,
        and with ``check`` whether they are all finite, else None). With
        ``keep``, forward hooks on the served model's stages put each stage's
        input and output there, on the host."""
        xb = self.pool[i % len(self.pool)]
        hooks = [] if keep is None else self._hooks(keep)
        try:
            t0 = time.perf_counter()
            out = self.pred(xb)
            t1 = time.perf_counter()
            host = out.cpu()
            t2 = time.perf_counter()
            # read on the device, after the latency: one small reduction in
            # place of a pass of the CPU operators over the bf16 logits, which
            # woke every host thread inside the window
            finite = bool(torch.isfinite(out).all()) if check else None
        finally:
            for h in hooks:
                h.remove()
        return t1 - t0, t2 - t0, host, finite

    def _hooks(self, keep: dict) -> list:
        """Hooks that keep the compared ``rows`` of the input and output of
        each watched module of the served model that runs as a module, under
        its published name (the family's ``published_name``: wrapper
        modules' names dropped)."""
        rows = self.rows
        pin = self.ctx.device.type == "cuda"

        def host(t):
            # a copy on the request's own stream into pinned memory: no wait
            # for the device in the timed path (read after a synchronize)
            t = t.detach()[rows]
            if not pin:
                return t.clone()
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return buf.copy_(t, non_blocking=True)

        def put(name):
            def hook(module, args, out):
                keep[name] = (host(args[0]), host(out))
            return hook

        hooks = []
        for name, module in self.pred.served_model().named_modules():
            published = self.family.published_name(name)
            # the module the name ends on: a block's wrapper, not the block
            # inside it or the block's activations and norms
            last = published.rsplit(".", 1)[-1]
            if published in self.watched and name.rsplit(".", 1)[-1] == last:
                hooks.append(module.register_forward_hook(put(published)))
        return hooks

    def close(self) -> None:
        self.pred = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()


def warm(srv: Server) -> None:
    """The set-up's requests: ``warmup`` of them, the first ``sample`` with
    the check's hooks, so that the window finds the pinned buffers cached."""
    mix = srv.ctx.mix
    kept = [{} for _ in range(mix["sample"])]
    for i in range(mix["warmup"]):
        srv.request(i, kept[i] if i < len(kept) else None)
    srv.ctx.sync()


def sample_ids(ctx: Context) -> List[int]:
    """The window's requests that are compared, drawn from the seed among
    its first ``sample_range`` requests."""
    rng = np.random.default_rng([ctx.seed % (1 << 63), 17])
    mix = ctx.mix
    return sorted(int(i) for i in rng.choice(mix["sample_range"], mix["sample"],
                                              replace=False))


def serve(srv: Server, seconds: float, compare: List[int], start: int = 0) -> dict:
    """Requests back to back for ``seconds``; returns their host times and
    latencies, failures, and ``kept``: ``(pool id, stage tensors, logits)``
    of each request in ``compare`` that was served, in the window or after
    it."""
    call_s: List[float] = []
    lat_s: List[float] = []
    kept: List[tuple] = []
    compare = set(compare)
    failed = 0
    i = start
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        keep = {} if i in compare else None
        try:
            c, lat, logits, ok = srv.request(i, keep, check=True)
        except Exception as e:  # a request that raises is a failed request
            print(f"request {i} raised {type(e).__name__}: {e}", flush=True)
            c, lat, logits, ok = float("nan"), float("nan"), None, False
        if ok:
            call_s.append(c)
            lat_s.append(lat)
            if keep is not None:
                kept.append((i % len(srv.pool), keep, logits))
        else:
            failed += 1
        i += 1
        if time.perf_counter() >= end:
            break
    elapsed = time.perf_counter() - t0
    attempted = i - start
    # compared requests that the window did not reach are served after it,
    # outside its numbers, for a minute at most
    late = time.perf_counter() + 60
    while compare and i <= max(compare) and time.perf_counter() < late:
        keep = {} if i in compare else None
        try:
            _, _, logits, ok = srv.request(i, keep, check=keep is not None)
            if ok:
                kept.append((i % len(srv.pool), keep, logits))
        except Exception as e:  # a compared request that raises is not compared
            print(f"request {i} raised {type(e).__name__}: {e}", flush=True)
        i += 1
    return {"seconds": elapsed, "call_s": call_s, "latency_s": lat_s,
            "failed": failed, "attempted": attempted, "kept": kept, "next": i}


def rel_l2(got: torch.Tensor, want: torch.Tensor, allowance=None) -> float:
    """The worst row's ``||got - want|| / ||want||``; with ``allowance``,
    each element's gap less its allowance (not below 0)."""
    got, want = got.double().flatten(1), want.double().flatten(1)
    gap = (got - want).abs()
    if allowance is not None:
        gap = (gap - allowance.double().flatten(1)).clamp(min=0)
    return float((gap.norm(dim=1) / want.norm(dim=1)).max())


def pairs(srv: Server, kept: list, q=None):
    """The reference following the program, over the compared requests and
    rows: the family's ``serve_pairs`` on each request's images, kept
    module inputs and outputs and logits, on the device in float32, with
    the reference's ``Forward`` over the same weights. Each comes as
    ``(name, got, want, allowance)``, the allowance None or what ``got``
    may lie off ``want`` by element. With ``q``, ``got`` is the control's:
    the reference in that precision put in the program's place, on the
    same inputs."""
    ctx = srv.ctx
    dev = ctx.device
    Forward = arch.reference(ctx.config).Forward
    state = {k: v.to(dev) for k, v in srv.state.items()}
    ref = Forward(ctx.config, state)
    low = ref if q is None else Forward(ctx.config, state, q=q)
    rows = srv.rows

    def requests():
        for pool_id, keep, logits in kept:
            yield (srv.pool[pool_id][rows].to(dev), {
                k: (i.to(dev, torch.float32), o.to(dev, torch.float32))
                for k, (i, o) in keep.items()}, logits[rows].to(dev, torch.float32))

    with torch.no_grad(), exact_matmul():
        yield from srv.family.serve_pairs(ref, low, q, requests())


def numbers(srv: Server, kept: list, q=None) -> Dict[str, float]:
    """``<name>_err``: the worst row's relative L2 gap of each of
    :func:`pairs`."""
    out: Dict[str, float] = {}
    for name, got, want, allow in pairs(srv, kept, q):
        out[name + "_err"] = max(out.get(name + "_err", 0.0), rel_l2(got, want, allow))
    return out


def run(ctx: Context) -> Record:
    mix = ctx.mix
    rec = Record("serve", ctx.config, mix, mix["batch"])
    srv = Server(ctx)
    warm(srv)
    setup = ctx.ready()
    w = serve(srv, ctx.seconds, sample_ids(ctx))
    ctx.sync()
    images = len(w["latency_s"]) * srv.batch
    rec.attempted, rec.failed = w["attempted"], w["failed"]
    rec.window = {"seconds": w["seconds"], "units": len(w["latency_s"]),
                  "images": images, "call_s": w["call_s"], "latency_s": w["latency_s"]}
    lat_ms = np.asarray(w["latency_s"]) * 1e3
    rec.end_to_end = {
        "serve_images_per_s": (images / w["seconds"], "images/s"),
        "serve_p95_ms": (float(np.percentile(lat_ms, 95)) if len(lat_ms) else float("nan"),
                         "ms"),
        "setup_s": (setup, "s"),
    }
    if ctx.trace:
        start, n = w["next"], mix["slice"]

        def units():
            for i in range(start, start + n):
                srv.request(i)

        rec.trace = profile_slice(units, n, run_unit=lambda: srv.request(start + n))
    if ctx.device.type == "cuda":
        rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(ctx.device))
    srv.close()
    if len(w["kept"]) < mix["sample"]:
        rec.notes.append(f"{len(w['kept'])} of {mix['sample']} compared requests served")
    got = numbers(srv, w["kept"]) if len(w["kept"]) == mix["sample"] else {}
    for name, limit in ctx.cell["limits"].items():
        rec.checks[name] = (got.get(name, float("nan")), limit)
    return rec
