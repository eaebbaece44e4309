"""QAT training steps back to back on a pool of batches that stay on the
device: ``make_train_step`` at the configuration's compute dtype with
AdamW, step ``i`` on batch ``i mod pool``. The loss is read to the host
every ``log_every`` steps, as a trainer logs; every step's loss is checked
for finiteness then.

Mix parameters: ``batch``, ``pool``, ``lr``, ``weight_decay``,
``log_every``, ``slice`` (steps in a traced run's profiled slice, a
multiple of ``log_every``).

Set-up builds one model, optimizer and step, and drives them through the
first three steps (batches 0, 1, 2: every row differs) with the window's
own call; the window goes on with the same objects. End-to-end:
``train_images_per_s``, ``batch x steps`` over the window, which ends on a
synchronize.

``correct``: after the window, the plain reference in float32 takes the
same three steps from the same weights on the same batches:

- ``loss_gap``: the worst step's ``|loss - reference| / |reference|``;
- ``grad_norm_gap``: the first gradient as the optimizer got it (its first
  moment after one step over ``1 - beta1``), the worst parameter's gap of
  norms ``|norm - reference norm|`` over the larger of that parameter's
  reference norm and the median parameter's;
- ``change_norm_gap``: the same for each parameter's change over the three
  steps (read before the fourth), over the parameters whose reference
  gradient is at least a thousandth of the median parameter's (a binary
  output scale under a train-mode norm has a gradient of rounding noise, and
  AdamW moves it by that noise alone).

Once the window (and a traced run's slice) has closed, the same objects
take one more step through the same call and feed, from a snapshot of the
weights and the optimizer's moments and step count (:func:`late_step`):
the reference follows its forward layer by layer from those weights
(``late_layer_err``) and its AdamW update from the program's own gradient,
moments and step count (``late_update_err``), so that the state the window
built up, and AdamW's bias correction far past its first steps, are held
too.
"""
from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from .. import arch, program, weights
from ..core import Context, Record
from ..reference import common
from ..trace import profile_slice

POOL_STREAM = 2
LABEL_STREAM = 3
FIRST_STEPS = 3
BETA1 = 0.9  # torch.optim.AdamW's default, which the program's optimizer takes


class Trainer:
    """One model, optimizer and step function at the cell's size, and the pool."""

    def __init__(self, ctx: Context):
        cfg, mix = ctx.config, ctx.mix
        self.ctx, self.batch = ctx, mix["batch"]
        state = weights.make_state(cfg, ctx.seed, ctx.device)
        self.state = {k: v.cpu() for k, v in state.items()}
        shape = (cfg["in_channels"], cfg["image_size"], cfg["image_size"])
        n = mix["pool"] * self.batch
        images = weights.make_images(ctx.seed, n, shape, ctx.device, POOL_STREAM)
        labels = weights.make_labels(ctx.seed, n, cfg["num_classes"], ctx.device,
                                     LABEL_STREAM)
        self.pool = [(images[i * self.batch:(i + 1) * self.batch],
                      labels[i * self.batch:(i + 1) * self.batch])
                     for i in range(mix["pool"])]
        self.model = program.qat_model(cfg, state, ctx.device).train()
        del state
        self.opt = torch.optim.AdamW(self.model.parameters(), lr=mix["lr"],
                                     weight_decay=mix["weight_decay"])
        self.step_fn = program.train_step(cfg)
        rng = np.random.default_rng([ctx.seed % (1 << 63), 23])
        self.rows = torch.as_tensor(np.sort(rng.choice(
            self.batch, min(mix["rows"], self.batch), replace=False)))

    def step(self, i: int) -> torch.Tensor:
        x, y = self.pool[i % len(self.pool)]
        return self.step_fn(self.model, self.opt, x, y)["loss"]

    def first_steps(self) -> dict:
        """Steps 1-3 with what the check compares: each loss, the first
        gradient's norm per parameter and each parameter's change; for step
        1 also the compared rows' input and output of each layer the family
        watches (``kept``), and each parameter's first gradient and change
        (``first``)."""
        params = dict(self.model.named_parameters())
        start = {k: p.detach().clone() for k, p in params.items()}
        losses, grad_norms, kept, first = [], {}, {}, {}
        for i in range(FIRST_STEPS):
            hooks = self._hooks(kept) if i == 0 else []
            try:
                losses.append(float(self.step(i)))
            finally:
                for h in hooks:
                    h.remove()
            if i == 0:
                # an optimizer that kept no moment got no gradient: it reads 0
                grads = {k: self.opt.state[p].get("exp_avg", torch.zeros_like(p)) / (1 - BETA1)
                         for k, p in params.items()}
                grad_norms = {k: float(g.double().norm()) for k, g in grads.items()}
                first = {k: (grads[k].cpu(), (p.detach() - start[k]).cpu())
                         for k, p in params.items()}
        change = {k: float((p.detach() - start[k]).double().norm())
                  for k, p in params.items()}
        return {"losses": losses, "grad_norms": grad_norms, "change_norms": change,
                "kept": kept, "first": first}

    def late_step(self, i: int) -> dict:
        """Step ``i`` from a snapshot: the weights before it (``params``),
        the optimizer's moments and its step count ``t`` for it, the
        gradient as the optimizer got it, each parameter's change, and the
        compared rows' layers (``kept``), all on the host."""
        # a parameter the optimizer kept no moments for never had a gradient
        # (the first steps' gradient gaps read that); AdamW leaves it alone
        params = {k: p for k, p in self.model.named_parameters() if "exp_avg" in self.opt.state[p]}
        before = {k: p.detach().clone() for k, p in params.items()}
        moments, t = {}, 0
        for k, p in params.items():
            st = self.opt.state[p]
            moments[k] = (st["exp_avg"].clone(), st["exp_avg_sq"].clone())
            t = int(st["step"]) + 1
        kept: dict = {}
        hooks = self._hooks(kept)
        try:
            loss = float(self.step(i))
        finally:
            for h in hooks:
                h.remove()
        out = {"params": {}, "moments": {}, "grads": {}, "change": {}, "t": t,
               "loss": loss, "kept": kept}
        for k, p in params.items():
            m0, v0 = moments[k]
            g = (self.opt.state[p]["exp_avg"] - BETA1 * m0) / (1 - BETA1)
            out["params"][k] = before[k].cpu()
            out["moments"][k] = (m0.cpu(), v0.cpu())
            out["grads"][k] = g.cpu()
            out["change"][k] = (p.detach() - before[k]).cpu()
        return out

    def _hooks(self, keep: dict) -> list:
        rows = self.rows

        def put(name):
            def hook(module, args, out):
                r = rows[rows < out.shape[0]]
                keep[name] = (args[0].detach()[r].cpu(), out.detach()[r].cpu())
            return hook

        watched = arch.family(self.ctx.config).train_watched(self.ctx.config)
        return [m.register_forward_hook(put(n)) for n, m in self.model.named_modules()
                if n in watched]

    def close(self) -> None:
        self.model = self.opt = self.step_fn = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, q=None) -> dict:
        """The reference's first steps from the same weights and batches."""
        kw = {} if q is None else {"q": q}
        state = {k: v.to(self.ctx.device) for k, v in self.state.items()}
        return common.train_steps(arch.reference(self.ctx.config).Forward, self.ctx.config,
                                  state, self.pool[:FIRST_STEPS], lr=self.ctx.mix["lr"],
                                  weight_decay=self.ctx.mix["weight_decay"], **kw)


def _norm_gaps(got: Dict[str, float], want: Dict[str, float], names) -> list:
    names = list(names)
    median = statistics.median(want[k] for k in names)
    return [abs(got[k] - want[k]) / max(want[k], median) for k in names]


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers the check compares (see the module's docstring), and the
    median parameter's gaps beside the worst's."""
    loss = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    g = ref["grad_norms"]
    median = statistics.median(g.values())
    moving = [k for k in g if g[k] >= 1e-3 * median]
    grad = _norm_gaps(prog["grad_norms"], g, g)
    change = _norm_gaps(prog["change_norms"], ref["change_norms"], moving)
    return {"loss_gap": max(loss), "loss_gap_first": loss[0],
            "grad_norm_gap": max(grad), "grad_gap_median": statistics.median(grad),
            "change_norm_gap": max(change),
            "change_gap_median": statistics.median(change)}


@torch.no_grad()
def layer_numbers(tr: Trainer, kept: dict, q=None, params=None,
                  key: str = "layer_err") -> Dict[str, float]:
    """Step 1's forward, followed layer by layer: ``layer_err``, the worst
    row's relative L2 gap of the program's output of each watched layer
    (the family's ``train_watched``: for a ResNet the float stem conv, each
    binary layer with its output scale, and the head) against the
    reference's (the family's ``train_layer``) on the program's own input,
    from the f32 weights (with ``params``, from those). With ``q``, the
    control's outputs (the reference in that precision)."""
    dev, cfg = tr.ctx.device, tr.ctx.config
    fam, Forward = arch.family(cfg), arch.reference(cfg).Forward
    state = {k: v.to(dev) for k, v in {**tr.state, **(params or {})}.items()}
    ref = Forward(cfg, state, train=True)
    low = ref if q is None else Forward(cfg, state, train=True, q=q)
    spec = {l["name"]: l for l in arch.conv_layers(cfg)}
    worst = 0.0
    with common.exact_matmul():
        for name, (h, out) in kept.items():
            h = h.to(dev, torch.float32)
            got = out.to(dev, torch.float32) if q is None else fam.train_layer(low, spec[name], h)
            want = fam.train_layer(ref, spec[name], h)
            gap = ((got - want).flatten(1).double().norm(dim=1)
                   / want.flatten(1).double().norm(dim=1)).max()
            worst = max(worst, float(gap))
    return {key: worst}


def _adamw_change(tr: Trainer, first: dict, dtype) -> Dict[str, torch.Tensor]:
    dev = tr.ctx.device
    params = {k: tr.state[k].to(dev, dtype).clone() for k in first}
    start = {k: v.clone() for k, v in params.items()}
    common.adamw_step(params, {k: g.to(dev, dtype) for k, (g, _) in first.items()},
                      {}, 1, tr.ctx.mix["lr"], tr.ctx.mix["weight_decay"])
    return {k: (params[k] - start[k]).double() for k in params}


@torch.no_grad()
def update_numbers(tr: Trainer, first: dict, dtype=None) -> Dict[str, float]:
    """Step 1's AdamW update, followed from the program's own first
    gradient: ``update_err``, the worst parameter's ``||change - reference||
    / ||reference||``, the reference's AdamW in f32 from the same weights and
    gradient. With ``dtype``, the control's change: the same AdamW in that
    precision."""
    want = _adamw_change(tr, first, torch.float32)
    got = (_adamw_change(tr, first, dtype) if dtype is not None
           else {k: c.to(tr.ctx.device).double() for k, (_, c) in first.items()})
    return {"update_err": max(float((got[k] - want[k]).norm() / want[k].norm())
                              for k in want)}


@torch.no_grad()
def late_numbers(tr: Trainer, late: dict, dtype=None, q=None) -> Dict[str, float]:
    """The step after the window (:meth:`Trainer.late_step`):
    ``late_update_err``, the worst parameter's ``||change - reference|| /
    ||reference||``, the reference's AdamW in f32 from the snapshot's
    weights, moments and step count and the program's own gradient; and
    ``late_layer_err``, its forward as :func:`layer_numbers` reads it, from
    the snapshot's weights. With ``dtype`` and ``q``, the control's: that
    AdamW in ``dtype``, that forward in ``q``."""
    dev, mix = tr.ctx.device, tr.ctx.mix

    def change(dt):
        P = {k: v.to(dev, dt).clone() for k, v in late["params"].items()}
        start = {k: v.clone() for k, v in P.items()}
        state = {k: (m.to(dev, dt).clone(), v.to(dev, dt).clone())
                 for k, (m, v) in late["moments"].items()}
        common.adamw_step(P, {k: g.to(dev, dt) for k, g in late["grads"].items()},
                          state, late["t"], mix["lr"], mix["weight_decay"])
        return {k: (P[k] - start[k]).double() for k in P}

    want = change(torch.float32)
    got = (change(dtype) if dtype is not None
           else {k: c.to(dev).double() for k, c in late["change"].items()})
    # an optimizer that kept no moments at all moved nothing: no number
    out = {"late_update_err": max((float((got[k] - want[k]).norm() / want[k].norm())
                                   for k in want), default=float("nan"))}
    out.update(layer_numbers(tr, late["kept"], q=q, params=late["params"],
                             key="late_layer_err"))
    return out


def train(tr: Trainer, start: int, seconds: float = float("inf"),
          steps: int = -1) -> dict:
    """Steps back to back for ``seconds`` (or exactly ``steps``, a multiple
    of ``log_every``), the loss read every ``log_every``."""
    every = tr.ctx.mix["log_every"]
    losses: List[torch.Tensor] = []
    nonfinite = 0
    tr.ctx.sync()
    t0 = time.perf_counter()
    end = t0 + seconds
    i = start
    while True:
        losses.append(tr.step(i))
        i += 1
        if len(losses) % every == 0:
            nonfinite += int((~torch.isfinite(torch.stack(losses[-every:]))).sum())
            if time.perf_counter() >= end or len(losses) == steps:
                break
    tr.ctx.sync()
    elapsed = time.perf_counter() - t0
    return {"seconds": elapsed, "steps": i - start, "failed": nonfinite, "next": i}


def run(ctx: Context) -> Record:
    mix = ctx.mix
    rec = Record("train", ctx.config, mix, mix["batch"])
    tr = Trainer(ctx)
    first = tr.first_steps()
    ctx.sync()
    setup = ctx.ready()
    w = train(tr, FIRST_STEPS, seconds=ctx.seconds)
    rec.attempted, rec.failed = w["steps"], w["failed"]
    images = w["steps"] * tr.batch
    rec.window = {"seconds": w["seconds"], "units": w["steps"], "images": images}
    rec.end_to_end = {"train_images_per_s": (images / w["seconds"], "images/s"),
                      "setup_s": (setup, "s")}
    if ctx.trace:
        n = mix["slice"]
        rec.trace = profile_slice(lambda: train(tr, w["next"], steps=n), n,
                                  periods=n // mix["log_every"])
    late = tr.late_step(w["next"] + (mix["slice"] if ctx.trace else 0))
    if ctx.device.type == "cuda":
        rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(ctx.device))
    tr.close()
    got = {**numbers(first, tr.reference()), **layer_numbers(tr, first["kept"]),
           **update_numbers(tr, first["first"]), **late_numbers(tr, late)}
    for name, limit in ctx.cell["limits"].items():
        rec.checks[name] = (got.get(name, float("nan")), limit)
    return rec
