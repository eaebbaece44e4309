"""The readings the limits of ``correct`` are set from, for one cell over
many seeds in one process, at the cell's own size:

- ``program``: the numbers a sound run compares (the program's timed path
  against the plain reference), after a short window at the cell's load
  that compares as many requests as a run does;
- ``control``: the same numbers with the reference put in the program's
  place and computed in the precision below the configuration's bf16, fp8
  (:mod:`portbench.reference.lowp`);
- for a training cell, ``half``: the program with half of each batch left
  out, the mean taken over the rest.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 [--seconds 2]

Prints one JSON line a seed and a summary line (the largest program reading
and the smallest control and fault readings of each number). The
benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict

import torch

from . import arch
from .core import Context, load_cell
from .reference import common, lowp


def stats(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Further gaps of one stage for the record: the worst row's median
    element gap over the row's RMS, and the share of elements on the other
    side of zero."""
    got, want = got.double().flatten(1), want.double().flatten(1)
    rms = want.square().mean(dim=1, keepdim=True).sqrt()
    med = ((got - want).abs() / rms).median(dim=1).values.max()
    flip = ((got > 0) != (want > 0)).double().mean(dim=1).max()
    return {"med": float(med), "flip": float(flip)}


def serve_stats(srv, kept, q=None) -> dict:
    from .traffic import serve_closed as sc

    out = {}
    for name, got, want, _ in sc.pairs(srv, kept, q):
        for k, v in stats(got, want).items():
            out[f"{name}_{k}"] = max(out.get(f"{name}_{k}", 0.0), v)
    return out


@torch.no_grad()
def logit_numbers(srv, kept: list, q=None) -> Dict[str, float]:
    """End to end, for the record: the served logits (with ``q``, the
    reference's in that precision) against the reference's from the images.
    Sign flips spread through the binary layers until bf16 and fp8 read
    alike here, so no limit is set on it."""
    from .traffic import serve_closed as sc

    ids = sorted({p for p, _, _ in kept})
    images = torch.cat([srv.pool[p] for p in ids])
    cfg = srv.ctx.config
    state = {k: v.to(srv.ctx.device) for k, v in srv.state.items()}
    Forward = arch.reference(cfg).Forward
    ref = common.logits(Forward, cfg, state, images)
    low = None if q is None else common.logits(Forward, cfg, state, images, q=q)
    b, worst = srv.batch, 0.0
    for p, _, logits in kept:
        n = ids.index(p)
        got = logits if low is None else low[n * b:(n + 1) * b]
        worst = max(worst, sc.rel_l2(got, ref[n * b:(n + 1) * b]))
    return {"logit_err": worst}


def serve_readings(ctx: Context) -> dict:
    from .traffic import serve_closed as sc

    srv = sc.Server(ctx)
    sc.warm(srv)
    w = sc.serve(srv, ctx.seconds, sc.sample_ids(ctx))
    ctx.sync()
    srv.close()
    kept = w["kept"]
    t0 = time.perf_counter()
    program = sc.numbers(srv, kept)
    ref_s = time.perf_counter() - t0
    return {"requests": len(kept), "window_requests": len(w["latency_s"]),
            "reference_s": ref_s,
            "program": {**program, **logit_numbers(srv, kept),
                        **serve_stats(srv, kept)},
            "control": {**sc.numbers(srv, kept, q=lowp.fp8),
                        **logit_numbers(srv, kept, q=lowp.fp8),
                        **serve_stats(srv, kept, q=lowp.fp8)}}


def train_readings(ctx: Context) -> dict:
    from .traffic import train_steps as ts

    tr = ts.Trainer(ctx)
    first = tr.first_steps()
    w = ts.train(tr, ts.FIRST_STEPS, seconds=ctx.seconds)
    late = tr.late_step(w["next"])
    tr.close()
    t0 = time.perf_counter()
    ref = tr.reference()
    program = {**ts.numbers(first, ref), **ts.layer_numbers(tr, first["kept"]),
               **ts.update_numbers(tr, first["first"]), **ts.late_numbers(tr, late)}
    ref_s = time.perf_counter() - t0
    out = {"reference_s": ref_s, "window_steps": w["steps"], "late_t": late["t"],
           "program": program,
           "control": {**ts.numbers(tr.reference(q=lowp.fp8_train), ref),
                       **ts.layer_numbers(tr, first["kept"], q=lowp.fp8),
                       **ts.update_numbers(tr, first["first"], dtype=torch.bfloat16),
                       **ts.late_numbers(tr, late, dtype=torch.bfloat16, q=lowp.fp8)}}
    g = ref["grad_norms"]
    median = sorted(g.values())[len(g) // 2]
    out["worst_grad_leaves"] = sorted(
        ([k, first["grad_norms"][k], g[k], median] for k in g),
        key=lambda r: -abs(r[1] - r[2]) / max(r[2], r[3]))[:6]
    half = ts.Trainer(ctx)
    whole = half.step_fn
    half.step_fn = lambda model, opt, x, y: whole(model, opt, x[:x.shape[0] // 2],
                                                  y[:y.shape[0] // 2])
    out["half"] = ts.numbers(half.first_steps(), ref)
    half.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    device = torch.device("cuda", 0)
    read = serve_readings if cell["mix"]["kind"] == "serve_closed" else train_readings
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = Context(cell, seed, args.seconds, False, device, time.perf_counter(), 0.0)
        t0 = time.perf_counter()
        line = {"workload": args.workload, "seed": seed, **read(ctx),
                "seconds": time.perf_counter() - t0}
        lines.append(line)
        print(json.dumps(line), flush=True)
    summary = {"workload": args.workload, "seeds": len(lines)}
    for side, pick in (("program", max), ("control", min), ("half", min)):
        if side in lines[0]:
            summary[side] = {k: pick(l[side][k] for l in lines) for k in lines[0][side]}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
