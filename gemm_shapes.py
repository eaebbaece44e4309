#!/usr/bin/env python3
"""Time ``binary_gemm`` (or, with ``--conv``, ``binary_conv2d_s1``, with
``--popcount``, ``popcount_gemm``, with ``--chain``, ``fused_chain``, with
``--bottleneck``, ``fused_bottleneck``, with ``--stem``, ``fused_stem``
and ``fused_stem_chain``, or with ``--blocks``, ``fused_basic_block`` and
``fused_downsample_block``, or with ``--conv2d``, ``binary_conv2d``) at the
serving paths' shapes, for the checkout it is run from.

    cd <checkout> && python3 <path to>/gemm_shapes.py [--label NAME] [--conv | --popcount | --chain | --bottleneck | --stem | --blocks | --conv2d]

``bnn_tpu_torch`` is imported from the current directory, so one copy of
this script times any checkout whose kernels have the public signatures:
for example a parent commit unpacked with ``git archive`` and the change,
run in turns on one card (parent, change, change, parent). For each
(M, K, N) that ResNet-50's batch 1 and batch 8 forwards and ResNet-18's
batch 8 forward give ``binary_gemm`` (``chip_smoke.py`` phase 4 captures and
prints them): ternary bf16 rows and random packed weights from a seed, f32
epilogue rows; the result held bit for bit against
``binary_gemm_reference``; the kernel's own device time per call
(``torch.profiler``), the launch plan where the checkout has ``gemm_plan``,
and ``torch._int_mm`` on the same int8 product. With ``--conv``, for each
(x shape, dtype) of path B's 13 calls (a Z1-PReLU ResNet-18's stride-1 3x3
convs at batch 8): random x with 10% exact zeros, +/-1 int8 weights passed
as the (k, k, C, O) view of an (O, C, k, k) tensor (as
``DeployedConv(mode="pallas-conv")`` passes them), f32 epilogue rows; the
result held bit for bit against ``binary_conv2d_s1_reference``; the kernel's
own device time, the device time of the whole call (the wrapper's weight
copy included), the plan where the checkout has ``conv_plan``, and
``F.conv2d`` in bf16 on the same +/-1 values; where the checkout has
``binary_conv2d``, the same conv through it (``zero_to_one``, the (O, C,
k, k) weights), bit-identical, with its plan and its kernel's and whole
call's device time. With ``--popcount``, for each
(M, K, N) of path C's 36 calls (a Z1-PReLU ResNet-50's pointwise convs,
``chip_smoke.r50_pointwise``) at batch 8 and 1: activation words packed from
random x with 10% exact zeros, random weight words, f32 epilogue rows; the
result held bit for bit against ``popcount_gemm_reference``; the kernel's
own device time, the plan where the checkout has ``popcount_plan``, and
``torch._int_mm`` on the same +/-1 int8 product. With ``--chain``, for each
``fused_chain`` call of ResNet-18's batch-1 and batch-4 forwards (its four
stages, the head in layer4's), ResNet-34's batch-1 forward (layers 1-3) and
path A's (``fuse_entry``: ResNet-18's layers 2-4) at batch 1 and 4: random
+/-1 blocks and bf16 epilogue rows from a seed (``chip_smoke.rand_block``),
a random bf16 stage input, ReLU, torch-parity signs; the result held
against ``fused_chain_reference`` (within one bf16 ulp, logits within 1e-5);
the kernel's own device time per call beside its bound
(``chip_smoke.chain_bound``). With ``--bottleneck``, for each distinct
``fused_bottleneck`` call of ResNet-50's batch-1 and batch-4 forwards
(layer1.0 with its projection, layer1.1-2, layer2.1-3, layer3.1-5,
layer4.1-2): random +/-1 weights and bf16 epilogue rows from a seed
(``chip_smoke.rand_bottleneck``), a random bf16 input, bf16 output, ReLU,
torch-parity signs, through the public ``fused_bottleneck``; the result held
against ``fused_bottleneck_reference`` (within one bf16 ulp); the kernel's
own device time per call beside its bound (``chip_smoke.bottleneck_bound``)
and, where the checkout has ``BottleneckDesc.plan``, the launch plan (tiles
and K slices per GEMM). With ``--stem``, ``fused_stem`` through its public
call at (8, 224, 224, 3), (4, 224, 224, 3) and (1, 224, 224, 3) (the serving
batches) and at the v2 and v1 entry points' geometries (1, 224, 220, 3) and
(2, 200, 196, 3): random bf16 x, 0.1 x N(0, 1) bf16 weights and bias from a
seed; the result held against ``fused_stem_reference`` (within one bf16 ulp
plus 1e-5); the kernel's own device time, the whole public call's (its
weight preparation included), cuDNN's conv + relu + max_pool (three calls)
and the bound, and the launch plan where the checkout has ``StemDesc.plan``;
then ``fused_stem_chain`` at batch 1 and 4 with two random layer1 blocks
(``chip_smoke.rand_block``): bit-identical to ``fused_chain(fused_stem(x))``,
its kernel's device time beside the split pair's two kernels and its bound
(``chip_smoke.stem_chain_bound``), and its stem phase's plan (blocks an SM
included) where the checkout has ``fused_stem_chain_plan``. With
``--blocks``, ResNet-34 layer4's per-block kernels at batch 1: two
``fused_basic_block`` calls at (1, 7, 7, 512) (layer4.1-2) and one
``fused_downsample_block`` at (1, 14, 14, 256) -> 512 (layer4.0), on random
+/-1 blocks with bf16 epilogue rows (``chip_smoke.rand_block``), a random
bf16 input, ReLU, torch-parity signs, through the public calls; each result
held against its plain version (within one bf16 ulp); each kernel's own
device time beside its bound (:func:`block_bound`), and each kernel's
launch plan (blocks, resident an SM, tiles, K slices) where the checkout
has ``fused_basic_block_plan`` / ``fused_downsample_block_plan``. With
``--conv2d``, each distinct mode-conv layer of ResNet-18's and ResNet-50's
batch-64 forwards (:data:`CONV2D`): random bf16 x with 10% exact zeros,
+/-1 weights packed over the in-channels, bf16 epilogue rows, ternary signs,
through the public ``binary_conv2d``; the result held bit for bit against
``binary_conv2d_reference``; the kernel's own device time, the whole call's,
the plain version's (sign, ``F.unfold``, int8 cast, ``torch._int_mm``,
epilogue: the deployed conv's path before the kernel) and the bound
(``portbench.roofline.call_bound_s``), with the plan and each tile's time
between CUDA events;
a checkout without the kernel times the plain version alone.
``chip_smoke`` is imported from the checkout too, so
a parent's run uses the parent's helpers. Prints the card line, one JSON
line per shape (per call with ``--chain``), then one per path with the sums
over a forward's calls (weighted by the calls per shape). Exits 1 without
CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

# (M, K, N, calls per forward) of each path's binary_gemm calls
PATHS = {
    "ResNet-50 batch 1": [
        (49, 512, 2048, 1), (49, 1024, 2048, 1), (196, 256, 1024, 1),
        (196, 512, 1024, 1), (196, 1024, 512, 1), (784, 256, 512, 1),
        (784, 512, 256, 1), (3136, 256, 128, 1)],
    "ResNet-50 batch 8": [
        (25088, 256, 64, 2), (25088, 256, 128, 1), (6272, 256, 512, 1),
        (6272, 512, 128, 3), (6272, 512, 256, 1), (1568, 256, 1024, 6),
        (1568, 512, 1024, 1), (1568, 1024, 256, 5), (1568, 1024, 512, 1),
        (392, 512, 2048, 3), (392, 1024, 2048, 1), (392, 2048, 512, 2)],
    "ResNet-18 batch 8": [(392, 256, 512, 1)],
}
# (x shape, x dtype, calls per forward) of path B's binary_conv2d_s1 calls
CONVS = [
    ((8, 56, 56, 64), torch.bfloat16, 1), ((8, 56, 56, 64), torch.float32, 3),
    ((8, 28, 28, 128), torch.bfloat16, 1), ((8, 28, 28, 128), torch.float32, 2),
    ((8, 14, 14, 256), torch.bfloat16, 1), ((8, 14, 14, 256), torch.float32, 2),
    ((8, 7, 7, 512), torch.bfloat16, 1), ((8, 7, 7, 512), torch.float32, 2),
]
# (first block's (H, C_in), plan, C_out, head) of each fused_chain call of a
# forward: ResNet-18's four stages, ResNet-34's layers 1-3 (its layer4 runs
# the per-block kernels), path A's layers 2-4 (its layer1 is fused_stem_chain)
R18_STAGES = [((56, 64), ("basic",) * 2, 64, False),
              ((56, 64), ("down", "basic"), 128, False),
              ((28, 128), ("down", "basic"), 256, False),
              ((14, 256), ("down", "basic"), 512, True)]
# (x shape at batch 1, width, C_out, calls per forward) of ResNet-50's 13
# fused_bottleneck calls (its stride-1 blocks; a projection where C_out != C)
BOTTLENECKS = [((56, 56, 64), 64, 256, 1), ((56, 56, 256), 64, 256, 2),
               ((28, 28, 512), 128, 512, 3), ((14, 14, 1024), 256, 1024, 5),
               ((7, 7, 2048), 512, 2048, 2)]
# (C, O, k, stride, input side, calls per forward) of each distinct mode-conv
# layer of the flagships' batch-64 forwards
CONV2D = {
    "ResNet-18 batch 64": [(64, 64, 3, 1, 56, 4), (64, 128, 3, 2, 56, 1),
                           (128, 128, 3, 1, 28, 3), (64, 128, 1, 1, 28, 1),
                           (128, 256, 3, 2, 28, 1), (256, 256, 3, 1, 14, 3),
                           (128, 256, 1, 1, 14, 1), (256, 512, 3, 2, 14, 1),
                           (512, 512, 3, 1, 7, 3)],
    "ResNet-50 batch 64": [(64, 64, 1, 1, 56, 1), (64, 64, 3, 1, 56, 3),
                           (64, 256, 1, 1, 56, 4), (128, 128, 3, 2, 56, 1),
                           (128, 128, 3, 1, 28, 3), (128, 512, 1, 1, 28, 4),
                           (256, 256, 3, 2, 28, 1), (256, 256, 3, 1, 14, 5),
                           (512, 512, 3, 2, 14, 1), (512, 512, 3, 1, 7, 2)],
}
# fused_stem's x shapes: the serving batches at 224x224, then the geometries
# of the v2 and v1 entry points
STEMS = [(8, 224, 224, 3), (4, 224, 224, 3), (1, 224, 224, 3), (1, 224, 220, 3),
         (2, 200, 196, 3)]
CHAINS = {
    "ResNet-18 batch 1": (1, R18_STAGES),
    "ResNet-18 batch 4": (4, R18_STAGES),
    "ResNet-34 batch 1": (1, [((56, 64), ("basic",) * 3, 64, False),
                              ((56, 64), ("down",) + ("basic",) * 3, 128, False),
                              ((28, 128), ("down",) + ("basic",) * 5, 256, False)]),
    "path A batch 1": (1, R18_STAGES[1:]),
    "path A batch 4": (4, R18_STAGES[1:]),
}


def device_us(fn, name: str = "", iters: int = 20, per_call: int = 0) -> float:
    """Device us per call of ``fn``'s kernels whose name holds ``name``; with
    ``per_call``, a trace must hold that many such kernels per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and name in e.name]
        if per_call and len(us) != per_call * iters:
            print(f"gemm_shapes: a trace holds {len(us)} of {per_call * iters} "
                  f"{name} kernels; traced again", file=sys.stderr)
            continue
        if us:
            return sum(us) / iters
    raise RuntimeError("torch.profiler recorded no device time")


def event_us(fn, iters: int = 20) -> float:
    """Device us per call of ``fn`` between two CUDA events, warm."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return 1e3 * start.elapsed_time(end) / iters


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--label", default=os.path.basename(os.getcwd()))
    which = parser.add_mutually_exclusive_group()
    which.add_argument("--conv", action="store_true",
                       help="time binary_conv2d_s1 at path B's shapes instead")
    which.add_argument("--popcount", action="store_true",
                       help="time popcount_gemm at path C's shapes instead")
    which.add_argument("--chain", action="store_true",
                       help="time fused_chain at its serving calls instead")
    which.add_argument("--bottleneck", action="store_true",
                       help="time fused_bottleneck at ResNet-50's calls instead")
    which.add_argument("--stem", action="store_true",
                       help="time fused_stem and fused_stem_chain instead")
    which.add_argument("--blocks", action="store_true",
                       help="time fused_basic_block and fused_downsample_block "
                            "at ResNet-34 layer4's calls instead")
    which.add_argument("--conv2d", action="store_true",
                       help="time binary_conv2d at the flagships' batch-64 "
                            "mode-conv layers instead")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("gemm_shapes: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    from bnn_tpu_torch import kernels
    from bnn_tpu_torch.kernels import gemm

    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0])
    gen = torch.Generator().manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if args.conv:
        return time_convs(args.label, kernels, gen, dev, sms)
    if args.popcount:
        return time_popcounts(args.label, kernels, gen, dev, sms)
    if args.chain:
        return time_chains(args.label, kernels, gen, dev)
    if args.bottleneck:
        return time_bottlenecks(args.label, kernels, gen, dev)
    if args.stem:
        return time_stems(args.label, kernels, gen, dev)
    if args.blocks:
        return time_blocks(args.label, kernels, gen, dev)
    if args.conv2d:
        return time_conv2d(args.label, kernels, gen, dev)
    for path, shapes in PATHS.items():
        tot = {"kernel_us": 0.0, "int_mm_us": 0.0}
        for m, k, n, calls in shapes:
            x = torch.randint(-1, 2, (m, k), generator=gen).to(dev, torch.bfloat16)
            wp = kernels.pack_bits(torch.randn((k, n), generator=gen).to(dev), axis=-2)
            scale = (torch.rand(n, generator=gen) + 0.5).to(dev)
            add = torch.randn(n, generator=gen).to(dev)
            run = lambda: kernels.binary_gemm(x, wp, k, scale, add, sign_inputs=False)
            ref = kernels.binary_gemm_reference(x, wp, k, scale, add, sign_inputs=False)
            exact = bool(torch.equal(run(), ref))
            x8 = x.to(torch.int8)
            w8 = kernels.unpack_bits(wp, k, axis=-2, dtype=torch.int8)[:k].t().contiguous()
            plan = (gemm.gemm_plan(m, k, n, 2, x.data_ptr(), wp.data_ptr(), sms)
                    if hasattr(gemm, "gemm_plan") else None)
            row = {"label": args.label, "path": path, "m": m, "k": k, "n": n,
                   "calls": calls, "plan": plan, "exact": exact,
                   "kernel_us": device_us(run, "binary_gemm"),
                   "int_mm_us": device_us(lambda: torch._int_mm(x8, w8.t()))}
            print(json.dumps(row))
            if not exact:
                raise AssertionError(f"binary_gemm M={m} K={k} N={n} differs from "
                                     "its plain version")
            tot["kernel_us"] += calls * row["kernel_us"]
            tot["int_mm_us"] += calls * row["int_mm_us"]
        print(json.dumps({"label": args.label, "path": path,
                          "calls": sum(s[3] for s in shapes), **tot}))
    return 0


def time_convs(label, kernels, gen, dev, sms) -> int:
    """binary_conv2d_s1 at path B's (x shape, dtype) rows, beside F.conv2d."""
    from bnn_tpu_torch.kernels import conv

    implicit = getattr(conv, "binary_conv2d", None)
    tot = {"kernel_us": 0.0, "call_us": 0.0, "conv2d_us": 0.0}
    if implicit is not None:
        tot.update(implicit_kernel_us=0.0, implicit_call_us=0.0)
    for shape, dtype, calls in CONVS:
        c = o = shape[-1]
        x = torch.randn(shape, generator=gen)
        x[torch.rand(shape, generator=gen) < 0.1] = 0.0
        x = x.to(dev, dtype)
        w_oihw = torch.where(torch.randn((o, c, 3, 3), generator=gen) >= 0, 1, -1)
        w = w_oihw.to(dev, torch.int8).permute(2, 3, 1, 0)  # (k, k, C, O) view
        scale = (torch.rand(o, generator=gen) + 0.5).to(dev)
        add = torch.randn(o, generator=gen).to(dev)
        run = lambda: kernels.binary_conv2d_s1(x, w, scale, add)
        exact = bool(torch.equal(run(), kernels.binary_conv2d_s1_reference(
            x, w, scale, add)))
        xs = torch.where(x >= 0, 1.0, -1.0).to(torch.bfloat16).permute(0, 3, 1, 2)
        xs, wl = xs.contiguous(), w_oihw.to(dev, torch.bfloat16)
        plan = (conv.conv_plan(*shape, 3, o, x.element_size(), x.data_ptr(), sms)
                if hasattr(conv, "conv_plan") else None)
        row = {"label": label, "shape": shape, "dtype": str(dtype)[6:], "o": o,
               "calls": calls, "plan": plan, "exact": exact,
               "kernel_us": device_us(run, "binary_conv2d_s1_kernel"),
               "call_us": device_us(run),
               "conv2d_us": device_us(lambda: torch.nn.functional.conv2d(
                   xs, wl, padding=1))}
        if implicit is not None:
            # the same conv through binary_conv2d: sign(0) = +1 (zero_to_one),
            # f32 epilogue rows, the (O, C, k, k) int8 weights
            w8 = w_oihw.to(dev, torch.int8)
            run2 = lambda: implicit(x, w8, scale, add, stride=(1, 1), padding=(1, 1),
                                    zero_to_one=True)
            exact = exact and bool(torch.equal(run2(), run()))
            row.update(exact=exact, implicit_plan=conv.conv2d_plan(
                           shape[0] * shape[1] * shape[2], o, c, 9, x.element_size(),
                           x.data_ptr(), sms),
                       implicit_kernel_us=device_us(run2, "binary_conv2d_kernel"),
                       implicit_call_us=device_us(run2))
        print(json.dumps(row))
        if not exact:
            raise AssertionError(f"binary_conv2d_s1 {shape} {dtype} differs from "
                                 "its plain version or from binary_conv2d")
        for key in tot:
            tot[key] += calls * row[key]
    print(json.dumps({"label": label, "path": "path B batch 8",
                      "calls": sum(r[2] for r in CONVS), **tot}))
    return 0


def time_popcounts(label, kernels, gen, dev, sms) -> int:
    """popcount_gemm at path C's (M, K, N) rows at batch 8 and 1, beside
    torch._int_mm on the +/-1 product."""
    from collections import Counter

    from bnn_tpu_torch.kernels import gemm
    from chip_smoke import r50_pointwise

    for batch in (8, 1):
        tot = {"kernel_us": 0.0, "int_mm_us": 0.0}
        shapes = sorted(Counter(r50_pointwise(batch)).items())
        for (m, k, n), calls in shapes:
            x = torch.randn((m, k), generator=gen)
            x[torch.rand((m, k), generator=gen) < 0.1] = 0.0
            xp = kernels.pack_bits(x.to(dev), axis=-1)
            wp = kernels.pack_bits(torch.randn((k, n), generator=gen).to(dev), axis=-2)
            scale = (torch.rand(n, generator=gen) + 0.5).to(dev)
            add = torch.randn(n, generator=gen).to(dev)
            run = lambda: kernels.popcount_gemm(xp, wp, k, scale, add)
            exact = bool(torch.equal(run(), kernels.popcount_gemm_reference(
                xp, wp, k, scale, add)))
            x8 = kernels.unpack_bits(xp, k, axis=-1, dtype=torch.int8)[:, :k].contiguous()
            w8 = kernels.unpack_bits(wp, k, axis=-2, dtype=torch.int8)[:k].t().contiguous()
            plan = (gemm.popcount_plan(m, xp.shape[1], n, xp.data_ptr(), wp.data_ptr(),
                                       sms) if hasattr(gemm, "popcount_plan") else None)
            row = {"label": label, "path": f"path C batch {batch}", "m": m, "k": k,
                   "n": n, "calls": calls, "plan": plan, "exact": exact,
                   "kernel_us": device_us(run, "popcount_gemm_kernel"),
                   "int_mm_us": device_us(lambda: torch._int_mm(x8, w8.t()))}
            print(json.dumps(row))
            if not exact:
                raise AssertionError(f"popcount_gemm M={m} K={k} N={n} differs from "
                                     "its plain version")
            tot["kernel_us"] += calls * row["kernel_us"]
            tot["int_mm_us"] += calls * row["int_mm_us"]
        print(json.dumps({"label": label, "path": f"path C batch {batch}",
                          "calls": sum(c for _, c in shapes), **tot}))
    return 0


def time_chains(label, kernels, gen, dev) -> int:
    """fused_chain at each path's calls, beside each call's bound."""
    from chip_smoke import chain_bound, check_exact, rand_block

    bf = torch.bfloat16
    opts = dict(act="relu", pre=False, zero_to_one=False)
    for path, (n, stages) in CHAINS.items():
        tot = {"kernel_us": 0.0, "bound_us": 0.0}
        for (h, ci), plan, co, head in stages:
            blocks, c = [], ci
            for kind in plan:
                blocks.append(rand_block(kernels, kind, c, co, gen, dev, bf,
                                         options=False))
                c = co
            x = torch.randn((n, h, h, ci), generator=gen).to(dev, bf)
            args = (x, blocks)
            if head:
                args += ((torch.randn((co, 1000), generator=gen) / co ** 0.5).to(dev, bf),
                         (0.1 * torch.randn(1000, generator=gen)).to(dev, bf))
            run = lambda: kernels.fused_chain(*args, **opts)
            got = run()
            name = f"fused_chain {'+'.join(plan)}{'+head' if head else ''} {tuple(x.shape)}"
            check_exact(f"{label} {path} {name}", got,
                        kernels.fused_chain_reference(*args, **opts), head,
                        verbose=False)
            bound, by = chain_bound(x, blocks, *(args[2:] if head else (None, None)),
                                    got.numel(), got.element_size())
            row = {"label": label, "path": path, "call": name, "exact": True,
                   "kernel_us": device_us(run, "fused_chain_kernel", per_call=1),
                   "bound_us": bound * 1e3, "bound_by": by}
            print(json.dumps(row))
            tot["kernel_us"] += row["kernel_us"]
            tot["bound_us"] += row["bound_us"]
        print(json.dumps({"label": label, "path": path, "calls": len(stages), **tot}))
    return 0


def time_bottlenecks(label, kernels, gen, dev) -> int:
    """fused_bottleneck at ResNet-50's batch-1 and batch-4 calls, beside each
    call's bound."""
    from chip_smoke import bottleneck_bound, check_exact, rand_bottleneck

    bf = torch.bfloat16
    for n in (1, 4):
        path = f"ResNet-50 batch {n}"
        tot = {"kernel_us": 0.0, "bound_us": 0.0}
        for (h, w, c), width, cout, calls in BOTTLENECKS:
            w1, w2, w3, kw = rand_bottleneck(c, width, cout, gen, dev, bf, prelu=False,
                                             thresholds=False)
            x = torch.randn((n, h, w, c), generator=gen).to(dev, bf)
            opts = dict(act="relu", zero_to_one=False)
            run = lambda: kernels.fused_bottleneck(x, w1, w2, w3, **kw, **opts)
            name = f"fused_bottleneck {tuple(x.shape)} width {width} -> {cout}"
            check_exact(f"{label} {path} {name}", run(),
                        kernels.fused_bottleneck_reference(x, w1, w2, w3, **kw, **opts),
                        False, verbose=False)
            rows = {k: v for k, v in kw.items() if k != "wd"}
            desc = kernels.BottleneckDesc(c, w1, w2, w3, kw.get("wd"), rows)
            bound, by = bottleneck_bound(x, desc)
            row = {"label": label, "path": path, "call": name, "calls": calls,
                   "exact": True,
                   "plan": desc.plan(x) if hasattr(desc, "plan") else None,
                   "kernel_us": device_us(run, "fused_bottleneck_kernel", per_call=1),
                   "bound_us": bound * 1e3, "bound_by": by}
            print(json.dumps(row))
            tot["kernel_us"] += calls * row["kernel_us"]
            tot["bound_us"] += calls * row["bound_us"]
        print(json.dumps({"label": label, "path": path,
                          "calls": sum(b[3] for b in BOTTLENECKS), **tot}))
    return 0


def time_stems(label, kernels, gen, dev) -> int:
    """fused_stem at STEMS and fused_stem_chain at batch 1 and 4, through
    their public calls, beside cuDNN and the bounds."""
    from chip_smoke import PEAK_OPS_PER_S, bf16_ulp, rand_block, stem_chain_bound

    bf = torch.bfloat16
    ws = (0.1 * torch.randn((7, 7, 3, 64), generator=gen)).to(dev, bf)
    bs = (0.1 * torch.randn(64, generator=gen)).to(dev, bf)
    wn = ws.permute(3, 2, 0, 1).contiguous()
    desc = kernels.StemDesc(ws, bs) if hasattr(kernels, "StemDesc") else None
    for shape in STEMS:
        n, h, w, c = shape
        x = torch.randn(shape, generator=gen).to(dev, bf)
        xn = x.permute(0, 3, 1, 2).contiguous()
        run = lambda: kernels.fused_stem(x, ws, bs)
        got, ref = run().float(), kernels.fused_stem_reference(x.float(), ws, bs)
        ok = bool(((got - ref).abs() <= bf16_ulp(ref) + 1e-5).all())
        ops = 2 * n * (h // 2) * (w // 2) * 64 * 49 * c
        moved = x.numel() * 2 + ws.numel() * 2 + bs.numel() * 2 + got.numel() * 2
        bound_us = max(ops / PEAK_OPS_PER_S[bf], moved / 3.35e12) * 1e6
        row = {"label": label, "call": f"fused_stem {shape} bf16", "ok": ok,
               "plan": desc.plan(x) if desc is not None else None,
               "kernel_us": device_us(run, "fused_stem_kernel", per_call=1),
               "call_us": device_us(run),
               "cudnn_3_calls_us": device_us(lambda: torch.nn.functional.max_pool2d(
                   torch.relu(torch.nn.functional.conv2d(xn, wn, bs, 2, 3)), 3, 2, 1)),
               "bound_us": bound_us}
        print(json.dumps(row))
        if not ok:
            raise AssertionError(f"fused_stem {shape} is off its plain version")
    opts = dict(act="relu", zero_to_one=False)
    for n in (1, 4):
        x = torch.randn((n, 224, 224, 3), generator=gen).to(dev, bf)
        blocks = [rand_block(kernels, "basic", 64, 64, gen, dev, bf, options=False)
                  for _ in range(2)]
        run = lambda: kernels.fused_stem_chain(x, ws, bs, blocks, **opts)
        split = lambda: kernels.fused_chain(kernels.fused_stem(x, ws, bs), blocks, **opts)
        got = run()
        exact = bool(torch.equal(got, split()))
        planner = getattr(kernels.model, "fused_stem_chain_plan", None)
        bound, by = stem_chain_bound(x, ws, bs, blocks, got.numel(), got.element_size())
        row = {"label": label, "call": f"fused_stem_chain ({n}, 224, 224, 3) bf16",
               "exact": exact,
               "plan": planner(x, desc) if planner is not None else None,
               "kernel_us": device_us(run, "fused_stem_chain_kernel", per_call=1),
               "split_kernels_us": (device_us(split, "fused_stem_kernel", per_call=1)
                                    + device_us(split, "fused_chain_kernel", per_call=1)),
               "bound_us": bound * 1e3, "bound_by": by}
        print(json.dumps(row))
        if not exact:
            raise AssertionError(f"fused_stem_chain batch {n} differs from "
                                 "fused_chain(fused_stem(x))")
    return 0


def block_bound(kname, args, kw, bound_ms):
    """``(ms, 'bytes' or 'operations')``: the least time of a
    ``fused_basic_block`` or ``fused_downsample_block`` call on these
    arguments: x, the weights and the rows read once (conv1's weights as
    their 9*Ci*Co int8 taps; a down block's come in the s2d form, which pads
    7*Ci*Co zeros) and the output written once, against the int8
    operations, through ``bound_ms(bytes, ops, torch.int8)`` (chip_smoke's,
    with the card's rates)."""
    xh = args[0]
    n, h, w, ci = xh.shape
    co = args[2].shape[-1]
    if kname == "fused_downsample_block":
        out_numel = n * (h // 2) * (w // 2) * co
        ops = 2 * out_numel * (9 * ci + 9 * co + ci)
    else:
        out_numel = n * h * w * co
        ops = 2 * 2 * out_numel * 9 * ci
    params = [a for a in args[2:] if isinstance(a, torch.Tensor)]
    params += [v for v in kw.values() if isinstance(v, torch.Tensor)]
    moved = (sum(t.numel() * t.element_size() for t in [xh] + params)
             + 9 * ci * co + out_numel * xh.element_size())
    return bound_ms(moved, ops, torch.int8)


def time_blocks(label, kernels, gen, dev) -> int:
    """ResNet-34 layer4's fused_basic_block and fused_downsample_block calls
    at batch 1, each held against its plain version and timed beside its
    bound, with its launch plan where the checkout reports it."""
    from chip_smoke import bound_ms, check_exact, rand_block

    bf = torch.bfloat16
    opts = dict(act="relu", pre=False, zero_to_one=False)
    calls = []  # (kernel, call name, args)
    d = rand_block(kernels, "down", 256, 512, gen, dev, bf, options=False)
    p = d.po
    calls.append(("fused_downsample_block", "fused_downsample_block (1, 14, 14, 256) -> 512",
                  (torch.randn((1, 14, 14, 256), generator=gen).to(dev, bf), d.w1,
                   d.w2.reshape(3, 3, 512, 512), d.wd, p[0], p[1], p[3], p[4], p[6], p[7])))
    for i in (1, 2):
        b = rand_block(kernels, "basic", 512, 512, gen, dev, bf, options=False)
        p = b.prm
        calls.append(("fused_basic_block", f"fused_basic_block (1, 7, 7, 512) layer4.{i}",
                      (torch.randn((1, 7, 7, 512), generator=gen).to(dev, bf),
                       b.w1.reshape(3, 3, 512, 512), b.w2.reshape(3, 3, 512, 512),
                       p[0], p[1], p[3], p[4])))
    planners = {  # the launch plans the checkout reports
        "fused_basic_block": getattr(kernels.block, "fused_basic_block_plan", None),
        "fused_downsample_block": getattr(kernels.strided_block,
                                          "fused_downsample_block_plan", None)}
    tot = {}
    for kname, name, args in calls:
        fn = getattr(kernels, kname)
        err = check_exact(f"{label} {name}", fn(*args, **opts),
                          getattr(kernels, kname + "_reference")(*args, **opts),
                          False, verbose=False)
        bound, by = block_bound(kname, args, opts, bound_ms)
        planner = planners[kname]
        row = {"label": label, "call": name,
               "plan": (None if planner is None else planner(args[0]) if
                        kname == "fused_basic_block" else planner(args[0], args[2].shape[-1])),
               "max_abs_err": err,
               "kernel_us": device_us(lambda: fn(*args, **opts), kname + "_kernel",
                                      per_call=1),
               "bound_us": bound * 1e3, "bound_by": by}
        print(json.dumps(row))
        t = tot.setdefault(kname, {"kernel_us": 0.0, "bound_us": 0.0, "calls": 0})
        t["kernel_us"] += row["kernel_us"]
        t["bound_us"] += row["bound_us"]
        t["calls"] += 1
    for kname, t in tot.items():
        print(json.dumps({"label": label, "kernel": kname, **t}))
    return 0



def time_conv2d(label, kernels, gen, dev) -> int:
    """binary_conv2d at the flagships' batch-64 mode-conv layers, beside its
    plain version (the unfold + torch._int_mm chain) and its bound."""
    from bnn_tpu_torch.kernels import conv
    from portbench.roofline import call_bound_s

    batch = 64
    kernel = getattr(conv, "binary_conv2d", None)
    for path, layers in CONV2D.items():
        tot = {"kernel_us": 0.0, "call_us": 0.0, "plain_us": 0.0, "bound_us": 0.0}
        for c, o, k, stride, side, calls in layers:
            x = torch.randn((batch, side, side, c), generator=gen)
            x[torch.rand(x.shape, generator=gen) < 0.1] = 0.0
            x = x.to(dev, torch.bfloat16)
            w8 = torch.where(torch.randn((o, c, k, k), generator=gen) >= 0, 1, -1).to(
                dev, torch.int8)
            wp = kernels.pack_bits(w8.float(), axis=1)
            scale = (torch.rand(o, generator=gen) + 0.5).to(dev, torch.bfloat16)
            add = torch.randn(o, generator=gen).to(dev, torch.bfloat16)
            st, pad = (stride, stride), (k // 2, k // 2)
            xn = x.permute(0, 3, 1, 2)
            plain = lambda: conv.binary_conv2d_reference(xn, w8, scale, add, stride=st,
                                                         padding=pad)
            out = (side + 2 * pad[0] - k) // stride + 1
            layer = {"kind": "binary", "cin": c, "cout": o, "k": k,
                     "macs": out * out * o * c * k * k}
            row = {"label": label, "path": path, "c": c, "o": o, "k": k,
                   "stride": stride, "side": side, "calls": calls,
                   "bound_us": 1e6 * call_bound_s([layer], batch, c * side * side,
                                                  o * out * out, "bfloat16"),
                   "plain_us": device_us(plain)}
            if kernel is not None:
                run = lambda: kernel(x, wp, scale, add, stride=st, padding=pad)
                exact = bool(torch.equal(run(), plain().permute(0, 2, 3, 1)))
                row.update(plan=conv.conv2d_plan(batch * out * out, o, c, k * k, 2, x.data_ptr()),
                           exact=exact,
                           kernel_us=device_us(run, "binary_conv2d_kernel", per_call=1),
                           call_us=device_us(run),
                           tiles={f"{t[0]}x{t[1]}": event_us(
                               lambda t=t: conv.binary_conv2d_planned(
                                   x, wp, None, scale, add, st, pad, False,
                                   plan=(t, "vector")))
                               for t in conv.CONV2D_TILES if t[1] <= max(o, 64)})
                if not exact:
                    raise AssertionError(f"binary_conv2d {row} differs from its plain "
                                         "version")
            print(json.dumps(row))
            for key in tot:
                tot[key] += calls * row.get(key, 0.0)
        print(json.dumps({"label": label, "path": path,
                          "calls": sum(r[-1] for r in layers), **tot}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

