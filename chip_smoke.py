#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``bnn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. device and build: the card's name and power limit, then both CUDA
   kernels built from ``bnn_tpu_torch/csrc`` (one ``nvcc`` each, in
   parallel);
2. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes and at the other geometries its entry points take;
3. the serving path: the flagship binary ResNet-18 (1000 classes, weights
   and BN statistics random from a seed) through ``Predictor(batch_size=8)``
   in bf16 at 224x224, for requests of 8, 3 and 13 images (4 forwards),
   with every kernel's launch count read around that run; then the same
   weights in f32 on the card against the plain versions on the CPU;
4. times: each kernel's device time (torch.profiler) and time per call
   (CUDA events), beside its plain version's, its bound and the one-call
   PyTorch yardstick where there is one; the forward latency, images/s,
   device busy share and the kernels that take the time, at batch 8;
5. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}`` as
   the last line.

Exits non-zero, printing no result, when CUDA is unavailable or any phase
fails. Imports nothing of JAX.
"""
from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {            # dense tensor-core peaks, NVIDIA data sheet
    torch.bfloat16: 989e12,
    torch.int8: 1979e12,
}
SEED = 0
BATCH = 8
SIZE = 224


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: int, ops: int, op_dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[op_dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, iters: int = 20):
    """``({kernel name: device ms per call}, wall ms per call)`` of ``fn``
    over ``iters`` calls under ``torch.profiler``, after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / iters)
    if not by_name:
        raise RuntimeError("torch.profiler recorded no device time")
    return by_name, wall / iters * 1e3


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call of ``fn``: the sum of its kernels' durations."""
    return sum(device_profile(fn, iters)[0].values())


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |v| (8 significant bits)."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def check_stem(kernels, shape, gen, dev) -> float:
    """The stem kernel at ``shape`` in bf16 against the plain version
    computed in f32 from the same bf16 inputs: within one bf16 ulp, plus
    1e-5 absolute for the f32 sums' own rounding next to zero."""
    n, h, w, c = shape
    x = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
    wk = (0.1 * torch.randn((7, 7, c, 64), generator=gen)).to(dev, torch.bfloat16)
    b = (0.1 * torch.randn(64, generator=gen)).to(dev)
    got = kernels.fused_stem(x, wk, b).float()
    ref = kernels.fused_stem_reference(x.float(), wk, b)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    ulps = (err / bf16_ulp(ref)).max().item()
    if not bool((err <= bf16_ulp(ref) + 1e-5).all()):
        raise AssertionError(f"fused_stem {shape}: {ulps:.2f} bf16 ulp off")
    print(f"phase 2: fused_stem {tuple(shape)} bf16 -> {tuple(got.shape)}: "
          f"max |err| {err.max().item():.3g} ({ulps:.2f} bf16 ulp)")
    return err.max().item()


def check_gemm(kernels, m, k, n, dtype, sign_inputs, gen, dev) -> float:
    """binary_gemm against its plain version: within 1e-6 relative."""
    if sign_inputs:
        x = torch.randn((m, k), generator=gen)
        x[torch.rand((m, k), generator=gen) < 0.1] = 0.0  # exact zeros
    else:
        x = torch.randint(-1, 2, (m, k), generator=gen).float()
    x = x.to(dev, dtype)
    wp = kernels.pack_bits(torch.randn((k, n), generator=gen).to(dev), axis=-2)
    scale = torch.rand(n, generator=gen).to(dev) + 0.5
    add = torch.randn(n, generator=gen).to(dev)
    got = kernels.binary_gemm(x, wp, k, scale, add, sign_inputs=sign_inputs)
    ref = kernels.binary_gemm_reference(x, wp, k, scale, add,
                                        sign_inputs=sign_inputs)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    if not bool((err <= 1e-6 * ref.abs() + 1e-6).all()):
        raise AssertionError(f"binary_gemm ({m},{k},{n}): max |err| "
                             f"{err.max().item()}")
    print(f"phase 2: binary_gemm M={m} K={k} N={n} {dtype} "
          f"sign_inputs={sign_inputs}: max |err| {err.max().item():.3g}")
    return err.max().item()


def flagship(gen: torch.Generator):
    """The flagship QAT ResNet-18: binary body, float first and last layers,
    torch-parity ternary sign; BN statistics and output scales random so
    that every folded ``add`` is non-zero."""
    import bnn_tpu_torch as bt
    from bnn_tpu_torch.ops import (BasicInputBinarizer, BasicScaleBinarizer,
                                   XNORWeightBinarizer)

    model = bt.models.resnet18(num_classes=1000, generator=gen)
    model = bt.prepare_binary_model(
        model,
        bt.BConfig(activation_pre_process=BasicInputBinarizer,
                   activation_post_process=BasicScaleBinarizer,
                   weight_pre_process=XNORWeightBinarizer),
        ignore_layers_name=["_first_", "_last_"])
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(0.3 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.5 + 1.5 * torch.rand(c, generator=gen))
                m.weight.copy_(1.0 + 0.3 * torch.randn(c, generator=gen))
                m.bias.copy_(0.3 * torch.randn(c, generator=gen))
            elif isinstance(m, BasicScaleBinarizer):
                m.alpha.copy_(0.5 + torch.rand(m.alpha.shape, generator=gen))
    return model.eval()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "measures the port on a GPU and has nothing to run here",
              file=sys.stderr)
        return 1
    from bnn_tpu_torch import kernels
    from bnn_tpu_torch.inference import Predictor
    from bnn_tpu_torch.kernels import _build

    # every comparison below is against f32 arithmetic
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"phase 1: {kind} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    build_s = _build.build()
    print(f"phase 1: built {', '.join(_build.SOURCES)} in {build_s:.1f} s")
    for log in sorted(_build.BUILD_DIR.glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"phase 1: {log.name.split('-')[0]}: {line.strip()}")

    gen = torch.Generator().manual_seed(SEED)
    gemm_err = check_gemm(kernels, BATCH * 7 * 7, 256, 512, torch.bfloat16,
                          False, gen, dev)
    check_gemm(kernels, 37, 77, 65, torch.float32, True, gen, dev)
    check_gemm(kernels, 37, 300, 65, torch.bfloat16, True, gen, dev)
    stem_err = check_stem(kernels, (BATCH, SIZE, SIZE, 3), gen, dev)  # v3
    check_stem(kernels, (1, SIZE, SIZE - 4, 3), gen, dev)     # v2: B=1, W%8
    check_stem(kernels, (2, 200, 196, 3), gen, dev)           # v1: H%16

    qat = flagship(torch.Generator().manual_seed(SEED))
    pred = Predictor(copy.deepcopy(qat), batch_size=BATCH)
    images = torch.randn((24, 3, SIZE, SIZE), generator=gen)
    requests = (images[:8], images[8:11], images[11:24])
    kernels.binary_gemm.launches = 0
    kernels.fused_stem.launches = 0
    outs = [pred(r) for r in requests]
    torch.cuda.synchronize()
    launches = {"binary_gemm": kernels.binary_gemm.launches,
                "fused_stem": kernels.fused_stem.launches}
    for r, o in zip(requests, outs):
        if o.shape != (r.shape[0], 1000) or not bool(torch.isfinite(o).all()):
            raise AssertionError(f"bad output {tuple(o.shape)} for a request "
                                 f"of {r.shape[0]}")
    if launches != {"binary_gemm": 4, "fused_stem": 4}:
        raise AssertionError(f"expected 4 launches of each kernel in 4 "
                             f"forwards, got {launches}")
    print(f"phase 3: served 24 images as requests of 8, 3, 13 in bf16: "
          f"logits {[tuple(o.shape) for o in outs]}, launches {launches}")

    gpu32 = Predictor(copy.deepcopy(qat), batch_size=BATCH, dtype=None)
    cpu32 = Predictor(copy.deepcopy(qat), batch_size=BATCH, dtype=None,
                      device="cpu")
    got = gpu32(images[:BATCH]).cpu()
    ref = cpu32(images[:BATCH])
    torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-3)
    bf16_gap = (outs[0].float().cpu() - ref).abs().max().item()
    print(f"phase 3: f32 on the card vs plain versions on the CPU, batch 8: "
          f"max |diff| {(got - ref).abs().max().item():.3g} (limit 1e-3), "
          f"argmax equal {bool((got.argmax(1) == ref.argmax(1)).all())}; "
          f"bf16 serving vs f32 CPU max |diff| {bf16_gap:.3g}")

    # times at the serving path's shapes
    m, k, n = BATCH * 7 * 7, 256, 512
    xg = torch.randint(-1, 2, (m, k), generator=gen).to(dev, torch.bfloat16)
    wg = torch.randn((k, n), generator=gen).to(dev)
    wp = kernels.pack_bits(wg, axis=-2)
    sc = torch.rand(n, generator=gen).to(dev) + 0.5
    ad = torch.randn(n, generator=gen).to(dev)
    x8 = xg.to(torch.int8)
    w8 = torch.where(wg >= 0, 1, -1).to(torch.int8).t().contiguous()  # (N, K)
    def gemm():
        return kernels.binary_gemm(xg, wp, k, sc, ad, sign_inputs=False)

    def gemm_plain():
        return kernels.binary_gemm_reference(xg, wp, k, sc, ad, sign_inputs=False)

    def gemm_lib():
        return torch._int_mm(x8, w8.t())

    gemm_t = {f.__name__: (device_ms(f), cuda_ms(f)) for f in (gemm, gemm_plain, gemm_lib)}
    gemm_bound, gemm_by = bound_ms(nbytes(xg, wp, sc, ad) + m * n * 4,
                                   2 * m * k * n, torch.int8)

    xs = torch.randn((BATCH, SIZE, SIZE, 3), generator=gen).to(dev, torch.bfloat16)
    ws = (0.1 * torch.randn((7, 7, 3, 64), generator=gen)).to(dev, torch.bfloat16)
    bs = (0.1 * torch.randn(64, generator=gen)).to(dev, torch.bfloat16)
    xn, wn = xs.permute(0, 3, 1, 2).contiguous(), ws.permute(3, 2, 0, 1).contiguous()

    def stem():
        return kernels.fused_stem(xs, ws, bs)

    def stem_plain():
        return kernels.fused_stem_reference(xs, ws, bs)

    def stem_cudnn_3_calls():
        return torch.nn.functional.max_pool2d(
            torch.relu(torch.nn.functional.conv2d(xn, wn, bs, 2, 3)), 3, 2, 1)

    stem_t = {f.__name__: (device_ms(f), cuda_ms(f))
              for f in (stem, stem_plain, stem_cudnn_3_calls)}
    stem_out = BATCH * (SIZE // 4) * (SIZE // 4) * 64 * 2
    stem_bound, stem_by = bound_ms(
        nbytes(xs, ws, bs) + stem_out,
        2 * BATCH * (SIZE // 2) * (SIZE // 2) * 64 * 7 * 7 * 3, torch.bfloat16)
    timed = [(f"binary_gemm M={m} K={k} N={n} bf16", gemm_t, gemm_bound, gemm_by),
             (f"fused_stem ({BATCH},{SIZE},{SIZE},3) bf16", stem_t, stem_bound, stem_by)]
    # the geometries of the v2 and v1 entry points, which the same kernel serves
    for shape in ((1, SIZE, SIZE - 4, 3), (2, 200, 196, 3)):
        xo = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
        t = {"stem": (device_ms(lambda: kernels.fused_stem(xo, ws, bs)),
                      cuda_ms(lambda: kernels.fused_stem(xo, ws, bs))),
             "stem_plain": (device_ms(lambda: kernels.fused_stem_reference(xo, ws, bs)),
                            cuda_ms(lambda: kernels.fused_stem_reference(xo, ws, bs)))}
        nb, h, w, _ = shape
        timed.append((f"fused_stem {shape} bf16", t, *bound_ms(
            nbytes(xo, ws, bs) + nb * (h // 4) * (w // 4) * 64 * 2,
            2 * nb * (h // 2) * (w // 2) * 64 * 7 * 7 * 3, torch.bfloat16)))
    for name, times, bound, by in timed:
        parts = ", ".join(f"{f} {d * 1e3:.2f} us device / {c * 1e3:.2f} us per call"
                          for f, (d, c) in times.items())
        print(f"phase 4: {name}: {parts}; bound {bound * 1e3:.3f} us ({by}) | {card}")

    xb = images[:BATCH].to(dev)
    for _ in range(3):
        pred(xb)
    torch.cuda.synchronize()
    iters = 20
    t0 = time.perf_counter()
    for _ in range(iters):
        pred(xb)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) / iters * 1e3
    by_kernel, _ = device_profile(lambda: pred(xb), iters=10)
    busy = sum(by_kernel.values())
    print(f"phase 4: Predictor forward at batch {BATCH}, bf16, {SIZE}x{SIZE}: "
          f"{fwd_ms:.3f} ms, {BATCH / fwd_ms * 1e3:.1f} images/s; device busy "
          f"{busy:.3f} ms per forward ({100 * busy / fwd_ms:.1f}% of the "
          f"latency) | {card}")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]:
        print(f"phase 4:   {ms * 1e3:9.2f} us  {name[:100]}")

    print(json.dumps({"kernels": [
        {"name": "binary_gemm", "route": "cuda",
         "source": "bnn_tpu_torch/csrc/binary_gemm.cu",
         "replaces": "bnn_tpu/kernels/gemm.py:96",
         "launches": launches["binary_gemm"], "max_abs_err": gemm_err,
         "ms": gemm_t["gemm"][0], "plain_ms": gemm_t["gemm_plain"][0],
         "bound_ms": gemm_bound, "bound_by": gemm_by,
         "library_ms": gemm_t["gemm_lib"][0]},
        {"name": "fused_stem", "route": "cuda",
         "source": "bnn_tpu_torch/csrc/fused_stem.cu",
         "replaces": "bnn_tpu/kernels/stem.py:510",
         "launches": launches["fused_stem"], "max_abs_err": stem_err,
         "ms": stem_t["stem"][0], "plain_ms": stem_t["stem_plain"][0],
         "bound_ms": stem_bound, "bound_by": stem_by, "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
