#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``bnn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --quick    # phases 1 and 2 only, no result lines
    cd <checkout> && python3 <path to>/chip_smoke.py --forwards
                                     # the checkout's live forwards, timed
    python3 chip_smoke.py --zoo      # phases 1 and 8 only, no result lines
    python3 chip_smoke.py --trainer  # phases 1 and 9 only, no result lines
    python3 chip_smoke.py --parallel # phases 1 and 10 only, no result lines
    python3 chip_smoke.py --cli      # phases 1 and 11 only, no result lines
    python3 chip_smoke.py --plain    # phases 1 and 12 only, no result lines
    python3 chip_smoke.py --gloo-probe
                                     # which gloo collectives take CUDA tensors

Phases, each reported on its own lines:

1. device and build: the card's name and power limit, then every CUDA
   kernel built from ``bnn_tpu_torch/csrc`` (one ``nvcc`` each, in parallel),
   and the tensor-core, dot-product and popcount instructions (and all
   instructions) in the SASS of the four GEMM-shaped kernels, the five
   block kernels and the stem
   (``fused_chain``, ``fused_bottleneck``, ``fused_basic_block``,
   ``fused_downsample_block``, ``fused_stem_chain`` and ``binary_conv2d``
   must show int8 tensor-core and no ``__dp4a`` instructions, ``fused_stem`` and
   ``fused_stem_chain`` bf16 tensor-core instructions);
2. each kernel against its plain PyTorch version on the card, at the
   serving paths' shapes and at the other geometries and options its entry
   points take; the stem at its three entry points' geometries in bf16, with
   f32 weights (3 passes) and in f32 (6 passes), through ``fused_stem_v2``
   at (1, 224, 220, 3) and ``fused_stem_v3`` at batch 8 and 1, bf16 x
   stored as f32 by the kernel (``out_dtype``) through all three entry
   points, and each entry point's refusal of a shape outside its scope;
   ``fused_chain`` at each of ResNet-18's four stage shapes at
   batch 1 and 4, in bf16 and f32 with both option sets, and at widths that
   its word loader takes (C % 16 != 0), as ``fused_basic_block``,
   ``fused_downsample_block`` (20 -> 40 channels, and at ResNet-34's
   layer4.0 shape at batch 1 and 4) and ``fused_stem_chain`` (layer1 20
   channels wide); ``fused_stem_chain``
   bit-identical to ``fused_chain(fused_stem(x))``; ``fused_bottleneck`` at ResNet-50's
   shapes, odd H and W, and widths where some of its GEMMs take the word
   loader and others the 16-byte one; ``binary_gemm`` bit for bit at each
   of its tile and loader instances and at ragged shapes, each case naming
   the instance it took;
   ``binary_conv2d_s1`` bit for bit at each of its tile, loader and K-split
   instances, at path B's shapes and at edges (N = 1, k = 1, 5 and 7, odd H
   and W, C and O off every multiple, x off 16 bytes, exact zeros);
   ``popcount_gemm`` bit for bit through its host plan and at each of its
   tile, loader and K-split instances, at path C's shapes (batch 8 and 1)
   and at edges (K = 1, K = 33 and 100, KW odd, N off 4, x off 8 and 16
   bytes); ``binary_conv2d`` bit for bit against
   ``binary_conv2d_reference`` through its host plan and at each of its tile
   and loader instances, at each distinct mode-conv layer of ResNet-18 and
   ResNet-50 at batch 8 (bf16, ternary signs against a threshold) and at
   edges (f32 and ``zero_to_one``, int8 and packed weights, N = 1 and 3,
   odd H and W, C and O off every multiple, k = 1 at stride 2, k = 5, x off
   16 bytes); each kernel refuses a plan its operands cannot take;
3. the serving paths, with every kernel's launch count set to 0 just
   before each and read just after: the flagship binary ResNet-18 (1000
   classes, weights and BN statistics random from a seed) through
   ``Predictor(batch_size=8)`` in bf16 at 224x224 for requests of 8, 3 and 13
   images (4 forwards; the stages fall back to the deployed convs, 18 on
   ``binary_conv2d``), through ``Predictor(batch_size=1)`` and
   ``batch_size=4`` (stem and stage kernels), ResNet-34 through
   ``Predictor(batch_size=1)`` (stage kernels for layers 1-3, block kernels
   for layer4), and ResNet-50 through ``Predictor(batch_size=1)``, ``4``
   (stem, 13 ``fused_bottleneck``, the strided blocks on deployed convs:
   8 ``binary_gemm`` and 4 ``binary_conv2d``) and ``8`` (deployed convs: 27
   and 25); then the same weights in f32 on the card against
   the plain versions on the CPU; then the three opt-in paths: (A) the
   ResNet-18 predictors of batch 1 and 4 after ``fuse_entry`` (the stem and
   layer1 as one ``fused_stem_chain``), (B) a Z1-PReLU ResNet-18 (zero_to_one
   signs, PReLU) deployed with its stride-1 3x3 convs in mode
   ``pallas-conv`` (``binary_conv2d_s1``) at batch 8, (C) a Z1-PReLU
   ResNet-50 through ``Predictor(binary_gemm_impl="popcount")`` at batch 8
   and 1 (``popcount_gemm``);
4. every residual-block kernel call of the batch 1 and 4 serving paths
   (ResNet-18, ResNet-34 and ResNet-50), and every call of the three
   opt-in paths' kernels, captured with its own inputs and held against its
   plain version as in phase 2, every ``binary_conv2d`` call of ResNet-18 at
   batch 8, ResNet-50 at batch 1, 4 and 8 and paths B and C through its host
   plan and every instance, with ``fused_bottleneck``'s launch plan
   (tiles and K slices of each GEMM) at ResNet-50's 13 batch-4 calls and
   ``fused_basic_block``'s, ``fused_downsample_block``'s and
   ``fused_stem_chain``'s grids; then
   times (the stem at batch 1, 4 and 8 and the v1 and v2 geometries, with
   its launch plan, beside cuDNN's conv + relu + max_pool): each kernel's
   device time
   (torch.profiler) and time per call (CUDA events) at the shapes the
   serving paths gave it, beside its plain version's, its bound and the
   one-call PyTorch yardstick where there is one (for ``binary_gemm``, a
   table per distinct shape of ResNet-50's batch 1 and 8 calls and
   ResNet-18's batch 8 call, with the host's tile; for ``binary_conv2d_s1``,
   one per distinct shape of path B's calls, the host's plan beside the
   other tiles and splits; for ``popcount_gemm``, the same per distinct
   shape of path C's calls at batch 8 and at batch 1; for ``binary_conv2d``,
   one per distinct shape of ResNet-18's and ResNet-50's batch-8 calls, the
   host's plan beside the plain version, the unfold + ``torch._int_mm``
   chain); the forward latency,
   images/s, device busy share and the kernels that take the time, of each
   path; ``fused_chain``'s four ResNet-18 stages and ``fused_bottleneck``'s
   13 ResNet-50 calls summed at batch 1 and 4, beside their bounds;
5. QAT training of the flagship at full width (1000 classes, 224x224,
   AdamW 1e-3, weight decay 1e-4) through ``parallel.make_train_step``: the
   first step of the all-Identity config at batch 8 on the card against
   the CPU's (f32: loss 1e-4 relative; float64: loss and each parameter
   1e-4 relative L2); the
   binary flagship's layer1.0 and layer2.0 train-mode gradients on the card
   against the CPU's (input 1e-4, each parameter 2e-2); remat's first step
   against the plain one (bf16, batch 256, cuDNN deterministic, 1e-6); five
   cases on one fixed batch each, (a) f32 batch 64 (cuDNN deterministic, so
   that its trained weights are the same in every run), (b) bf16 compute
   batch 256, (c) as (b) with ``accum_steps=4``, (d) as (b) with ``remat``,
   5 steps each, (e) a ``StochasticInputBinarizer`` model, 2 steps, each
   with its losses, ms a step by CUDA events after 2 warm-up steps,
   images/s and peak memory (every loss finite; (b)'s falls), and for (b),
   (c) and (d) a step's device busy share and busiest kernels; then case
   (a)'s trained weights through ``Predictor(batch_size=1)`` and ``8`` in
   f32, with phase 3's launch counts, against the plain versions of the
   same path on the CPU: the stem within 1e-5, the logits within 1e-3 with
   the card's stem output fed to the CPU's forward (a ternary sign flips
   where the stem's sum lands within rounding of 0);
6. serving as ``examples/serve.py`` runs it, on case (a)'s trained weights:
   (a) the flagship and its AdamW through ``utils.save_checkpoint`` and
   ``load_checkpoint`` into a fresh flagship and AdamW (``restore_into``,
   ``restore_optimizer``), every state tensor bit-identical, and one more
   step of each pair (cuDNN deterministic) bit-identical again; (b)
   ``Predictor.from_checkpoint(..., quantize_float_bits=8)`` (the int8 head)
   at batch 1 and 8 in bf16 with phase 3's launch counts, its logits
   against the bf16 head of the same weights (max |diff| over max |logit|
   under 0.02, top-1 agreement), its f32 build against the plain versions
   on the CPU (as in phase 5), and each head's forward profiled and timed
   in turns; (c) ``state_bytes``, ``packed_weight_bytes``,
   ``model_weight_bytes`` and the card memory each predictor holds, with
   and without the int8 head; (d) 256 single-image requests through
   ``ContinuousBatcher`` over the batch-8 predictor (max_delay 5 ms),
   Poisson arrivals at 200 requests/s and at 80% of the predictor's
   capacity, then all at once (the batcher's own ceiling): each request's
   rows against a direct call (1e-5), images/s,
   batches, occupancy, p50 and p99 latency, launches (one stem and one
   ``binary_gemm`` a batch) and the device busy share under
   torch.profiler; (e) ``python -m bnn_tpu_torch.examples.serve --ckpt``
   with ``--requests 4``, and with ``--continuous``, each exiting 0;
7. the frozen serving bundle: (a) ``torch.library.opcheck`` of each of the
   ten kernel operators on CUDA tensors at one phase-2 case; (b) each
   serving path above (ResNet-18 at batch 1 and 8, ResNet-34 and ResNet-50
   at batch 1, paths A, B and C, the int8 head at batch 1 and 8) exported
   with ``export_serving``, the live predictor bit-identical before and
   after, then every bundle loaded in one fresh ``python -c`` process that
   builds no model: its logits bit-identical to the live predictor's, its
   launches per forward, by kernel name under torch.profiler, phase 3's;
   export and load seconds, ``program.pt2`` bytes and ``state_bytes``;
   (c) host time per call of a do-nothing operator through a plain call,
   ``torch.library.Library`` and ``custom_op``, and of each kernel
   operator through the dispatcher beside its CUDA implementation called
   directly; (d) 64 single-image requests through ``ContinuousBatcher``
   over the loaded batch-8 bundle, each row within 1e-5 of a direct call;
   (e) the serve CLI's ``--export``, ``--load`` and ``--load
   --continuous``, each exiting 0;
8. the recipes and the rest of the model zoo: (a) every recipe of the repo
   through ``BinaryChef`` (which YAML loader ran; the port's block reader
   gives the same steps); (b) path D, the reference's ImageNet
   configuration (pre-activation ResNet-18, PReLU, the DaBNN stem, 1000
   classes, 224x224), trained through both steps of
   ``imagenet-baseline.yaml`` on one fixed batch of 256 in bf16 compute (8
   steps, then 5), each step's lr against the schedule computed on the CPU
   (1e-7 relative), the first step's lr 0 leaving the weights unchanged, a
   checkpoint between the steps restored with the schedule's position; (c)
   path D served at batch 1, 4 and 8 in bf16 with its launches (B <= 4:
   ``fused_chain`` for layer1, ``fused_basic_block`` for layer2.1, 3.1 and
   4.1), every kernel call of the batch 1 and 4 forwards held against its
   plain version, ``fused_basic_block`` timed at R18's three stage shapes,
   the f32 build against the CPU's plain versions from the card's first
   conv output (1e-3), latency, images/s and device busy; then after
   ``xnor-net-plus.yaml``'s two steps at batch 4 and 8; (d) path E, the
   BATS CIFAR network (C = 36, 20 layers, groups 4, auxiliary head),
   trained 5 f32 steps at batch 96 (aux weight 0.4, drop-path 0.2, cuDNN
   deterministic) and
   served at batch 1 and 8 (``binary_gemm`` per pointwise conv in gemm
   mode, each call held against its plain version), the f32 build against
   the CPU (1e-3), latency, images/s and device busy; (e) two binarized
   HBlocks and LayerNorm + binarized attention, one forward and backward
   on the card against the CPU in float64 (1e-4); (f) path D's batch-4 and
   path E's batch-8 predictors exported and loaded in a fresh process as in
   phase 7;
9. the host pipeline and the training utilities: (a) ``python -m
   bnn_tpu_torch.examples.cifar10 --synthetic --epochs 2 --batch-size 256``
   as a subprocess, then resumed with ``--epochs 3`` (images/s of each
   epoch after the first, the checkpoint at epoch 3 with 24 Adam steps,
   every loss finite); (b) a uint8 store of 2,048 images of 224x224x3
   through ``NativeDataLoader`` (pad 4, flip, ImageNet mean/std, batch 256,
   the native path) alone, its host-to-card copy, then with
   ``prefetch_to_device`` feeding phase 5's bf16 batch-256 flagship step, in
   turns with the step on a batch already on the card, and the device's
   busy share and the kernels' launches (none) over the fed steps; (c)
   ``loop_time`` of ``binary_gemm`` at M=196 K=1024 N=512 beside
   torch.profiler's time, ``trace()`` of ten calls holding the kernel's
   events (a trace or profiled run that CUPTI left without device events is
   taken again, up to three times, here and in (b)),
   ``compiled_stats`` of a flagship forward against ``count_ops``' 2 * MACs
   and its peak memory, ``debug_nans()`` raising on a CUDA NaN; (d)
   ``native.gemm`` at that shape on the host CPU against its plain version,
   in GOPS; (e) (a)'s trained model saved as ``{'state_dict', 'epoch'}`` and
   imported into a fresh model with ``import_torch_checkpoint``: logits
   bit-identical;
10. the parallel paths, each world in processes of its own (``--rank``):
   (a) a world of one rank over NCCL: ``make_mesh()`` (1x1), the flagship
   through ``Predictor(mesh=)`` at batch 4 and 8, bit-identical to the plain
   ``Predictor`` with phase 3's launches; the data-parallel step with
   ``shard_model`` and ``shard_optimizer_zero1`` on phase 5 (b)'s
   configuration (bf16, batch 256, AdamW, 3 steps), each parameter's largest
   difference from the plain step and both steps' ms; ``pipeline_apply`` and
   ``HeteroPipeline`` with one stage against the stage; ``packed_tp_chain``
   at P=1 bit-identical to ``reference_chain``; (b) two ranks on the one card
   over gloo (``GLOO_CUDA``, the fixed table of the collectives gloo takes
   with CUDA tensors, printed first): the data-parallel flagship at batch 8
   (each rank's 4 rows through the stem and 4 ``fused_chain``), the
   tensor-parallel one over a model axis of 2 (``binary_gemm`` at N=256),
   each bit-identical to its single-process predictor, ``state_bytes`` and
   card memory per rank; the flagship's data-parallel step with
   ``shard_model`` and ``shard_optimizer_zero1`` (f32, batch 64, AdamW, 3
   steps), each step bit-identical to AdamW on the whole parameters with the
   averaged gradients, both ranks' parameters bit-identical, and against the
   plain step on the whole batch its gradient, losses, each parameter's
   largest difference and both steps' ms; a path whose collectives gloo does
   not take (a two-stage ``HeteroPipeline``, ``packed_tp_chain`` at P=2) is
   named with the reason;
11. the command-line entry points over ``torch.distributed``, each
   ``main(argv)``: (a) in this process, a world of one rank over NCCL:
   ``python -m bnn_tpu_torch.examples.imagenet --synthetic --arch
   resnet18 --image-size 224 -b 256 --bf16 --steps-per-epoch 4 --epochs 1``
   through ``imagenet-baseline.yaml`` step 0, then ``--resume`` to epoch 2
   (the optimizer restored: 8 AdamW steps in the checkpoint, training from
   ``Epoch[1]``), ``--evaluate`` (nothing trained) and ``--zero1``, each
   run's seconds, losses (finite), images/s, ms a step and peak memory; (b)
   in rank processes (``--rank``), two ranks on the one card over gloo
   (``--device cuda:0 --dist-backend gloo``): ``python -m
   bnn_tpu_torch.examples.serve --data-parallel 2``, then
   ``--tensor-parallel 2``, at batch 8 and 224x224, each with ``--export``
   (the live mesh predictor the CLI built, its logits kept), then in a fresh
   world of two with ``--load`` (2 requests; launches per rank by kernel
   name: ``fused_stem`` 1 and ``fused_chain`` 4 a forward data-parallel,
   ``binary_gemm`` 1 at N=256 tensor-parallel), and each bundle through
   ``load_serving`` there, its logits bit-identical to the live mesh
   predictor's, each rank's ``state_bytes`` and the card memory its state
   takes; (c) in (b)'s first world the trainer with ``--zero1`` and with
   ``--model-parallel 2`` (f32, batch 64, 2 steps; losses finite, ms a
   step). ``--pipeline`` needs ``batch_isend_irecv``, which gloo refuses with
   CUDA tensors (``GLOO_CUDA``): named with the reason, held by the CPU tests;
12. the plain serving paths beside the kernels: the flagship ResNet-18 at
   batch 1 and 8, ResNet-50 at batch 8 and path C at batch 8, each through
   the default ``Predictor`` and ``Predictor(use_pallas=False)`` of the same
   weights in one process: the ten kernels' launches (phase 3's under the
   default, none under ``use_pallas=False``), the two f32 builds' logits
   within 1e-3 of each other with argmax equal, and in bf16 each one's
   forward latency (host clock, in turns) and device busy;
13. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}`` as
   the last line.

``--forwards`` builds the kernels of the ``bnn_tpu_torch`` in the current
directory and times its live forwards at ResNet-18 batch 1 and 8 and
ResNet-50 batch 1 (host clock and device busy), one JSON line each: run from
a parent unpacked with ``git archive`` and from the change in turns, it
shows what operator dispatch costs a forward.

Exits non-zero, printing no result, when CUDA is unavailable or any phase
fails. Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import importlib
import json
import math
import pathlib
import shutil
import subprocess
import sys
import threading
import time

import torch

from gemm_shapes import CONV2D, R18_STAGES, block_bound

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


# name: opcode prefix (__dp4a is IDP.4A in Hopper's SASS)
SASS_OPS = {"IMMA": "IMMA", "BMMA": "BMMA", "HMMA": "HMMA", "IDP4A": "IDP",
            "POPC": "POPC"}


def sass_counts(lib) -> tuple:
    """Int8 (IMMA), 1-bit (BMMA) and bf16 (HMMA) tensor-core, dot-product
    (IDP4A) and popcount (POPC) instructions in a built library's SASS, and
    the total,
    from ``cuobjdump -sass``: ``({opcode: count} or None, printable line)``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, timeout=120, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return None, f"SASS not read ({e})"
    ops = []  # the opcode of each instruction line, past any @predicate
    for line in sass.splitlines():
        words = line.split("*/", 1)[-1].split() if line.strip().startswith("/*") else []
        words = words[1:] if words and words[0].startswith("@") else words
        if words:
            ops.append(words[0])
    counts = {name: sum(o.startswith(op) for o in ops) for name, op in SASS_OPS.items()}
    return counts, ", ".join(f"{v} {k}" for k, v in counts.items()) + \
        f" of {len(ops)} instructions in its SASS"


# device_profile's key when every trace came back without device events
EVENTS_ONLY = "all kernels (CUDA events: torch.profiler recorded no device time)"


def device_profile(fn, iters: int = 20, attempts: int = 3, whole: bool = True):
    """``({kernel name: device ms per call}, wall ms per call)`` of ``fn``
    over ``iters`` calls under ``torch.profiler``, after a warm-up. A trace
    that comes back without device events, or (with ``whole``) with a
    kernel whose events are not a whole number per call (CUPTI now and then
    delivers none, or drops some, which reads low), is taken again, up to
    ``attempts`` times; then the CUDA-event time per call stands in, under
    the key ``EVENTS_ONLY``. A forward's breakdown takes ``whole=False``:
    its long traces drop events too often."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_name, count = {}, {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = (by_name.get(e.name, 0.0)
                                   + e.time_range.elapsed_us() / 1e3 / iters)
                count[e.name] = count.get(e.name, 0) + 1
        if by_name and (not whole or all(c % iters == 0 for c in count.values())):
            return by_name, wall / iters * 1e3
    print(f"phase 4: torch.profiler recorded no whole trace in {attempts}; "
          "CUDA-event time per call stands in for this one")
    return {EVENTS_ONLY: cuda_ms(fn, iters)}, wall / iters * 1e3


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call of ``fn``: the sum of its kernels' durations."""
    return sum(device_profile(fn, iters)[0].values())


def own_ms(fn, name: str, iters: int = 20) -> tuple:
    """Device ms per call of ``fn``'s kernels whose name holds ``name``, and
    of its other kernels."""
    by_name = device_profile(fn, iters)[0]
    own = sum(v for k, v in by_name.items() if name in k or k == EVENTS_ONLY)
    return own, sum(by_name.values()) - own


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |v| (8 significant bits)."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def stem_plan_text(plan, hp: int) -> str:
    """A stem launch plan in words, with the pooled rows of the last item
    of each column of items where they are fewer than the plan's."""
    last = hp % plan["rows"]
    return (f"items of {plan['rows']} pooled row(s) x 7 columns"
            f"{f' (the last band of items {last})' if last else ''}, {plan['items']} items "
            f"on {plan['blocks']} blocks ({plan['blocks_per_sm']} an SM)")


def partial_stem_shape(kernels, dev) -> tuple:
    """The first of a few bf16 stem geometries whose launch plan leaves a
    partial last item (hp % rows != 0), so that phase 2 runs one."""
    desc = kernels.StemDesc(torch.zeros((7, 7, 3, 64), dtype=torch.bfloat16,
                                        device=dev))
    for shape in ((8, 208, 208, 3), (4, 216, 216, 3), (8, 200, 200, 3),
                  (4, 200, 208, 3), (2, 216, 200, 3)):
        plan = desc.plan(torch.empty(shape, dtype=torch.bfloat16, device=dev))
        if (shape[1] // 4) % plan["rows"]:
            return shape
    raise AssertionError("no stem geometry tried leaves a partial last item")


def check_stem(kernels, shape, gen, dev, x_dtype=torch.bfloat16,
               w_dtype=torch.bfloat16, entry: str = "fused_stem",
               out_dtype=None) -> float:
    """The stem kernel, through its entry point ``entry`` (``fused_stem``,
    ``fused_stem_v2`` or ``fused_stem_v3``), at ``shape`` against the plain
    version computed in f32 from the same inputs. A bf16 output (bf16 x;
    bf16 or f32 weights, 1 or 3 passes) is within one bf16 ulp, plus 1e-5
    absolute for the f32 sums' own rounding next to zero; an f32 output (f32
    x and weights, 6 passes; or bf16 x with ``out_dtype`` f32, stored by the
    kernel) within 1e-5."""
    n, h, w, c = shape
    x = torch.randn(shape, generator=gen).to(dev, x_dtype)
    wk = (0.1 * torch.randn((7, 7, c, 64), generator=gen)).to(dev, w_dtype)
    b = (0.1 * torch.randn(64, generator=gen)).to(dev)
    got = getattr(kernels.stem, entry)(x, wk, b, out_dtype=out_dtype)
    want_dtype = x_dtype if out_dtype is None else out_dtype
    if got.dtype != want_dtype:
        raise AssertionError(f"{entry} {tuple(shape)}: output {got.dtype}, "
                             f"expected {want_dtype}")
    got = got.float()
    ref = kernels.fused_stem_reference(x, wk, b, out_dtype=torch.float32)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    passes = len(kernels.stem.stem_passes(x_dtype, w_dtype))
    label = (f"{entry} {tuple(shape)} x {str(x_dtype)[6:]}, w {str(w_dtype)[6:]} "
             f"({passes} pass{'es' if passes > 1 else ''}) -> {tuple(got.shape)} "
             f"{str(want_dtype)[6:]}, "
             f"{stem_plan_text(kernels.StemDesc(wk, b).plan(x, out_dtype), h // 4)}")
    if want_dtype == torch.float32:
        if not err.max().item() <= 1e-5:
            raise AssertionError(f"{label}: max |err| {err.max().item():.3g} > 1e-5")
        print(f"phase 2: {label}: max |err| {err.max().item():.3g} (limit 1e-5)")
        return err.max().item()
    ulps = (err / bf16_ulp(ref)).max().item()
    if not bool((err <= bf16_ulp(ref) + 1e-5).all()):
        raise AssertionError(f"{label}: {ulps:.2f} bf16 ulp off")
    print(f"phase 2: {label}: max |err| {err.max().item():.3g} ({ulps:.2f} bf16 ulp)")
    return err.max().item()


def hold_gemm(kernels, label, args, kw, phase: int = 2, plan=None) -> float:
    """binary_gemm on ``args``/``kw`` (through the host plan, or launched with
    ``plan``) against its plain version: bit-identical. Returns the largest
    absolute difference."""
    auto = gemm_plan_of(kernels, *args[:3])
    if plan is None:
        got, plan = kernels.binary_gemm(*args, **kw), auto
    else:
        got = kernels.gemm.binary_gemm_planned(*args, plan=plan, **kw)
    ref = kernels.binary_gemm_reference(*args, **kw)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item() if got.shape == ref.shape else None
    if err is None or not torch.equal(got, ref):
        raise AssertionError(f"binary_gemm {label} tile {plan[0]} {plan[1]} loader: "
                             f"max |err| {err}")
    if phase == 2:
        print(f"phase 2: binary_gemm {label}: tile {plan[0]}x{plan[0]}, {plan[1]} "
              f"loader ({'host plan' if plan == auto else 'forced'}): max |err| {err}")
    return err


def gemm_plan_of(kernels, x, wp, k):
    """The host plan ``(tile, loader)`` binary_gemm takes for ``x`` and ``wp``."""
    return kernels.gemm.gemm_plan(
        x.shape[0], k, wp.shape[1], x.element_size(), x.data_ptr(), wp.data_ptr(),
        torch.cuda.get_device_properties(x.device).multi_processor_count)


def check_gemm(kernels, m, k, n, dtype, sign_inputs, gen, dev, tile=None,
               loader=None, offset=False) -> float:
    """binary_gemm against its plain version on random inputs of the shape:
    10% exact zeros when ``sign_inputs``, else ternary values; ``offset``
    starts x one element into its buffer, off 16 bytes. ``tile`` and
    ``loader`` force that instance, the other coming from the host plan."""
    if sign_inputs:
        x = torch.randn((m, k), generator=gen)
        x[torch.rand((m, k), generator=gen) < 0.1] = 0.0  # exact zeros
    else:
        x = torch.randint(-1, 2, (m, k), generator=gen).float()
    if offset:
        buf = torch.zeros(m * k + 1, dtype=dtype, device=dev)
        buf[1:] = x.to(dev, dtype).flatten()
        x = buf[1:].view(m, k)
    else:
        x = x.to(dev, dtype)
    wp = kernels.pack_bits(torch.randn((k, n), generator=gen).to(dev), axis=-2)
    scale = torch.rand(n, generator=gen).to(dev) + 0.5
    add = torch.randn(n, generator=gen).to(dev)
    plan = None
    if tile or loader:
        auto = gemm_plan_of(kernels, x, wp, k)
        plan = (tile or auto[0], loader or auto[1])
    label = (f"M={m} K={k} N={n} {str(dtype)[6:]} sign_inputs={sign_inputs}"
             f"{' x off 16 bytes' if offset else ''}")
    return hold_gemm(kernels, label, (x, wp, k, scale, add),
                     dict(sign_inputs=sign_inputs), plan=plan)


# binary_gemm's edge shapes, each at both tiles with the host's loader:
# (M, K, N, x dtype, sign_inputs, x off 16 bytes)
GEMM_EDGES = [
    (1, 256, 512, torch.bfloat16, False, False),   # M = 1
    (1, 33, 7, torch.float32, True, False),
    (37, 31, 65, torch.bfloat16, True, False),     # K % 8 != 0, N % 4 != 0
    (37, 33, 64, torch.bfloat16, False, False),
    (37, 40, 64, torch.bfloat16, True, False),     # K = 40 takes 16-byte copies
    (37, 40, 65, torch.float32, False, False),     # N = 65
    (100, 70, 7, torch.float32, True, False),      # f32 with K % 4 != 0, N = 7
    (100, 70, 130, torch.bfloat16, False, False),
    (37, 70, 64, torch.bfloat16, True, True),      # x = buf[1:], K % 8 != 0
    (49, 256, 512, torch.bfloat16, False, True),   # only the pointer is off
]


def check_gemms(kernels, gen, dev) -> float:
    """binary_gemm's every tile and loader instance at the serving shapes
    (ResNet-18 layer4.0's shortcut at batch 8, ResNet-50 layer4.0.conv1 at
    batch 1), then the edge shapes; a plan the shape cannot take is refused.
    Returns the largest |err|."""
    errs = []
    for m, k, n in ((BATCH * 7 * 7, 256, 512), (196, 1024, 512)):
        for tile in kernels.gemm.GEMM_TILES:
            for loader in ("vector", "scalar"):
                errs.append(check_gemm(kernels, m, k, n, torch.bfloat16, False, gen,
                                       dev, tile=tile, loader=loader))
            errs.append(check_gemm(kernels, m, k, n, torch.float32, True, gen, dev,
                                   tile=tile))
    for m, k, n, dtype, sign_inputs, offset in GEMM_EDGES:
        for tile in kernels.gemm.GEMM_TILES:
            errs.append(check_gemm(kernels, m, k, n, dtype, sign_inputs, gen, dev,
                                   tile=tile, offset=offset))
    x = torch.zeros((8, 70), device=dev)
    wp = torch.zeros((3, 64), dtype=torch.int32, device=dev)
    try:
        kernels.gemm.binary_gemm_planned(x, wp, 70, plan=(32, "vector"))
    except ValueError:
        print("phase 2: binary_gemm refuses the vector loader at K=70 f32")
    else:
        raise AssertionError("binary_gemm launched 16-byte copies at K=70 f32")
    return max(errs)


def rand_block(kernels, kind, ci, co, gen, dev, dtype, *, options: bool):
    """BlockParams with random +/-1 weights and epilogue rows of the size a
    folded BN gives, its float rows cast to ``dtype`` as cast_floats casts a
    stage's; ``options`` adds PReLU slopes and non-zero thresholds."""
    def pm1(*shape):
        return torch.where(torch.randn(shape, generator=gen) >= 0, 1, -1).to(torch.int8)

    def vec(c, loc, scale):
        return loc + scale * torch.randn(c, generator=gen)

    k1 = 9 * ci
    kw = dict(scale1=vec(co, 1.0, 0.2).abs() / k1 ** 0.5, add1=vec(co, 0.0, 0.3),
              scale2=vec(co, 1.0, 0.2).abs() / (9 * co) ** 0.5,
              add2=vec(co, 0.0, 0.3))
    if kind == "down":
        kw.update(wd=pm1(ci, co), scaled=vec(co, 1.0, 0.2).abs() / ci ** 0.5,
                  addd=vec(co, 0.0, 0.3))
    if options:
        kw.update(prelu1=vec(co, 0.25, 0.1), prelu2=vec(co, 0.25, 0.1),
                  threshold=vec(ci, 0.0, 0.1), threshold2=vec(co, 0.0, 0.1))
        if kind == "down":
            kw["thresholdd"] = vec(ci, 0.0, 0.1)
    bp = kernels.BlockParams(kind, pm1(3, 3, ci, co), pm1(3, 3, co, co), **kw)
    arrays = [a.to(dev) if a.dtype == torch.int8 else a.to(dev, dtype)
              for a in bp.arrays()]
    return kernels.BlockParams.from_arrays((bp.kind, bp.ci, bp.co), arrays)


def check_exact(name, got, ref, head: bool, phase: int = 2,
                verbose: bool = True) -> float:
    """The kernel against its plain version: logits within 1e-5; other
    outputs bit-identical in f32 and within one bf16 ulp in bf16."""
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} against "
                             f"{tuple(ref.shape)} {ref.dtype}")
    err = (got.float() - ref.float()).abs()
    if head:
        ok = bool((err <= 1e-5).all())
    elif got.dtype == torch.float32:
        ok = torch.equal(got, ref)
    else:
        ok = bool((err <= bf16_ulp(ref.float())).all())
    mismatched = int((err > 0).sum())
    if not ok or not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: max |err| {err.max().item()}, "
                             f"{mismatched} of {err.numel()} values differ")
    if verbose:
        print(f"phase {phase}: {name}: max |err| {err.max().item():.3g}, "
              f"{mismatched} of {err.numel()} values differ")
    return err.max().item()


def check_blocks(kernels, gen, dev) -> dict:
    """Each residual-block kernel against its plain version on the card."""
    errs = {"fused_chain": 0.0, "fused_basic_block": 0.0,
            "fused_downsample_block": 0.0}

    def run(kernel, name, args, kw, head=False):
        got = getattr(kernels, kernel)(*args, **kw)
        ref = getattr(kernels, kernel + "_reference")(*args, **kw)
        errs[kernel] = max(errs[kernel], check_exact(name, got, ref, head))

    def basic_case(shape, dtype, opts, options, g, tag, note=""):
        c = shape[-1]
        b = rand_block(kernels, "basic", c, c, g, dev, dtype, options=options)
        x = torch.randn(shape, generator=g).to(dev, dtype)
        p = b.prm
        run("fused_basic_block", f"fused_basic_block ({','.join(map(str, shape))}){note} {tag}",
            (x, b.w1.reshape(3, 3, c, c), b.w2.reshape(3, 3, c, c), p[0], p[1], p[3], p[4]),
            dict(opts, prelu1=p[2], prelu2=p[5], threshold=p[6], threshold2=p[7]))

    def down_case(d, x, opts, tag, note=""):
        ci, co = d.ci, d.co
        p, q = d.po, d.pi
        run("fused_downsample_block",
            f"fused_downsample_block ({','.join(map(str, x.shape))}) -> {co}{note} {tag}",
            (x, d.w1, d.w2.reshape(3, 3, co, co), d.wd,
             p[0], p[1], p[3], p[4], p[6], p[7]),
            dict(opts, prelu1=p[2], prelu2=p[5], threshold1=q[0, :ci],
                 threshold2=p[8], thresholdd=q[1, :ci]))

    bf = torch.bfloat16
    torch_opts = dict(act="relu", pre=False, zero_to_one=False)
    other_opts = dict(act="prelu", pre=True, zero_to_one=True)
    for dtype, opts, options in ((bf, torch_opts, False), (torch.float32, other_opts, True)):
        tag = f"{str(dtype)[6:]} act={opts['act']} pre={opts['pre']} " \
              f"zero_to_one={opts['zero_to_one']}"
        pair = [rand_block(kernels, "basic", 64, 64, gen, dev, dtype, options=options)
                for _ in range(2)]
        x = torch.randn((1, 56, 56, 64), generator=gen).to(dev, dtype)
        run("fused_chain", f"fused_chain pair (1,56,56,64) {tag}", (x, pair), opts)
        down = [rand_block(kernels, "down", 256, 512, gen, dev, dtype, options=options),
                rand_block(kernels, "basic", 512, 512, gen, dev, dtype, options=options)]
        wfc = (torch.randn((512, 1000), generator=gen) / 512 ** 0.5).to(dev, dtype)
        bfc = (0.1 * torch.randn(1000, generator=gen)).to(dev, dtype)
        x = torch.randn((4, 14, 14, 256), generator=gen).to(dev, dtype)
        run("fused_chain", f"fused_chain down+basic+head (4,14,14,256)->(4,1000) {tag}",
            (x, down, wfc, bfc), opts, head=True)
        run("fused_chain", f"fused_chain down+basic (4,14,14,256) {tag}", (x, down), opts)

        basic_case((1, 7, 7, 512), dtype, opts, options, gen, tag)
        down_case(down[0], torch.randn((4, 14, 14, 256), generator=gen).to(dev, dtype),
                  opts, tag)

    # fused_chain at ResNet-18's four stage shapes at batch 1 and 4, then at
    # widths its word loader takes (C % 16 != 0); its own generator keeps
    # the draws of the cases above and of the phases after this one
    gen_c = torch.Generator().manual_seed(SEED + 3)
    for dtype, opts, options in ((bf, torch_opts, False), (torch.float32, other_opts, True)):
        tag = f"{str(dtype)[6:]} act={opts['act']} pre={opts['pre']} " \
              f"zero_to_one={opts['zero_to_one']}"
        for n in (1, 4):
            for (h, ci), plan, co, head in R18_STAGES:
                run("fused_chain", f"fused_chain R18 stage {'+'.join(plan)}"
                    f"{'+head' if head else ''} ({n},{h},{h},{ci}) {tag}",
                    chain_args(kernels, n, h, ci, plan, co, head, gen_c, dev, dtype,
                               options), opts, head=head)
    for (h, ci), plan, co in (((16, 20), ("down", "basic"), 40),
                              ((16, 24), ("down", "basic", "basic"), 48),
                              ((10, 20), ("basic", "basic"), 20)):
        run("fused_chain", f"fused_chain {'+'.join(plan)} (2,{h},{h},{ci}) -> {co} "
            f"(C % 16 != 0: the word loader) {tag}",
            chain_args(kernels, 2, h, ci, plan, co, False, gen_c, dev, torch.float32,
                       True), other_opts)
    # fused_basic_block and fused_downsample_block at a width their word
    # loader takes, and fused_downsample_block at R34 layer4.0's batch-1
    # shape, in both dtypes
    for dtype, opts, options in ((bf, torch_opts, False), (torch.float32, other_opts, True)):
        tag = f"{str(dtype)[6:]} act={opts['act']} pre={opts['pre']} " \
              f"zero_to_one={opts['zero_to_one']}"
        basic_case((2, 9, 9, 20), dtype, opts, options, gen_c, tag,
                   " (C % 16 != 0: the word loader)")
        d = rand_block(kernels, "down", 20, 40, gen_c, dev, dtype, options=options)
        down_case(d, torch.randn((2, 10, 10, 20), generator=gen_c).to(dev, dtype),
                  opts, tag, " (C % 16 != 0: the word loader)")
        d = rand_block(kernels, "down", 256, 512, gen_c, dev, dtype, options=options)
        down_case(d, torch.randn((1, 14, 14, 256), generator=gen_c).to(dev, dtype),
                  opts, tag)
    return errs


def chain_args(kernels, n, h, ci, plan, co, head, gen, dev, dtype, options):
    """fused_chain's positional arguments for one stage: a random (n, h, h,
    ci) input, the blocks of ``plan`` (``rand_block``) and, with ``head``, a
    1000-class fc."""
    blocks, c = [], ci
    for kind in plan:
        blocks.append(rand_block(kernels, kind, c, co, gen, dev, dtype, options=options))
        c = co
    args = (torch.randn((n, h, h, ci), generator=gen).to(dev, dtype), blocks)
    if head:
        args += ((torch.randn((co, 1000), generator=gen) / co ** 0.5).to(dev, dtype),
                 (0.1 * torch.randn(1000, generator=gen)).to(dev, dtype))
    return args


# fused_bottleneck's phase-2 cases: (x shape, width, C_out, act, zero_to_one,
# thresholds, exact zeros in x); a projection wherever C_out != C
BOTTLENECKS = [
    ((1, 56, 56, 64), 64, 256, "relu", False, False, True),          # layer1.0
    ((1, 56, 56, 256), 64, 256, "prelu", True, True, False),         # layer1.1
    ((4, 14, 14, 1024), 256, 1024, "identity", False, True, True),   # layer3, B=4
    ((1, 7, 7, 2048), 512, 2048, ("prelu", "identity", "relu"), True, True, True),
    ((2, 9, 11, 64), 32, 128, "prelu", False, True, False),          # odd H, W
]
# channel counts off a multiple of 16, where a GEMM's rows load word by word:
# conv1 on 16-byte rows, the 3x3 and conv3 on words; every GEMM on words
WORD_BOTTLENECKS = [
    ((1, 8, 8, 32), 12, 32, "relu", False, True, True),
    ((2, 7, 9, 24), 20, 40, "prelu", True, True, False),
]


def rand_bottleneck(c, width, cout, gen, dev, dtype, *, prelu: bool,
                    thresholds: bool):
    """(w1, w2, w3, keyword arguments) of a Bottleneck: random +/-1 int8
    weights and epilogue rows of the size a folded BN gives, the float rows
    in ``dtype``; a projection where ``cout != c``."""
    def pm1(*shape):
        return torch.where(torch.randn(shape, generator=gen) >= 0, 1, -1).to(
            dev, torch.int8)

    def vec(n, loc, scale, k=None):
        v = loc + scale * torch.randn(n, generator=gen)
        return (v.abs() / k ** 0.5 if k else v).to(dev, dtype)

    kw = dict(scale1=vec(width, 1.0, 0.2, c), add1=vec(width, 0.0, 0.3),
              scale2=vec(width, 1.0, 0.2, 9 * width), add2=vec(width, 0.0, 0.3),
              scale3=vec(cout, 1.0, 0.2, width), add3=vec(cout, 0.0, 0.3))
    if cout != c:
        kw.update(wd=pm1(c, cout), scaled=vec(cout, 1.0, 0.2, c),
                  addd=vec(cout, 0.0, 0.3))
    if prelu:
        kw.update(prelu1=vec(width, 0.25, 0.1), prelu2=vec(width, 0.25, 0.1),
                  prelu3=vec(cout, 0.25, 0.1))
    if thresholds:
        kw.update(threshold1=vec(c, 0.0, 0.1), threshold2=vec(width, 0.0, 0.1),
                  threshold3=vec(width, 0.0, 0.1))
        if cout != c:
            kw["thresholdd"] = vec(c, 0.0, 0.1)
    return pm1(c, width), pm1(3, 3, width, width), pm1(width, cout), kw


def check_bottlenecks(kernels, gen, dev) -> float:
    """fused_bottleneck against its plain version on the card at
    :data:`BOTTLENECKS` and :data:`WORD_BOTTLENECKS`, in f32 and bf16; the
    word-loader cases draw from their own generator, so that the other
    cases and the phases after this one draw what they drew before."""
    err = 0.0
    gen_w = torch.Generator().manual_seed(SEED + 4)
    for shape, width, cout, act, z21, thresholds, zeros, g in (
            [case + (gen,) for case in BOTTLENECKS]
            + [case + (gen_w,) for case in WORD_BOTTLENECKS]):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=g)
            x = x.clamp_min(0.0) if zeros else x
            x = x.to(dev, dtype)
            w1, w2, w3, kw = rand_bottleneck(shape[-1], width, cout, g, dev,
                                             dtype, prelu="prelu" in act,
                                             thresholds=thresholds)
            kw.update(act=act, zero_to_one=z21)
            got = kernels.fused_bottleneck(x, w1, w2, w3, **kw)
            ref = kernels.fused_bottleneck_reference(x, w1, w2, w3, **kw)
            err = max(err, check_exact(
                f"fused_bottleneck {shape} width {width} -> {cout} "
                f"{str(dtype)[6:]} act={act} zero_to_one={z21} "
                f"thresholds={thresholds} zeros={zeros}", got, ref, False))
    return err


def bottleneck_bound(xh, desc):
    """Least time of a fused_bottleneck call on the BottleneckDesc ``desc``:
    x, the output, the four int8 weights and the rows, each once, against
    its int8 operations."""
    n, h, w, c = xh.shape
    width, cout, proj = desc.width, desc.cout, desc.wd is not None
    params = [t for t in [desc.w1, desc.w2, desc.w3, desc.wd] + desc.rows
              if isinstance(t, torch.Tensor)]
    moved = nbytes(xh, *params) + n * h * w * cout * xh.element_size()
    ops = 2 * n * h * w * (c * width + 9 * width * width + width * cout
                           + (c * cout if proj else 0))
    return bound_ms(moved, ops, torch.int8)


def flagship(gen: torch.Generator, depth: int = 18, z1_prelu: bool = False,
             binarizers=None):
    """The flagship QAT ResNet-18 (or the ResNet of ``depth``): binary body,
    float first and last layers, torch-parity ternary sign; BN statistics
    and output scales random so that every folded ``add`` is non-zero. With
    ``z1_prelu``, the Z1-PReLU variant: zero_to_one signs (sign(0) = +1, as
    the pallas-conv and popcount kernels sign) and PReLU activations with
    random slopes (with ReLU, sign(relu(x)) would be +1 everywhere).
    ``binarizers`` replaces the (pre, post, weight) binarizers."""
    import bnn_tpu_torch as bt
    from bnn_tpu_torch.ops import (BasicInputBinarizer, BasicScaleBinarizer,
                                   XNORWeightBinarizer)

    kw = dict(activation=torch.nn.PReLU) if z1_prelu else {}
    sign = (BasicInputBinarizer.with_args(zero_to_one=True) if z1_prelu
            else BasicInputBinarizer)
    model = getattr(bt.models, f"resnet{depth}")(num_classes=1000, generator=gen,
                                                 **kw)
    pre, post, weight = binarizers or (sign, BasicScaleBinarizer,
                                       XNORWeightBinarizer)
    model = bt.prepare_binary_model(
        model,
        bt.BConfig(activation_pre_process=pre, activation_post_process=post,
                   weight_pre_process=weight),
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
            elif isinstance(m, torch.nn.PReLU):
                m.weight.copy_(0.05 + 0.45 * torch.rand(m.weight.shape, generator=gen))
    return model.eval()


KERNELS = ("binary_gemm", "fused_stem", "fused_chain", "fused_basic_block",
           "fused_downsample_block", "fused_bottleneck", "fused_stem_chain",
           "binary_conv2d_s1", "popcount_gemm", "binary_conv2d")
# launches per forward of the serving paths that more than one phase counts:
# ResNet-18 at batch 8 (its stages' cap is 4: the deployed convs, 18 on
# binary_conv2d), ResNet-50 at batch <= 4 and 8, path B (its five strided
# and pointwise convs in mode conv) and path C (its 16 3x3 convs)
R18_8 = {"fused_stem": 1, "binary_gemm": 1, "binary_conv2d": 18}
R50_SMALL = {"fused_stem": 1, "fused_bottleneck": 13, "binary_gemm": 8, "binary_conv2d": 4}
R50_8 = {"fused_stem": 1, "binary_gemm": 27, "binary_conv2d": 25}
PATH_B = {"binary_conv2d_s1": 13, "binary_gemm": 1, "binary_conv2d": 5}
PATH_C = {"popcount_gemm": 36, "binary_conv2d": 16}


def serve_counted(kernels, pred, requests, name: str, want_per_forward: dict,
                  classes: int = 1000, phase: int = 3):
    """Serve ``requests`` with every launch count set to 0 just before and
    read just after; check the counts, shapes and finiteness."""
    for k in KERNELS:
        getattr(kernels, k).launches = 0
    outs = [pred(r) for r in requests]
    torch.cuda.synchronize()
    launches = {k: getattr(kernels, k).launches for k in KERNELS}
    forwards = sum(-(-r.shape[0] // pred.batch_size) for r in requests)
    want = {k: want_per_forward.get(k, 0) * forwards for k in KERNELS}
    for r, o in zip(requests, outs):
        if o.shape != (r.shape[0], classes) or not bool(torch.isfinite(o.float()).all()):
            raise AssertionError(f"{name}: bad output {tuple(o.shape)} for a "
                                 f"request of {r.shape[0]}")
    if launches != want:
        raise AssertionError(f"{name}: expected launches {want} in {forwards} "
                             f"forwards, got {launches}")
    print(f"phase {phase}: {name}: requests of {[r.shape[0] for r in requests]} in "
          f"{forwards} forwards, logits {outs[0].dtype}, launches {launches}")
    return outs, launches


def check_f32(pred_gpu, ref_cpu, images, name, phase: int = 3):
    got = pred_gpu(images).cpu()
    torch.testing.assert_close(got, ref_cpu, rtol=1e-3, atol=1e-3)
    if not bool((got.argmax(1) == ref_cpu.argmax(1)).all()):
        raise AssertionError(f"{name}: argmax differs from the CPU plain path")
    print(f"phase {phase}: {name}: f32 on the card vs plain versions on the CPU: max "
          f"|diff| {(got - ref_cpu).abs().max().item():.3g} (limit 1e-3), "
          f"argmax equal")


def capture_calls(module, name: str, run):
    """``[(args, kwargs)]`` of every call that ``module`` makes to its kernel
    wrapper ``name`` during ``run()``: the serving path's own inputs."""
    real = getattr(module, name)
    seen = []

    def spy(*args, **kwargs):
        seen.append((args, kwargs))
        return real(*args, **kwargs)

    setattr(module, name, spy)
    try:
        run()
        torch.cuda.synchronize()
    finally:
        setattr(module, name, real)
    return seen


def block_bytes(b) -> int:
    """Bytes of a block's parameters that the function needs: a down
    block's conv1 as its 9*Ci*Co int8 taps (its s2d form, 16*Ci*Co, pads
    zeros) and its two input-channel thresholds once (``pi`` tiles them
    four times)."""
    if b.kind == "basic":
        return nbytes(*b.arrays())
    return (9 * b.ci * b.co + nbytes(b.w2, b.wd, b.po)
            + 2 * b.ci * b.pi.element_size())


def chain_bound(x, blocks, wfc, bfc, out_numel, out_size):
    """Least time of a chain: each input, weight and row read once and the
    output written once, against its int8 operations."""
    moved = nbytes(x) + out_numel * out_size
    moved += sum(block_bytes(b) for b in blocks)
    moved += nbytes(*[t for t in (wfc, bfc) if t is not None])
    n, h, w, _ = x.shape
    ops = 0
    for b in blocks:
        if b.kind == "down":
            h, w = h // 2, w // 2
            ops += 2 * n * h * w * b.co * (9 * b.ci + 9 * b.co + b.ci)
        else:
            ops += 2 * n * h * w * b.co * (9 * b.ci + 9 * b.co)
    if wfc is not None:
        ops += 2 * n * wfc.shape[0] * wfc.shape[1]
    return bound_ms(moved, ops, torch.int8)


def time_kernel(fn, plain):
    """(device ms, ms per call) of the kernel and of its plain version."""
    return ((device_ms(fn), cuda_ms(fn)),
            (device_ms(plain, iters=3), cuda_ms(plain, iters=3, warmup=1)))


def fwd_ms(pred, xb, iters: int = 20) -> float:
    """Host-clock ms per synchronised forward of ``pred`` on ``xb``."""
    for _ in range(3):
        pred(xb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        pred(xb)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def host_ms(fn, iters: int = 50) -> float:
    """Host time per call of ``fn``: the calls are issued back to back and
    the card is synchronised only after the clock stops."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e3


def forward_times(pred, xb, card, name, phase: int = 4, profile_iters: int = 10):
    fwd = fwd_ms(pred, xb)
    by_kernel, _ = device_profile(lambda: pred(xb), iters=profile_iters, whole=False)
    busy = sum(by_kernel.values())
    n = xb.shape[0]
    print(f"phase {phase}: {name}: {fwd:.3f} ms per forward, "
          f"{n / fwd * 1e3:.1f} images/s; device busy {busy:.3f} ms per "
          f"forward ({100 * busy / fwd:.1f}% of the latency) | {card}")
    for kname, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        print(f"phase {phase}:   {ms * 1e3:9.2f} us  {kname[:100]}")
    return fwd, busy


def pm1(shape, gen) -> torch.Tensor:
    return torch.where(torch.randn(shape, generator=gen) >= 0, 1, -1).to(torch.int8)


# binary_conv2d_s1's phase-2 cases: (x shape, O, k, x dtype, share of exact
# zeros in x); the first five are path B's layer shapes at batch 8
CONVS = [
    ((8, 56, 56, 64), 64, 3, torch.bfloat16, 0.0),
    ((8, 56, 56, 64), 64, 3, torch.float32, 0.1),
    ((8, 28, 28, 128), 128, 3, torch.float32, 0.0),
    ((8, 14, 14, 256), 256, 3, torch.bfloat16, 0.1),
    ((8, 7, 7, 512), 512, 3, torch.float32, 0.1),
    ((2, 9, 11, 32), 100, 1, torch.bfloat16, 0.2),   # k=1, odd H and W
    ((2, 10, 10, 64), 128, 5, torch.float32, 0.2),   # k=5
    ((1, 7, 9, 6), 10, 3, torch.float32, 0.3),       # C and O not multiples of 4
]
# and its edges, drawn from their own generator: (x shape, O, k, x dtype,
# share of exact zeros, x off 16 bytes)
CONV_EDGES = [
    ((1, 7, 7, 512), 512, 3, torch.bfloat16, 0.1, False),  # N = 1
    ((1, 9, 13, 64), 24, 7, torch.bfloat16, 0.1, False),   # k = 7, odd H and W
    ((2, 6, 7, 40), 33, 3, torch.bfloat16, 0.2, False),    # C = 40: part of a chunk
    ((1, 5, 5, 132), 70, 3, torch.float32, 0.1, False),    # C = 132, O = 70
    ((2, 14, 14, 256), 256, 3, torch.bfloat16, 0.1, True),  # x = buf[1:]
    ((2, 8, 8, 64), 100, 3, torch.float32, 0.3, True),
]


def conv_instances(conv, x, k):
    """Every (tile, loader, split) that ``conv.binary_conv2d_s1_planned``
    takes for x and a k x k kernel."""
    out = []
    for tile in conv.CONV_TILES:
        for loader in ("vector", "scalar"):
            for split in conv.CONV_SPLITS:
                try:
                    conv._check_plan((tile, loader, split), x, k)
                except ValueError:
                    continue
                out.append((tile, loader, split))
    return out


def check_conv_case(kernels, shape, o, k, dtype, zeros, offset, gen, dev) -> float:
    """binary_conv2d_s1 on random inputs of the case, through the host plan
    and through every instance, against its plain version: bit-identical.
    ``offset`` starts x one element into its buffer, off 16 bytes."""
    conv = kernels.conv
    x = torch.randn(shape, generator=gen)
    x[torch.rand(shape, generator=gen) < zeros] = 0.0
    if offset:
        buf = torch.zeros(x.numel() + 1, dtype=dtype, device=dev)
        buf[1:] = x.to(dev, dtype).flatten()
        x = buf[1:].view(shape)
    else:
        x = x.to(dev, dtype)
    w = pm1((k, k, shape[-1], o), gen).to(dev)
    scale = (torch.rand(o, generator=gen) + 0.5).to(dev)
    add = torch.randn(o, generator=gen).to(dev)
    ref = kernels.binary_conv2d_s1_reference(x, w, scale, add)
    label = (f"binary_conv2d_s1 {shape} -> {o} k={k} {str(dtype)[6:]} zeros={zeros}"
             f"{' x off 16 bytes' if offset else ''}")
    err = check_exact(label + " (host plan)", kernels.binary_conv2d_s1(x, w, scale, add),
                      ref, False, verbose=False)
    instances = conv_instances(conv, x, k)
    for plan in instances:
        err = max(err, check_exact(f"{label} {plan}", conv.binary_conv2d_s1_planned(
            x, w, scale, add, plan=plan), ref, False, verbose=False))
    auto = conv.conv_plan(*shape, k, o, x.element_size(), x.data_ptr(),
                          torch.cuda.get_device_properties(dev).multi_processor_count)
    print(f"phase 2: {label}: the host plan {auto} and all {len(instances)} instances "
          f"that take it bit-identical (max |err| {err})")
    return err


def check_convs(kernels, gen, dev) -> float:
    """binary_conv2d_s1 against its plain version on the card, bit-identical,
    at every instance: the cases, then the edges; a plan the input cannot
    take is refused."""
    err = max(check_conv_case(kernels, *case, False, gen, dev) for case in CONVS)
    edge_gen = torch.Generator().manual_seed(SEED + 3)
    err = max([err] + [check_conv_case(kernels, *case, edge_gen, dev)
                       for case in CONV_EDGES])
    # 16-byte copies of 6 f32 channels; four groups of f32 64x64 rings (259 KB)
    for c, plan in ((6, (32, "vector", 1)), (96, (64, "vector", 4))):
        x = torch.zeros((1, 4, 4, c), device=dev)
        w = torch.ones((3, 3, c, 8), dtype=torch.int8, device=dev)
        try:
            kernels.conv.binary_conv2d_s1_planned(x, w, plan=plan)
        except ValueError:
            print(f"phase 2: binary_conv2d_s1 refuses {plan} for f32 x of {c} channels")
        else:
            raise AssertionError(f"binary_conv2d_s1 launched {plan} for f32 x of "
                                 f"{c} channels")
    return err


# binary_conv2d's phase-2 edges beyond the flagships' layers (gemm_shapes'
# CONV2D at batch 8): (C, O, k, stride, H, W, batch, x dtype and epilogue
# dtype, zero_to_one, threshold, weight format, x off 16 bytes)
CONV2D_EDGES = [
    (64, 64, 3, 1, 56, 56, 8, torch.float32, True, False, "int8", False),
    (20, 70, 3, 1, 13, 11, 1, torch.bfloat16, False, True, "packed", False),
    (40, 33, 3, 2, 9, 14, 3, torch.float32, False, True, "int8", False),
    (132, 100, 1, 2, 15, 15, 2, torch.bfloat16, True, True, "packed", False),
    (64, 128, 5, 1, 10, 10, 2, torch.bfloat16, False, False, "int8", False),
    (256, 256, 3, 1, 14, 14, 2, torch.bfloat16, False, True, "packed", True),
    (64, 96, 3, 2, 28, 28, 2, torch.float32, True, True, "int8", True),
]


def conv2d_instances(conv, x):
    """Every (tile, loader) that ``conv.binary_conv2d_planned`` takes for x."""
    vector = conv._vector_ok(x.shape[-1], x.element_size(), x.data_ptr())
    return [(tile, loader) for tile in conv.CONV2D_TILES
            for loader in (("vector", "scalar") if vector else ("scalar",))]


def hold_conv2d(kernels, label, args, kw, phase: int) -> int:
    """One binary_conv2d call (the wrapper's ``args`` and ``kw``) through
    the host plan and through every instance that takes its x, each
    bit-identical to ``binary_conv2d_reference`` on the card (the
    operator's plain implementation, NHWC). Returns the instances held."""
    conv = kernels.conv
    x, w, scale, add = args
    stride, padding = tuple(kw.get("stride", (1, 1))), tuple(kw.get("padding", (0, 0)))
    threshold, zto = kw.get("threshold"), kw.get("zero_to_one", False)
    ref = conv.binary_conv2d_cpu(x, w, threshold, scale, add, stride, padding, zto)
    runs = [("host plan", kernels.binary_conv2d(*args, **kw))]
    for plan in conv2d_instances(conv, x):
        runs.append((plan, conv.binary_conv2d_planned(
            x, w, threshold, scale, add, stride, padding, zto, plan=plan)))
    torch.cuda.synchronize()
    for plan, got in runs:
        if got.dtype != ref.dtype or not torch.equal(got, ref):
            raise AssertionError(f"phase {phase}: {label} {plan}: binary_conv2d differs "
                                 "from binary_conv2d_reference")
    return len(runs) - 1


def conv2d_case(kernels, c, o, k, stride, h, w, n, dtype, zto, thr, fmt, offset, gen, dev):
    """A binary_conv2d call on random inputs: (args, kw) of the wrapper."""
    x = torch.randn((n, h, w, c), generator=gen)
    x[torch.rand(x.shape, generator=gen) < 0.1] = 0.0
    if offset:
        buf = torch.zeros(x.numel() + 1, dtype=dtype, device=dev)
        buf[1:] = x.to(dev, dtype).flatten()
        x = buf[1:].view(n, h, w, c)
    else:
        x = x.to(dev, dtype)
    w8 = pm1((o, c, k, k), gen)
    wt = (w8 if fmt == "int8" else kernels.pack_bits(w8.float(), axis=1)).to(dev)
    scale = (torch.rand(o, generator=gen) + 0.5).to(dev, dtype)
    add = torch.randn(o, generator=gen).to(dev, dtype)
    threshold = (0.1 * torch.randn(c, generator=gen)).to(dev, dtype) if thr else None
    return (x, wt, scale, add), dict(stride=(stride, stride), padding=(k // 2, k // 2),
                                     threshold=threshold, zero_to_one=zto)


def check_conv2ds(kernels, gen, dev) -> float:
    """binary_conv2d against its plain version on the card, bit-identical,
    through the host plan and every tile and loader instance: each distinct
    mode-conv layer of the flagships (bf16 x and epilogue, ternary signs
    against a threshold, packed weights, batch 8), then the edges."""
    cases = sorted({g[:5] for layers in CONV2D.values() for g in layers})
    held = 0
    for c, o, k, stride, side in cases:
        args, kw = conv2d_case(kernels, c, o, k, stride, side, side, BATCH,
                               torch.bfloat16, False, True, "packed", False, gen, dev)
        held += hold_conv2d(kernels, f"binary_conv2d ({BATCH}, {side}, {side}, {c}) -> "
                            f"{o} k={k} stride {stride}", args, kw, phase=2)
    for c, o, k, stride, h, w, n, dtype, zto, thr, fmt, offset in CONV2D_EDGES:
        label = (f"binary_conv2d ({n}, {h}, {w}, {c}) -> {o} k={k} stride {stride} "
                 f"{str(dtype)[6:]} zero_to_one={zto} threshold={thr} {fmt}"
                 f"{' x off 16 bytes' if offset else ''}")
        args, kw = conv2d_case(kernels, c, o, k, stride, h, w, n, dtype, zto, thr,
                               fmt, offset, gen, dev)
        n_inst = hold_conv2d(kernels, label, args, kw, phase=2)
        held += n_inst
        print(f"phase 2: {label}: the host plan and all {n_inst} instances "
              "bit-identical")
    print(f"phase 2: binary_conv2d at the flagships' {len(cases)} mode-conv layers and "
          f"{len(CONV2D_EDGES)} edges: {held} instance runs, each bit-identical to its "
          "plain version")
    return 0.0


def r50_pointwise(batch: int, size: int = SIZE):
    """(M, K, N) of each of ResNet-50's 36 pointwise convs at ``batch``:
    conv1 at the block's input resolution, conv3 and the shortcut after the
    stride (on the 3x3, ResNet V1.5)."""
    shapes, h, cin = [], size // 4, 64
    for planes, count, stride in ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)):
        for i in range(count):
            ho = h // (stride if i == 0 else 1)
            shapes.append((batch * h * h, cin, planes))
            shapes.append((batch * ho * ho, planes, 4 * planes))
            if i == 0:
                shapes.append((batch * ho * ho, cin, 4 * planes))
            h, cin = ho, 4 * planes
    return shapes


# popcount_gemm's phase-2 cases beyond path C's shapes: (M, K, N, x offset
# in words: 1 is off 8 and 16 bytes, 2 off 16 bytes only)
POPCOUNT_EDGES = [
    (5, 33, 7, 0), (17, 100, 33, 0),
    (37, 1, 64, 0),       # K = 1: one word, 31 pad bits
    (100, 256, 70, 0),    # N % 4 != 0
    (70, 96, 64, 0),      # KW = 3, odd
    (33, 2048, 36, 0),    # long K on a one-block grid
    (64, 512, 128, 1),    # x = buf[1:]
    (64, 512, 128, 2),    # x = buf[2:]: 8-byte copies still fit
]


def popcount_instances(gemm, xp, wp):
    """Every (tile, loader, split) that ``gemm.popcount_gemm_planned`` takes
    for xp and wp."""
    vector = gemm._popcount_vector_ok(xp.shape[1], wp.shape[1], xp.data_ptr(),
                                      wp.data_ptr())
    return [(tile, loader, split) for tile in gemm.POPCOUNT_TILES
            for loader in (("vector", "scalar") if vector else ("scalar",))
            for split in gemm.POPCOUNT_SPLITS]


def check_popcount_case(kernels, m, k, n, offset, gen, dev) -> float:
    """popcount_gemm on random inputs of the shape (10% exact zeros in x,
    which pack as +1), through the host plan and through every instance,
    against its plain version: bit-identical. ``offset`` starts the x words
    that many words into their buffer."""
    gemm = kernels.gemm
    x = torch.randn((m, k), generator=gen)
    x[torch.rand((m, k), generator=gen) < 0.1] = 0.0
    xp = kernels.pack_bits(x.to(dev), axis=-1)
    if offset:
        buf = torch.zeros(xp.numel() + offset, dtype=torch.int32, device=dev)
        buf[offset:] = xp.flatten()
        xp = buf[offset:].view(xp.shape)
    wp = kernels.pack_bits(torch.randn((k, n), generator=gen).to(dev), axis=-2)
    scale = (torch.rand(n, generator=gen) + 0.5).to(dev)
    add = torch.randn(n, generator=gen).to(dev)
    ref = kernels.popcount_gemm_reference(xp, wp, k, scale, add)
    label = (f"popcount_gemm M={m} K={k} N={n}"
             f"{f' x off {4 * offset} bytes' if offset else ''}")
    err = check_exact(label + " (host plan)", kernels.popcount_gemm(
        xp, wp, k, scale, add), ref, False, verbose=False)
    instances = popcount_instances(gemm, xp, wp)
    for plan in instances:
        err = max(err, check_exact(f"{label} {plan}", gemm.popcount_gemm_planned(
            xp, wp, k, scale, add, plan=plan), ref, False, verbose=False))
    auto = gemm.popcount_plan(m, xp.shape[1], n, xp.data_ptr(), wp.data_ptr(),
                              torch.cuda.get_device_properties(dev).multi_processor_count)
    print(f"phase 2: {label}: the host plan {auto} and all {len(instances)} "
          f"instances that take it bit-identical (max |err| {err})")
    return err


def check_popcounts(kernels, gen, dev) -> float:
    """popcount_gemm against its plain version on the card, bit-identical,
    at every instance: path C's shapes (batch 8 and 1), then the edges; a
    plan the operands cannot take is refused."""
    shapes = sorted(set(r50_pointwise(8)) | set(r50_pointwise(1)))
    err = max(check_popcount_case(kernels, *case, gen, dev)
              for case in [(m, k, n, 0) for m, k, n in shapes] + POPCOUNT_EDGES)
    xp = torch.zeros((8, 3), dtype=torch.int32, device=dev)  # K = 70: 3 words
    wp = torch.zeros((3, 64), dtype=torch.int32, device=dev)
    for plan in ((64, "vector", 1), (48, "scalar", 1), (32, "scalar", 3)):
        try:
            kernels.gemm.popcount_gemm_planned(xp, wp, 70, plan=plan)
        except ValueError:
            print(f"phase 2: popcount_gemm refuses {plan} for 3 words a row")
        else:
            raise AssertionError(f"popcount_gemm launched {plan} for 3 words a row")
    return err


def check_stem_chains(kernels, gen, dev) -> float:
    """fused_stem_chain against fused_chain(fused_stem(x)) on the card:
    bit-identical; against its own plain version the stem is within a bf16
    ulp, not identical, so that difference is printed. Returns its max."""
    err = 0.0
    bf = torch.bfloat16
    # the last two: a layer1 of 20 channels, which the block phases load word
    # by word, on their own generator (the draws above stay as they were)
    gen_w = torch.Generator().manual_seed(SEED + 7)
    for n, dtype, act, z21, options, c, g in (
            (1, bf, "relu", False, False, 64, gen),
            (4, bf, "prelu", True, True, 64, gen),
            (1, torch.float32, "prelu", False, True, 64, gen),
            (4, torch.float32, "relu", True, False, 64, gen),
            (2, bf, "relu", False, True, 20, gen_w),
            (1, torch.float32, "prelu", True, True, 20, gen_w)):
        x = torch.randn((n, SIZE, SIZE, 3), generator=g).to(dev, dtype)
        ws = (0.1 * torch.randn((7, 7, 3, c), generator=g)).to(dev, dtype)
        bs = (0.1 * torch.randn(c, generator=g)).to(dev, dtype)
        blocks = [rand_block(kernels, "basic", c, c, g, dev, dtype, options=options)
                  for _ in range(2)]
        opts = dict(act=act, zero_to_one=z21)
        got = kernels.fused_stem_chain(x, ws, bs, blocks, **opts)
        split = kernels.fused_chain(kernels.fused_stem(x, ws, bs), blocks, **opts)
        ref = kernels.fused_stem_chain_reference(x, ws, bs, blocks, **opts)
        torch.cuda.synchronize()
        label = (f"fused_stem_chain ({n},{SIZE},{SIZE},3) -> {c} {str(dtype)[6:]} "
                 f"act={act} zero_to_one={z21} thresholds={options}")
        if got.shape != split.shape or not torch.equal(got, split):
            raise AssertionError(f"{label}: differs from fused_chain(fused_stem(x)) "
                                 f"in {int((got != split).sum())} values")
        e = (got.float() - ref.float()).abs()
        print(f"phase 2: {label}: bit-identical to fused_chain(fused_stem(x)); "
              f"against its plain version max |err| {e.max().item():.3g}, "
              f"{int((e > 0).sum())} of {e.numel()} values differ")
        err = max(err, e.max().item())
    return err


def pallas_conv_model(qat, dtype):
    """Path B: deploy (int8 weights), then every stride-1 3x3 binary conv as
    ``DeployedConv(mode="pallas-conv")``, BN folds, the space-to-depth stem
    and floats cast to ``dtype``; no stage or block pass."""
    from bnn_tpu_torch import layers
    from bnn_tpu_torch.binarize import set_module_by_name
    from bnn_tpu_torch.inference import (DeployedConv, deploy,
                                         optimize_deployed, space_to_depth_stem)
    from bnn_tpu_torch.utils import cast_floats

    model = deploy(copy.deepcopy(qat), weight_format="int8")
    for name, m in qat.named_modules():
        if (isinstance(m, layers.Conv2d) and tuple(m.kernel_size) == (3, 3)
                and tuple(m.stride) == (1, 1)):
            set_module_by_name(model, name, DeployedConv(
                m, mode="pallas-conv", weight_format="int8"))
    optimize_deployed(model)
    space_to_depth_stem(model)
    if dtype is not None:
        cast_floats(model, dtype)
    return model.eval()


class Served:
    """A deployed model served as ``Predictor`` serves it: requests padded
    and split into ``batch_size`` forwards on ``device``."""

    def __init__(self, model, batch_size, device, dtype):
        self.model = model.to(device)
        self.batch_size, self.device, self.dtype = batch_size, device, dtype

    @torch.no_grad()
    def __call__(self, x):
        from bnn_tpu_torch.inference import batched_call

        x = torch.as_tensor(x).to(device=self.device, dtype=self.dtype)
        return batched_call(self.model, x, self.batch_size)


def plus_share(values) -> tuple:
    """(share of +1 over all, [share of each call]) of (number of +1 signs,
    number of signs) pairs."""
    shares = [p / t for p, t in values]
    return sum(p for p, _ in values) / sum(t for _, t in values), shares


def check_share(name, values) -> float:
    """The share of +1 signs at a kernel's inputs over one forward, held in
    [5%, 95%] so that a degenerate net (every sign alike) cannot pass."""
    share, per_call = plus_share(values)
    print(f"phase 3: {name}: share of +1 signs at the kernel's inputs "
          f"{100 * share:.1f}% over {len(per_call)} calls (each call "
          f"{100 * min(per_call):.1f}-{100 * max(per_call):.1f}%)")
    if not 0.05 <= share <= 0.95:
        raise AssertionError(f"{name}: degenerate signs, {100 * share:.1f}% +1")
    return share


def stem_chain_bound(xh, w, bias, blocks, out_numel, out_size):
    """Least time of a fused_stem_chain call: the input, stem weights, bias,
    blocks and output once, against the stem's bf16 operations plus the
    blocks' int8 operations, each at its type's peak."""
    n, h, ws, c = xh.shape
    moved = (nbytes(xh, w, *([bias] if bias is not None else []))
             + sum(block_bytes(b) for b in blocks) + out_numel * out_size)
    stem_ops = 2 * n * (h // 2) * (ws // 2) * w.shape[-1] * 49 * c
    int8_ops = sum(2 * 2 * n * (h // 4) * (ws // 4) * b.co * 9 * b.ci for b in blocks)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = (stem_ops / PEAK_OPS_PER_S[torch.bfloat16]
             + int8_ops / PEAK_OPS_PER_S[torch.int8]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed_row(fns: dict) -> dict:
    """{name: (device ms, ms per call)}; plain versions get fewer runs."""
    out = {}
    for name, fn in fns.items():
        few = name == "plain"
        out[name] = ((device_ms(fn, iters=3), cuda_ms(fn, iters=3, warmup=1)) if few
                     else (device_ms(fn), cuda_ms(fn)))
    return out


def print_rows(kname, rows, card, library):
    """Print each timed shape of a kernel; return its sums over one forward
    (each shape times its calls): ms, plain, library, bound, bound_by. A
    row's times may leave out the plain version."""
    tot = dict(ms=0.0, plain=0.0, library=0.0, bound=0.0, by_bytes=0.0)
    for label, calls, t, (bound, by) in rows:
        plain = (f"; plain {t['plain'][0] * 1e3:.1f} us device / "
                 f"{t['plain'][1] * 1e3:.1f} us per call" if "plain" in t else "")
        lib = (f"; library {library} {t['library'][0] * 1e3:.2f} us device"
               if "library" in t else "; library: none (no single call)")
        print(f"phase 4: {label} x{calls} per forward: kernel "
              f"{t['kernel'][0] * 1e3:.2f} us device / {t['kernel'][1] * 1e3:.2f} us "
              f"per call{plain}{lib}; bound {bound * 1e3:.3f} us ({by}) | {card}")
        tot["ms"] += calls * t["kernel"][0]
        tot["plain"] += calls * t.get("plain", (0.0,))[0]
        tot["library"] += calls * t.get("library", (0.0,))[0]
        tot["bound"] += calls * bound
        tot["by_bytes"] += calls * bound * (by == "bytes")
    tot["by"] = "bytes" if 2 * tot["by_bytes"] >= tot["bound"] else "operations"
    plain = (f", plain {tot['plain'] * 1e3:.1f} us"
             if all("plain" in r[2] for r in rows) else "")
    lib = f", library {library} {tot['library'] * 1e3:.2f} us" if library else ""
    print(f"phase 4: {kname} summed over one forward: {tot['ms'] * 1e3:.2f} us "
          f"device{plain}{lib}, bound {tot['bound'] * 1e3:.3f} us "
          f"({tot['by']}) | {card}")
    return tot


# phase 5's training cases: (label, make_train_step options, batch, steps)
TRAIN_CASES = [
    ("a: f32, batch 64 (cuDNN deterministic)", {}, 64, 5),
    ("b: bf16 compute, batch 256", {"compute_dtype": torch.bfloat16}, 256, 5),
    ("c: bf16 compute, batch 256, accum_steps=4",
     {"compute_dtype": torch.bfloat16, "accum_steps": 4}, 256, 5),
    ("d: bf16 compute, batch 256, remat",
     {"compute_dtype": torch.bfloat16, "remat": True}, 256, 5),
    ("e: StochasticInputBinarizer, f32, batch 64", {}, 64, 2),
]
WARMUP_STEPS = 2


def adamw(model):
    """The optimizer of the trainer's default (examples/imagenet.py)."""
    return torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)


def rel_max(got, want, scale=None) -> float:
    """max |got - want| over max |want| (or over ``scale``)."""
    want = want.detach().double().cpu()
    scale = want.abs().max().item() if scale is None else scale
    return (got.detach().double().cpu() - want).abs().max().item() / (scale + 1e-12)


def rel_l2(got, want) -> float:
    want = want.detach().double().cpu()
    return ((got.detach().double().cpu() - want).norm() / (want.norm() + 1e-12)).item()


def first_step_on_card_vs_cpu(make_train_step, images, labels, dev):
    """One step of the all-Identity (fp32) config at full width, batch 8, on
    the card and on the CPU from the same weights. In f32 the losses agree
    within 1e-4 relative. The parameters are held in float64, within 1e-4
    relative L2: in f32 this network's gradients at its start are
    ill-conditioned (the train-mode BN backwards of layers 3-4 cancel most
    of their digits, on the CPU and on the card alike), and AdamW's first
    step, about lr * sign(g) an element, turns that noise into flips of
    whole updates."""
    from bnn_tpu_torch.ops import Identity

    model = flagship(torch.Generator().manual_seed(SEED + 9),
                     binarizers=(Identity, Identity, Identity)).train()
    grads = {}
    for dtype in (torch.float32, torch.float64):
        runs = {}
        for name, device in (("cpu", "cpu"), ("card", dev)):
            m = copy.deepcopy(model).to(device, dtype)
            out = make_train_step()(m, adamw(m), images[:8].to(dtype), labels[:8])
            runs[name] = (out["loss"].item(), dict(m.named_parameters()))
            grads[name, dtype] = {k: p.grad for k, p in m.named_parameters()}
        (lc, pc), (lg, pg) = runs["cpu"], runs["card"]
        loss_err = abs(lg - lc) / abs(lc)
        worst = max((rel_l2(pg[k], p), k) for k, p in pc.items())
        held = dtype == torch.float64
        print(f"phase 5: first step, fp32 (all-Identity) config, batch 8, {dtype}: loss "
              f"card {lg:.7f} cpu {lc:.7f} (relative {loss_err:.3g}, limit 1e-4); worst "
              f"parameter after the step {worst[1]} relative L2 {worst[0]:.3g} "
              f"({'limit 1e-4' if held else 'not held in f32'}) over {len(pc)} parameters")
        if loss_err > 1e-4 or (held and worst[0] > 1e-4):
            raise AssertionError("the first training step on the card differs from the CPU's")
    for name in ("cpu", "card"):
        g32, g64 = grads[name, torch.float32], grads[name, torch.float64]
        worst = max((rel_max(g32[k], g), k) for k, g in g64.items())
        print(f"phase 5: first step on the {name}: f32 gradients against float64's, worst "
              f"{worst[1]} {worst[0]:.3g} (max |diff| over max |float64|)")


def block_grads_on_card_vs_cpu(gen, dev):
    """Train-mode gradients through layer1.0 and layer2.0 of the binary
    flagship on the card and on the CPU: input gradients within 1e-4 and
    each parameter's within 2e-2 (max |diff| over max |CPU|; an output scale
    ``convN...alpha`` over ``bnN.weight``'s, since the train-mode BN after
    the conv makes the loss invariant to it)."""
    model = flagship(torch.Generator().manual_seed(SEED + 10)).train()
    x = torch.randn((8, 64, 56, 56), generator=gen)
    for name in ("layer1.0", "layer2.0"):
        block = model.get_submodule(name)
        grads = {}
        for device in ("cpu", dev):
            b = copy.deepcopy(block).to(device)
            xi = x.detach().to(device).requires_grad_(True)
            out = b(xi)
            if device == "cpu":
                r = torch.randn(out.shape, generator=gen)
            out.backward(r.to(device))
            grads[str(device)] = (xi.grad, {k: p.grad for k, p in b.named_parameters()})
        (gx_c, gp_c), (gx_g, gp_g) = grads["cpu"], grads[str(dev)]
        x_err = rel_max(gx_g, gx_c)
        errs = {}
        for k, g in gp_c.items():
            ref = gp_c.get(k.split(".")[0].replace("conv", "bn") + ".weight")
            scale = (ref.abs().max().item() if k.endswith(".alpha") and ref is not None
                     else None)
            errs[k] = rel_max(gp_g[k], g, scale)
        worst = max((v, k) for k, v in errs.items())
        print(f"phase 5: binary flagship {name} train-mode gradients, card vs CPU: "
              f"input {x_err:.3g} (limit 1e-4), worst parameter {worst[1]} "
              f"{worst[0]:.3g} (limit 2e-2)")
        if x_err > 1e-4 or worst[0] > 2e-2:
            raise AssertionError(f"{name}: gradients on the card differ from the CPU's")


def train_case(make_train_step, model, opts, x, y, steps, label, card,
               profile: bool = False, opt=None, phase: int = 5, after_step=None):
    """``steps`` steps on one fixed batch, each timed by CUDA events; returns
    (losses, ms a step after the warm-up steps or None, peak bytes, the
    optimizer). ``opt`` defaults to :func:`adamw`; ``after_step(i)`` runs
    after step ``i``. With
    ``profile``, five more steps follow, the last two under torch.profiler:
    the device busy share of a step and the kernels that take the time."""
    opt = adamw(model) if opt is None else opt
    step = make_train_step(**opts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, losses = [], []
    for i in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(step(model, opt, x, y)["loss"])
        end.record()
        events.append((start, end))
        if after_step is not None:
            after_step(i)
    torch.cuda.synchronize()
    losses = [v.item() for v in losses]
    times = [s.elapsed_time(e) for s, e in events]
    peak = torch.cuda.max_memory_allocated()
    timed = times[WARMUP_STEPS:]
    ms = sum(timed) / len(timed) if timed else None
    rate = (f"{ms:.2f} ms a step (mean of steps {WARMUP_STEPS + 1}-{steps}), "
            f"{x.shape[0] / ms * 1e3:.1f} images/s" if ms is not None
            else f"not timed after warm-up ({steps} steps; step times "
                 f"{[round(t, 2) for t in times]} ms)")
    print(f"phase {phase}: case {label}: losses {[round(v, 5) for v in losses]}; {rate}; "
          f"peak memory {peak / 2**30:.2f} GiB | {card}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"case {label}: a loss is not finite")
    if profile:
        by_kernel, wall = device_profile(lambda: step(model, opt, x, y), iters=2,
                                         whole=False)
        busy = sum(by_kernel.values())
        print(f"phase {phase}: case {label}: device busy {busy:.2f} ms a step, "
              f"{100 * busy / wall:.1f}% of its {wall:.2f} ms under the profiler; by "
              "device time:")
        for kname, kms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
            print(f"phase {phase}:   {kms:8.3f} ms  {kname[:100]}")
    return losses, ms, peak, opt


@contextlib.contextmanager
def cudnn_deterministic():
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def first_steps_equal(make_train_step, base, x, y, dev):
    """Case (d)'s first step equals case (b)'s from the same start, with
    cuDNN deterministic: loss and every parameter and buffer within 1e-6
    (max |diff| over max |plain|), so remat wrote the BN statistics once."""
    runs = []
    with cudnn_deterministic():
        for remat in (False, True):
            m = copy.deepcopy(base).to(dev)
            out = make_train_step(compute_dtype=torch.bfloat16, remat=remat)(
                m, adamw(m), x, y)
            runs.append((out["loss"].item(), m.state_dict()))
            del m
    (l0, s0), (l1, s1) = runs
    errs = {k: rel_max(s1[k].float(), s0[k].float()) for k in s0}
    worst = max((v, k) for k, v in errs.items())
    loss_err = abs(l1 - l0) / abs(l0)
    print(f"phase 5: remat's first step vs the plain step (bf16, batch 256, cuDNN "
          f"deterministic): loss {l1:.7f} vs {l0:.7f} (relative {loss_err:.3g}); "
          f"worst state tensor {worst[1]} {worst[0]:.3g} (limit 1e-6) over {len(s0)}")
    if loss_err > 1e-6 or worst[0] > 1e-6:
        raise AssertionError("remat's first step differs from the plain step")


def train_phase(kernels, Predictor, dev, card) -> tuple:
    """Phase 5: QAT training of the flagship at full width on the card, then
    its trained weights served; returns the serving runs' launches, and case
    (a)'s trained model and optimizer, which phase 6 checkpoints."""
    from bnn_tpu_torch.ops import (BasicScaleBinarizer, StochasticInputBinarizer,
                                   XNORWeightBinarizer)
    from bnn_tpu_torch.parallel import make_train_step

    gen = torch.Generator().manual_seed(SEED + 7)
    images = torch.randn((256, 3, SIZE, SIZE), generator=gen)
    labels = torch.randint(0, 1000, (256,), generator=gen)
    first_step_on_card_vs_cpu(make_train_step, images, labels, dev)
    block_grads_on_card_vs_cpu(gen, dev)

    xd, yd = images.to(dev), labels.to(dev)
    base = flagship(torch.Generator().manual_seed(SEED + 8)).train()
    first_steps_equal(make_train_step, base, xd, yd, dev)
    results, trained = {}, None
    for label, opts, batch, steps in TRAIN_CASES:
        if label.startswith("e"):
            model = flagship(torch.Generator().manual_seed(SEED + 8), binarizers=(
                StochasticInputBinarizer, BasicScaleBinarizer, XNORWeightBinarizer))
            model = model.train().to(dev)
        else:
            model = copy.deepcopy(base).to(dev)
        # case (a) trains the weights phase 5 serves: with cuDNN
        # deterministic they are the same in every run, so the serving check
        # below meets the same weights each time, as phase 3's does
        with cudnn_deterministic() if label.startswith("a") else contextlib.nullcontext():
            results[label] = train_case(make_train_step, model, opts, xd[:batch],
                                        yd[:batch], steps, label, card,
                                        profile=label[0] in "bcd")
        if label.startswith("a"):
            trained = model
        elif label.startswith("e"):
            gens = [m.generator(xd.device) for m in model.modules()
                    if isinstance(m, StochasticInputBinarizer)]
            if not gens or any(g.device != xd.device for g in gens):
                raise AssertionError("case e: a binarizer drew its noise off the card")
            print(f"phase 5: case e: {len(gens)} stochastic binarizers, each with its "
                  f"own generator on {xd.device}")
        if model is not trained:
            del model
        torch.cuda.empty_cache()
    losses_b = results[TRAIN_CASES[1][0]][0]
    if not losses_b[-1] < losses_b[0]:
        raise AssertionError(f"case b: 5 steps on one batch did not lower the loss: "
                             f"{losses_b}")

    # the trained weights (case a), served; launch counts as in phase 3
    trained.eval()
    launches = dict.fromkeys(KERNELS, 0)
    cpu_model = copy.deepcopy(trained).cpu()
    served = images[:16]
    for b, requests, want in (
            (1, (served[:1], served[1:3]), {"fused_stem": 1, "fused_chain": 4}),
            (8, (served[:8], served[8:11]), R18_8)):
        pred = Predictor(copy.deepcopy(trained), batch_size=b, dtype=None)
        _, counted = serve_counted(
            kernels, pred, requests,
            f"trained ResNet-18 (case a) Predictor(batch_size={b}) f32", want, phase=5)
        for k, v in counted.items():
            launches[k] += v
        check_trained_serving(pred, Predictor(copy.deepcopy(cpu_model), batch_size=b,
                                              dtype=None, device="cpu"),
                              served[:8], b)
    return launches, trained, results[TRAIN_CASES[0][0]][3]


def check_trained_serving(pred, ref_pred, images, b, phase: int = 5,
                          name: str = "trained ResNet-18",
                          stem=lambda model: model.conv1):
    """The card's f32 ``Predictor`` against the plain versions of the same
    path on the CPU. A ternary sign flips wherever the stem's f32 sum lands
    within its rounding of 0, and a flip moves the logits by far more than
    1e-3; so the stem is held to its phase-2 bound (1e-5) on each forward's
    input, and the CPU's forward goes on from the card's stem output, which
    holds every later kernel on the same input (1e-3, argmax equal). The
    logits of the CPU's own stem are printed beside them. ``stem`` picks the
    module whose output is fed: the model's first float layer (its float
    stem, or the stem's first conv where binary convs follow inside it)."""
    stems = []
    hook = stem(pred.model).register_forward_hook(
        lambda mod, args, out: stems.append(out.detach().cpu()))
    got = pred(images).cpu()
    hook.remove()
    own = ref_pred(images)
    feed, stem_err = iter(stems), []

    def swap(mod, args, out):
        card = next(feed)
        stem_err.append((card - out).abs().max().item())
        return card

    hook = stem(ref_pred.model).register_forward_hook(swap)
    ref = ref_pred(images)
    hook.remove()
    per_image = (got - own).abs().amax(1)
    print(f"phase {phase}: {name} batch {b}: stem on the card vs the CPU max |err| "
          f"{max(stem_err):.3g} (limit 1e-5) over {len(stem_err)} forwards; logits "
          f"from the CPU's own stem differ by up to {per_image.max().item():.3g} "
          f"({int((per_image > 1e-3).sum())} of {len(per_image)} images over 1e-3)")
    if max(stem_err) > 1e-5:
        raise AssertionError(f"{name} batch {b}: the stem on the card "
                             "differs from its plain version")
    check_f32(pred, ref, images, f"{name} batch {b}, from the card's stem",
              phase=phase)


ROOT = pathlib.Path(__file__).resolve().parent
# phase 6 writes its checkpoint here, inside the checkout (the directory is
# ignored by git and removed at the end of the phase)
SMOKE_DIR = ROOT / ".smoke"
STREAM_REQUESTS = 256


def card_mb() -> float:
    """MB of tensors the caching allocator holds on the card now."""
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated() / 1e6


def checkpoint_round_trip(trained, opt, dev, card, path) -> None:
    """Phase 6 (a): case (a)'s trained flagship and its AdamW through
    save_checkpoint and load_checkpoint into a fresh flagship and AdamW:
    every parameter and buffer bit-identical, then one more step of each
    pair on one batch (cuDNN deterministic), bit-identical again."""
    from bnn_tpu_torch.parallel import make_train_step
    from bnn_tpu_torch.utils import (load_checkpoint, restore_into,
                                     restore_optimizer, save_checkpoint)

    t0 = time.perf_counter()
    save_checkpoint(path, trained, opt_state=opt, metadata={"step": 5})
    payload = load_checkpoint(path)
    io_s = time.perf_counter() - t0
    if payload["metadata"] != {"step": 5}:
        raise AssertionError(f"checkpoint metadata {payload['metadata']}")
    fresh = flagship(torch.Generator().manual_seed(SEED + 11)).to(dev)
    restore_into(fresh, payload)
    fresh_opt = adamw(fresh)
    restore_optimizer(fresh_opt, payload)

    def differing(a, b):
        sa, sb = a.state_dict(), b.state_dict()
        return [k for k in sa if not torch.equal(sa[k], sb[k])]

    def opt_differing(a, b):
        return [i for i, (x, y) in enumerate(zip(a.state.values(), b.state.values()))
                if any(not torch.equal(x[k], y[k]) for k in x)]

    restored = differing(fresh, trained)
    gen = torch.Generator().manual_seed(SEED + 12)
    x = torch.randn((64, 3, SIZE, SIZE), generator=gen).to(dev)
    y = torch.randint(0, 1000, (64,), generator=gen).to(dev)
    step = make_train_step()
    trained.train()
    fresh.train()
    with cudnn_deterministic():
        loss = step(trained, opt, x, y)["loss"].item()
        loss_r = step(fresh, fresh_opt, x, y)["loss"].item()
    stepped = differing(fresh, trained) + [f"moments {i}" for i in opt_differing(fresh_opt, opt)]
    n = len(trained.state_dict())
    print(f"phase 6: checkpoint of the trained flagship and its AdamW "
          f"({(pathlib.Path(path) / 'checkpoint.pt').stat().st_size / 1e6:.1f} MB, saved "
          f"and loaded in {io_s:.2f} s): restored into a fresh flagship, "
          f"{n - len(restored)} of {n} state tensors bit-identical; one more step of each "
          f"pair (cuDNN deterministic): loss {loss:.7f} vs {loss_r:.7f}, "
          f"{n - len([k for k in stepped if not k.startswith('moments')])} of {n} state "
          f"tensors and {len(opt.state) - len(opt_differing(fresh_opt, opt))} of "
          f"{len(opt.state)} parameters' moments bit-identical | {card}")
    if restored or stepped or loss != loss_r:
        raise AssertionError(f"checkpoint: restored state differs at {restored[:5]}, "
                             f"after a step at {stepped[:5]}")


def served_from_checkpoint(kernels, Predictor, path, b, requests, want, images,
                           card) -> tuple:
    """Phase 6 (b) and (c) at one batch size: the checkpoint through
    ``Predictor.from_checkpoint`` with the int8 head, its launches, its
    logits against the unquantized predictor of the same weights, its f32
    build against the plain versions on the CPU, and the bytes each holds.
    Returns (the quantized bf16 predictor, its launches)."""
    from bnn_tpu_torch.inference import (QuantizedLinear, model_weight_bytes,
                                         packed_weight_bytes)

    build = lambda: flagship(torch.Generator().manual_seed(SEED + 11))  # noqa: E731
    held = {}
    preds = {}
    for name, kw in (("int8 head", {"quantize_float_bits": 8}), ("bf16 head", {})):
        before = card_mb()
        preds[name] = Predictor.from_checkpoint(path, build, batch_size=b, **kw)
        built = card_mb() - before
        preds[name](requests[0])
        held[name] = (built, card_mb() - before)
    q, u = preds["int8 head"], preds["bf16 head"]
    if not isinstance(q.served_model().fc, QuantizedLinear) or \
            q.model.layer4.head_fc is not None:
        raise AssertionError("the int8 head is not the served model's fc")
    label = f"Predictor.from_checkpoint(batch_size={b}, quantize_float_bits=8) bf16"
    outs, launches = serve_counted(kernels, q, requests, label, want, phase=6)
    got = torch.cat([o.float() for o in outs])
    ref = torch.cat([u(r).float() for r in requests])
    err = ((got - ref).abs().max() / ref.abs().max()).item()
    agree = (got.argmax(1) == ref.argmax(1)).float().mean().item()
    print(f"phase 6: batch {b}: int8 head vs the bf16 head of the same weights: max "
          f"|diff| over max |logit| {err:.3g} (limit 0.02); top-1 agreement "
          f"{100 * agree:.1f}% of {got.shape[0]} images")
    if not err < 0.02:
        raise AssertionError(f"batch {b}: the int8 head is {err:.3g} off the bf16 one")
    check_trained_serving(
        Predictor.from_checkpoint(path, build, batch_size=b, quantize_float_bits=8,
                                  dtype=None),
        Predictor.from_checkpoint(path, build, batch_size=b, quantize_float_bits=8,
                                  dtype=None, device="cpu"),
        images[:8], b, phase=6, name="checkpoint with the int8 head, f32,")
    for name, p in preds.items():
        print(f"phase 6: batch {b}, {name}: state_bytes {p.state_bytes()} B, "
              f"packed_weight_bytes {packed_weight_bytes(p.model)} B, "
              f"model_weight_bytes {model_weight_bytes(p.model)} B; card memory "
              f"{held[name][0]:.3f} MB after the build, {held[name][1]:.3f} MB after "
              f"its first forward | {card}")
    print(f"phase 6: batch {b}: the int8 head saves {u.state_bytes() - q.state_bytes()} B "
          f"of state and {held['bf16 head'][1] - held['int8 head'][1]:.3f} MB of card "
          "memory")
    # the forward with each head: profiled once, then timed in turns
    xb = images[:b].to(q.device)
    for name, p in preds.items():
        forward_times(p, xb, card, f"Predictor.from_checkpoint(batch_size={b}), {name}, "
                      f"bf16 {SIZE}x{SIZE}", phase=6)
    turns = {name: [] for name in preds}
    for order in (("bf16 head", "int8 head"), ("int8 head", "bf16 head")):
        for name in order:
            turns[name].append(fwd_ms(preds[name], xb))
    print(f"phase 6: batch {b} forward in turns (bf16, int8, int8, bf16): "
          + "; ".join(f"{name} {[round(v, 3) for v in ms]} ms"
                      for name, ms in turns.items()) + f" | {card}")
    return q, launches


def run_stream(pred, requests, rps: float, seed: int):
    """``requests`` as single-image submissions to a ContinuousBatcher over
    ``pred`` (max_delay 5 ms), Poisson arrivals at ``rps`` (all at once
    with ``rps=None``); returns (rows of each request, stats, wall seconds
    to the last result)."""
    from bnn_tpu_torch.inference import ContinuousBatcher

    rng = torch.Generator().manual_seed(seed)
    gaps = ([0.0] * len(requests) if rps is None else
            torch.empty(len(requests)).exponential_(rps, generator=rng).tolist())
    with ContinuousBatcher(pred, max_delay_ms=5.0) as srv:
        t0 = time.perf_counter()
        futs = []
        for r, gap in zip(requests, gaps):
            futs.append(srv.submit(r))
            if gap:
                time.sleep(gap)
        outs = [f.result(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
        stats = srv.stats()
    return outs, stats, wall


def stream_phase(kernels, pred, dev, card) -> dict:
    """Phase 6 (d): 256 single-image requests through the continuous batcher
    over the batch-8 predictor with the int8 head, at 200 requests/s
    (serve.py's default) and at 80% of the predictor's capacity (8 images
    over one forward's latency), then all at once (the batcher's own
    ceiling, with no arrivals to wait for): each request's rows against a
    direct call, images/s, batches, occupancy, p50 and p99 latency, the
    launches, and the device busy share over a second run of each under
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(SEED + 13)
    requests = list(torch.randn((STREAM_REQUESTS, 1, 3, SIZE, SIZE), generator=gen))
    direct = [pred(r).float().cpu() for r in requests]
    xb = requests[0].expand(BATCH, -1, -1, -1).contiguous().to(dev)
    fwd = fwd_ms(pred, xb)
    capacity = BATCH / fwd * 1e3
    # the same forward timed from another thread, as the dispatcher runs it
    worker_ms = []
    worker = threading.Thread(target=lambda: worker_ms.append(fwd_ms(pred, xb)))
    worker.start()
    worker.join(timeout=300)
    if worker.is_alive() or not worker_ms:
        raise AssertionError("the forward timed from a worker thread did not finish")
    print(f"phase 6: batch-8 forward with the int8 head: {fwd:.3f} ms from the main "
          f"thread, {worker_ms[0]:.3f} ms from a worker thread | {card}")
    launches = dict.fromkeys(KERNELS, 0)
    for label, rps in (("200 rps", 200.0), ("80% of capacity", 0.8 * capacity),
                       ("once", None)):
        for k in KERNELS:
            getattr(kernels, k).launches = 0
        outs, st, wall = run_stream(pred, requests, rps, SEED)
        counted = {k: getattr(kernels, k).launches for k in KERNELS}
        want = {k: st.batches * R18_8.get(k, 0) for k in KERNELS}
        if counted != want:
            raise AssertionError(f"stream at {label}: launches {counted}, expected {want}")
        for k, v in counted.items():
            launches[k] += v
        err = max((o.float() - d).abs().max().item() for o, d in zip(outs, direct))
        equal = sum(torch.equal(o.float(), d) for o, d in zip(outs, direct))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, _, pwall = run_stream(pred, requests, rps, SEED + 1)
        busy = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == DeviceType.CUDA) / 1e3
        offered = "all submitted at once" if rps is None else f"{rps:.1f} rps offered"
        print(f"phase 6: stream of {st.requests} single-image requests at {label} "
              f"({offered}; capacity {capacity:.1f} images/s from a "
              f"{fwd:.3f} ms forward): {st.rows / wall:.1f} images/s, {st.batches} "
              f"batches ({1e3 * wall / st.batches:.2f} ms each), occupancy "
              f"{100 * st.mean_occupancy:.1f}%, latency p50 "
              f"{st.latency_percentile(50):.3f} ms, p99 {st.latency_percentile(99):.3f} "
              f"ms; rows against direct calls max |diff| {err:.3g} (limit 1e-5), "
              f"{equal} of {len(outs)} bit-identical; launches {counted}; device busy "
              f"{busy:.1f} ms of a {1e3 * pwall:.1f} ms profiled run "
              f"({100 * busy / (1e3 * pwall):.1f}%) | {card}")
        if err > 1e-5:
            raise AssertionError(f"stream at {label}: rows differ from direct calls by {err}")
    return launches


def serve_cli(path, card) -> None:
    """Phase 6 (e): ``python -m bnn_tpu_torch.examples.serve`` on the card from
    the checkpoint, batched requests and a continuous stream; each must exit
    0."""
    for extra in ([], ["--continuous"]):
        cmd = [sys.executable, "-m", "bnn_tpu_torch.examples.serve", "--ckpt", path,
               "--requests", "4", *extra]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=600)
        flag = " ".join(["--ckpt", "--requests 4", *extra])
        for line in run.stdout.splitlines():
            print(f"phase 6: serve CLI ({flag}): {line}")
        print(f"phase 6: serve CLI ({flag}) exited {run.returncode} after "
              f"{time.perf_counter() - t0:.1f} s | {card}")
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"the serve CLI ({flag}) exited {run.returncode}")


def serve_phase(kernels, Predictor, dev, card, trained, opt, images) -> dict:
    """Phase 6: serving as examples/serve.py runs it; returns the launches of
    its counted serving runs."""
    path = str(SMOKE_DIR / "flagship")
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    launches = dict.fromkeys(KERNELS, 0)
    try:
        checkpoint_round_trip(trained, opt, dev, card, path)
        served = {}
        for b, requests, want in (
                (1, (images[:1], images[1:3]), {"fused_stem": 1, "fused_chain": 4}),
                (8, (images[:8], images[8:11]), R18_8)):
            served[b], counted = served_from_checkpoint(kernels, Predictor, path, b,
                                                        requests, want, images, card)
            for k, v in counted.items():
                launches[k] += v
        for k, v in stream_phase(kernels, served[8], dev, card).items():
            launches[k] += v
        serve_cli(path, card)
    finally:
        shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    return launches


# phase 7 loads each bundle in a fresh process that builds no model: it
# runs the saved input through the bundle and counts the kernels a forward
# launches, by their names in a torch.profiler trace
BUNDLE_LOADER = r"""
import json, re, sys, time
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from bnn_tpu_torch.inference import load_serving
KERNELS, ITERS = json.loads(sys.argv[1]), 3
pattern = re.compile(r"(?:^|[^A-Za-z0-9_])(" + "|".join(KERNELS) + r")_kernel\b")
for where in sys.argv[2:]:
    t0 = time.perf_counter()
    server = load_serving(where + "/bundle")
    load_s = time.perf_counter() - t0
    x, want = torch.load(where + "/io.pt")
    got = server(x).cpu()
    attempts = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                server(x)
            torch.cuda.synchronize()
        counts = {}
        for e in prof.events():
            m = pattern.search(e.name) if e.device_type == DeviceType.CUDA else None
            if m:
                counts[m.group(1)] = counts.get(m.group(1), 0) + 1
        attempts.append({k: v / ITERS for k, v in counts.items()})
    server(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        server(x)
    torch.cuda.synchronize()
    print(json.dumps({"where": where, "equal": bool(torch.equal(got, want)),
                      "max_abs": float((got.float() - want.float()).abs().max()),
                      "load_s": load_s, "launches": attempts,
                      "forward_ms": (time.perf_counter() - t0) / 10 * 1e3,
                      "state_bytes": server.state_bytes()}), flush=True)
"""


def op_cases(kernels, gen, dev):
    """{operator: arguments} at one phase-2 case each, CUDA tensors, bf16
    activations and rows, as the serving paths give them."""
    bf = torch.bfloat16

    def vec(n, loc=0.0):
        return (loc + 0.3 * torch.randn(n, generator=gen)).to(dev)

    x = torch.randint(-1, 2, (392, 256), generator=gen).to(dev, bf)
    wp = kernels.pack_bits(torch.randn((256, 512), generator=gen), axis=-2).to(dev)
    xc = torch.randn((8, 56, 56, 64), generator=gen).to(dev, bf)
    wc = pm1((64, 64, 3, 3), gen).to(dev).permute(2, 3, 1, 0)
    xs = torch.randn((1, SIZE, SIZE, 3), generator=gen).to(dev, bf)
    ws = (0.1 * torch.randn((7, 7, 3, 64), generator=gen)).to(dev, bf)
    chain = [rand_block(kernels, "down", 64, 128, gen, dev, bf, options=True),
             rand_block(kernels, "basic", 128, 128, gen, dev, bf, options=True)]
    layer1 = [rand_block(kernels, "basic", 64, 64, gen, dev, bf, options=False)
              for _ in range(2)]
    basic = rand_block(kernels, "basic", 512, 512, gen, dev, bf, options=False)
    w1, w2, w3, kw = rand_bottleneck(256, 64, 256, gen, dev, bf, prelu=True,
                                     thresholds=True)
    tail = ("relu", "relu", False, False, None)
    p, q = basic.prm, None
    cases = {
        "binary_gemm": (x, wp, 256, vec(512, 1.0), vec(512), False),
        "popcount_gemm": (kernels.pack_bits(x, axis=-1), wp, 256, vec(512, 1.0),
                          vec(512)),
        "binary_conv2d_s1": (xc, wc, vec(64, 1.0), vec(64)),
        "fused_stem": (xs, ws, ws[0, 0, 0]),
        "fused_chain": (torch.randn((1, 56, 56, 64), generator=gen).to(dev, bf),
                        *kernels.model.flatten(chain), None, None, "prelu", "prelu",
                        False, True, None),
        "fused_stem_chain": (xs, ws, ws[0, 0, 0], *kernels.model.flatten(layer1),
                             *tail),
        "fused_basic_block": (torch.randn((1, 7, 7, 512), generator=gen).to(dev, bf),
                              basic.w1.reshape(3, 3, 512, 512),
                              basic.w2.reshape(3, 3, 512, 512), p[0], p[1], p[3],
                              p[4], q, q, q, q, *tail),
        "fused_downsample_block": (
            torch.randn((1, 14, 14, 256), generator=gen).to(dev, bf),
            pm1((3, 3, 256, 512), gen).to(dev), pm1((3, 3, 512, 512), gen).to(dev),
            pm1((256, 512), gen).to(dev), *[vec(512, v) for v in (1, 0, 1, 0, 1, 0)],
            q, q, q, q, q, *tail),
        "fused_bottleneck": (
            torch.randn((1, 56, 56, 256), generator=gen).to(dev, bf), w1, w2, w3,
            None, [kw.get(r) for r in kernels.bottleneck.ROWS], "prelu", "prelu",
            "prelu", True, None),
    }
    # drawn after the others, which stay as they were
    cases["binary_conv2d"] = (
        torch.randn((8, 56, 56, 64), generator=gen).to(dev, bf),
        kernels.pack_bits(pm1((128, 64, 3, 3), gen).float(), axis=1).to(dev),
        vec(64).to(bf), vec(128, 1.0).to(bf), vec(128).to(bf), [2, 2], [1, 1], False)
    return cases


def route_costs(card) -> None:
    """Phase 7 (c): host time of one call through each registration route,
    on an operator whose CUDA implementation allocates its output and
    launches nothing: a plain Python call, ``torch.library.Library``
    (``DEF`` + ``impl``, the port's route) and
    ``@torch.library.custom_op``."""
    lib = torch.library.Library("bnn_smoke", "DEF")
    lib.define("empty_like(Tensor x) -> Tensor")

    def empty_like(x: torch.Tensor) -> torch.Tensor:
        return torch.empty_like(x)

    lib.impl("empty_like", empty_like, "CUDA")
    custom = torch.library.custom_op("bnn_smoke::empty_like_custom", empty_like,
                                     mutates_args=())
    x = torch.zeros(4, device="cuda")
    us = {name: [] for name in ("python call", "Library DEF + impl", "custom_op")}
    for _ in range(3):
        for name, fn in (("python call", lambda: empty_like(x)),
                         ("Library DEF + impl",
                          lambda: torch.ops.bnn_smoke.empty_like(x)),
                         ("custom_op", lambda: custom(x))):
            us[name].append(1e3 * host_ms(fn, iters=2000))
    print("phase 7: host us per call of an operator that allocates its output, "
          "in turns: " + "; ".join(
              f"{k} {[round(v, 2) for v in vs]}" for k, vs in us.items())
          + f" | {card}")


def dispatch_costs(kernels, cases, card) -> None:
    """Phase 7 (c): host time per call of each kernel operator through the
    dispatcher beside its CUDA implementation called directly, on the same
    CUDA arguments (the implementation's arguments kept): what operator
    dispatch costs a call."""
    from bnn_tpu_torch.kernels import ops

    rows = []
    for name, args in cases.items():
        op = getattr(torch.ops.bnn_tpu_torch, name)
        impl = ops.OPS[name][0]
        t = {"op": [], "impl": []}
        for _ in range(2):
            t["op"].append(1e3 * host_ms(lambda: op(*args), iters=200))
            t["impl"].append(1e3 * host_ms(lambda: impl(*args), iters=200))
        d = min(t["op"]) - min(t["impl"])
        rows.append(d)
        print(f"phase 7: {name}: host us per call through the operator "
              f"{[round(v, 2) for v in t['op']]}, its CUDA implementation called "
              f"directly {[round(v, 2) for v in t['impl']]}: dispatch {d:.2f} us "
              f"| {card}")
    print(f"phase 7: operator dispatch over the ten kernels: {min(rows):.2f} to "
          f"{max(rows):.2f} us a call | {card}")


def export_and_load(root, paths, card, phase: int) -> None:
    """Export each ``{name: (predictor, launches per forward, x)}`` with
    ``export_serving`` (the live predictor bit-identical before and after),
    then load every bundle in one fresh ``python -c`` process that builds no
    model (``BUNDLE_LOADER``): its logits on ``x`` bit-identical to the live
    predictor's, its launches per forward by kernel name the given ones."""
    from bnn_tpu_torch.inference import export_serving, state_bytes

    live = {}
    for name, (pred, want, x) in paths.items():
        where = root / name
        before = pred(x)
        t0 = time.perf_counter()
        export_serving(pred, str(where / "bundle"), tuple(x.shape[1:]))
        export_s = time.perf_counter() - t0
        after = pred(x)
        if not torch.equal(before, after):
            raise AssertionError(f"{name}: the live predictor changed after "
                                 "its export")
        torch.save((x, before.cpu()), where / "io.pt")
        live[str(where)] = (name, want, export_s, state_bytes(pred.model),
                            (where / "bundle" / "program.pt2").stat().st_size)
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-c", BUNDLE_LOADER, json.dumps(KERNELS), *live],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        print(run.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"the bundle loader exited {run.returncode}")
    print(f"phase {phase}: {len(live)} bundles loaded in a fresh process in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in run.stdout.splitlines():
        r = json.loads(line)
        name, want, export_s, live_bytes, pt2 = live[r["where"]]
        ok_counts = [a for a in r["launches"] if a == want]
        print(f"phase {phase}: {name}: exported in {export_s:.2f} s "
              f"({pt2} B program.pt2), loaded in {r['load_s']:.2f} s; logits "
              f"{'bit-identical to' if r['equal'] else 'DIFFER from'} the live "
              f"predictor's (max |diff| {r['max_abs']:.3g}); the live predictor "
              f"unchanged by the export; launches per forward {r['launches'][0]} "
              f"(want {want}); state_bytes {r['state_bytes']} B (the "
              f"predictor's {live_bytes} B); loaded forward "
              f"{r['forward_ms']:.3f} ms | {card}")
        if not r["equal"] or not ok_counts:
            raise AssertionError(f"{name}: the loaded bundle is not the live "
                                 f"predictor: {r}")


def bundle_phase(kernels, paths, images, dev, card) -> None:
    """Phase 7: (a) torch.library.opcheck of each operator on CUDA tensors;
    (b) each serving path exported, then loaded in a fresh process that
    builds no model: its logits bit-identical to the live predictor's, the
    live predictor bit-identical before and after the export, its launches
    per forward by kernel name equal to phase 3's; (c) what dispatch costs;
    (d) a loaded bundle behind ContinuousBatcher; (e) the serve CLI's
    --export and --load."""
    from bnn_tpu_torch.inference import ContinuousBatcher, load_serving

    gen = torch.Generator().manual_seed(SEED + 7)
    cases = op_cases(kernels, gen, dev)
    for name, args in cases.items():
        t0 = time.perf_counter()
        torch.library.opcheck(getattr(torch.ops.bnn_tpu_torch, name).default, args)
        print(f"phase 7: opcheck {name} on CUDA tensors passed in "
              f"{time.perf_counter() - t0:.1f} s")
    root = SMOKE_DIR / "bundles"
    shutil.rmtree(root, ignore_errors=True)
    try:
        export_and_load(root, {name: (pred, want, images[:pred.batch_size])
                               for name, (pred, want) in paths.items()}, card, phase=7)
        route_costs(card)
        dispatch_costs(kernels, cases, card)
        # (d) a loaded batch-8 bundle (the int8 head) behind the batcher
        server = load_serving(str(root / "int8_head_b8" / "bundle"))
        reqs = [images[i:i + 1].numpy() for i in range(16)] * 4
        with ContinuousBatcher(server, max_delay_ms=5.0) as srv:
            futs = [srv.submit(r) for r in reqs]
            rows = [f.result(timeout=300) for f in futs]
            st = srv.stats()
        err = max(float((row.float() - server(r).cpu().float()).abs().max())
                  for row, r in zip(rows, reqs))
        print(f"phase 7: ContinuousBatcher over the loaded batch-8 bundle: "
              f"{st.requests} single-image requests in {st.batches} batches "
              f"(occupancy {100 * st.mean_occupancy:.1f}%), every row against a "
              f"direct call: max |diff| {err:.3g} (limit 1e-5)")
        if err > 1e-5 or st.requests != 64:
            raise AssertionError("the batcher over a loaded bundle is off")
        # (e) the serve CLI
        cli = str(root / "cli")
        for extra in (["--export", cli], ["--load", cli], ["--load", cli, "--continuous"]):
            cmd = [sys.executable, "-m", "bnn_tpu_torch.examples.serve",
                   "--requests", "2", *extra]
            t0 = time.perf_counter()
            run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                                 timeout=600)
            flag = " ".join(a for a in extra if a != cli)
            for line in run.stdout.splitlines():
                print(f"phase 7: serve CLI ({flag}): {line}")
            print(f"phase 7: serve CLI ({flag}) exited {run.returncode} after "
                  f"{time.perf_counter() - t0:.1f} s | {card}")
            if run.returncode != 0:
                print(run.stderr[-4000:], file=sys.stderr)
                raise AssertionError(f"the serve CLI ({flag}) exited {run.returncode}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# phase 8: the recipes and the rest of the model zoo. Path D is the
# reference's ImageNet configuration (examples/imagenet.py: pre-activation
# ResNet-18, PReLU, the DaBNN stem) trained through both steps of
# imagenet-baseline.yaml and served; path E is the BATS CIFAR network of
# benchmarks/serving_sweep.py (C = 36, 20 layers, groups 4)
RECIPES = (sorted((ROOT / "examples" / "recipes").glob("*.yaml"))
           + [ROOT / "tests" / "assets" / "test.yaml"])
# path D's training: batch, steps of recipe step 0, steps of recipe step 1
PATH_D_TRAIN = (256, 8, 5)
# path E's training (DARTS's CIFAR settings, which BATS follows): batch,
# steps, auxiliary loss weight, drop-path probability; SGD below
PATH_E_TRAIN = (96, 5, 0.4, 0.2)
BATS_SIZE, BATS_CLASSES = 32, 10


def randomize_norms(model, gen):
    """BN statistics (and affine parameters where the BN has them), output
    scales and PReLU slopes random, as after training, so that every folded
    add and threshold is non-zero (``flagship``'s draws, any BN)."""
    from bnn_tpu_torch.ops import BasicScaleBinarizer

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(0.3 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.5 + 1.5 * torch.rand(c, generator=gen))
                if m.affine:
                    m.weight.copy_(1.0 + 0.3 * torch.randn(c, generator=gen))
                    m.bias.copy_(0.3 * torch.randn(c, generator=gen))
            elif isinstance(m, BasicScaleBinarizer):
                m.alpha.copy_(0.5 + torch.rand(m.alpha.shape, generator=gen))
            elif isinstance(m, torch.nn.PReLU):
                m.weight.copy_(0.05 + 0.45 * torch.rand(m.weight.shape, generator=gen))
    return model


def path_d_model(recipe: str, steps: int):
    """The reference's ImageNet configuration, 1000 classes, weights from
    seed 0, through the first ``steps`` steps of ``recipe`` (the second with
    ``update=True``), and the chef."""
    import bnn_tpu_torch as bt

    chef = bt.BinaryChef(str(ROOT / "examples" / "recipes" / f"{recipe}.yaml"))
    model = bt.models.resnet18(block_type=bt.models.PreBasicBlock,
                               activation=torch.nn.PReLU, stem_type="dabnn",
                               num_classes=1000,
                               generator=torch.Generator().manual_seed(SEED))
    for i in range(steps):
        model = chef.run_step(model, i, update=i > 0)
    return model, chef


def recipes_check() -> str:
    """(a) Every recipe of the repo through ``BinaryChef``; the port's block
    reader gives the same steps. Returns the loader's name."""
    from bnn_tpu_torch import BinaryChef, engine

    loaders = set()
    for path in RECIPES:
        chef = BinaryChef(str(path))
        mine = [dict(v) for v in engine.read_block_yaml(path.read_text()).values()]
        loaders.add(chef.loader)
        print(f"phase 8: {path.relative_to(ROOT)}: {len(chef)} steps read by "
              f"{chef.loader}; the port's block reader gives the same steps: "
              f"{mine == chef.config}")
        if mine != chef.config:
            raise AssertionError(f"{path}: the block reader disagrees with {chef.loader}")
    return ", ".join(sorted(loaders))


def train_path_d(make_train_step, dev, card):
    """(b) Path D trained through both steps of imagenet-baseline.yaml on one
    fixed batch, bf16 compute; each step's lr against the schedule computed
    on the CPU (1e-7 relative), the first step's lr 0 and the weights it
    leaves unchanged; a checkpoint between the steps restored into a fresh
    model and optimizer (the schedule's position with it)."""
    from bnn_tpu_torch.utils import (load_checkpoint, restore_into,
                                     restore_optimizer, save_checkpoint)

    batch, steps0, steps1 = PATH_D_TRAIN
    gen = torch.Generator().manual_seed(SEED + 17)
    x = torch.randn((batch, 3, SIZE, SIZE), generator=gen).to(dev)
    y = torch.randint(0, 1000, (batch,), generator=gen).to(dev)
    model, chef = path_d_model("imagenet-baseline", 1)
    model = model.to(dev).train()
    opts = {"compute_dtype": torch.bfloat16}
    for recipe_step, steps in ((0, steps0), (1, steps1)):
        if recipe_step == 1:
            model = chef.run_step(model, 1, update=True).to(dev).train()
        opt = chef.make_optimizer(model, recipe_step, steps_per_epoch=1)
        schedule = chef.lr_schedule(recipe_step, steps_per_epoch=1)
        start = [p.detach().clone() for p in model.parameters()]
        lrs = []

        def after(i, opt=opt, schedule=schedule, start=start, lrs=lrs):
            lr, want = opt.param_groups[0]["lr"], schedule(i)
            lrs.append((lr, want))
            if abs(lr - want) > 1e-7 * abs(want):
                raise AssertionError(f"path D step {i}: lr {lr}, schedule {want}")
            if recipe_step == 0 and i == 0 and (lr != 0.0 or not all(
                    torch.equal(p, q) for p, q in zip(model.parameters(), start))):
                raise AssertionError("path D: the first step (lr 0) changed the weights")

        label = (f"path D, imagenet-baseline.yaml step {recipe_step} "
                 f"({opt.__class__.__name__}), bf16 compute, batch {batch}")
        train_case(make_train_step, model, opts, x, y, steps, label, card, opt=opt,
                   phase=8, after_step=after)
        print(f"phase 8: path D step {recipe_step}: lr of each optimizer step beside the "
              f"schedule computed on the CPU: {[(f'{a:.9g}', f'{b:.9g}') for a, b in lrs]}"
              + ("; the first step's lr is 0 and the weights after it are bit-identical "
                 "to those before" if recipe_step == 0 else ""))
        if recipe_step == 0:
            path = SMOKE_DIR / "path_d"
            save_checkpoint(str(path), model, opt_state=opt, metadata={"recipe_step": 0})
            fresh, _ = path_d_model("imagenet-baseline", 1)
            fresh = fresh.to(dev)
            payload = load_checkpoint(str(path))
            restore_into(fresh, payload)
            fresh_opt = chef.make_optimizer(fresh, 0, steps_per_epoch=1)
            restore_optimizer(fresh_opt, payload)
            same = all(torch.equal(a, b) for a, b in zip(
                fresh.state_dict().values(), model.state_dict().values())
                if isinstance(a, torch.Tensor))
            print(f"phase 8: path D checkpoint after step 0: state restored bit-identical "
                  f"{same}; the restored optimizer's next lr {fresh_opt.current_lr():.9g} "
                  f"(the live one's {opt.current_lr():.9g})")
            if not same or fresh_opt.current_lr() != opt.current_lr():
                raise AssertionError("path D: the checkpoint does not restore the run")
            del fresh, fresh_opt, payload
            shutil.rmtree(path, ignore_errors=True)
    return model.eval()


def zoo_calls(kernels, megablock, stages, pred, xb):
    """(kernel, label, kernel call, plain call, args, kw, head) of every
    fused_chain and fused_basic_block call ``pred`` makes on ``xb``."""
    calls = []
    for kname, module in (("fused_chain", stages), ("fused_basic_block", megablock)):
        for args, kw in capture_calls(module, kname, lambda: pred(xb)):
            head = kname == "fused_chain" and len(args) > 2 and args[2] is not None
            calls.append((kname, f"{kname} {tuple(args[0].shape)}{' +head' if head else ''} "
                          f"{str(args[0].dtype)[6:]}",
                          lambda a=args, k=kw, f=getattr(kernels, kname): f(*a, **k),
                          lambda a=args, k=kw, f=getattr(kernels, kname + "_reference"):
                          f(*a, **k), args, kw, head))
    return calls


# path D's launches per forward at batch 1 and 4
PATH_D_SMALL = {"fused_chain": 1, "fused_basic_block": 3, "binary_conv2d": 9}


def serve_path_d(kernels, Predictor, trained, images, dev, card, errs, totals):
    """(c) Path D served at batch 1, 4 and 8 in bf16 with its launches; every
    kernel call of the batch 1 and 4 forwards held against its plain
    version, fused_basic_block timed at R18's three stage shapes; the f32
    build at batch 4 against the CPU's plain versions; then xnor-net-plus.yaml's two
    steps at batch 4 and 8. Returns the batch-4 predictor."""
    from bnn_tpu_torch.inference import megablock, stages

    preds = {}
    # the DaBNN stem's three binary convs and, at B <= 4, the down blocks'
    # two run binary_conv2d; at B = 8 every binary conv does
    plan = {1: PATH_D_SMALL, 4: PATH_D_SMALL, 8: {"binary_conv2d": 19}}
    for b in (1, 4, 8):
        preds[b] = Predictor(copy.deepcopy(trained), batch_size=b)
        _, launches = serve_counted(
            kernels, preds[b], (images[:b], images[b:2 * b + 1]),
            f"path D: DaBNN pre-act PReLU ResNet-18 Predictor(batch_size={b}) bf16",
            plan[b], phase=8)
        for k, v in launches.items():
            totals[k] += v
    for b in (1, 4):
        for kname, label, fn, plain, args, kw, head in zoo_calls(
                kernels, megablock, stages, preds[b], images[:b].to(dev)):
            errs[kname] = max(errs[kname], check_exact(
                f"path D batch {b} {label}", fn(), plain(), head, phase=8))
            if kname == "fused_basic_block":
                p = kernels.block.fused_basic_block_plan(args[0])
                bound, by = block_bound(kname, args, kw, bound_ms)
                (k_dev, k_call), (p_dev, p_call) = time_kernel(fn, plain)
                print(f"phase 8: path D batch {b} {label}: kernel {k_dev * 1e3:.2f} us "
                      f"device / {k_call * 1e3:.2f} us per call, plain {p_dev * 1e3:.2f} "
                      f"us device, bound {bound * 1e3:.3f} us ({by}); grid {p['blocks']} "
                      f"blocks, {p['resident_per_sm']} resident an SM, {p['tiles']} "
                      f"tiles, K slices {p['k_slices']} | {card}")
    check_trained_serving(
        Predictor(copy.deepcopy(trained), batch_size=4, dtype=None),
        Predictor(copy.deepcopy(trained).cpu(), batch_size=4, dtype=None, device="cpu"),
        images[:8], 4, phase=8, name="path D trained", stem=lambda m: m.conv1.conv1[0])
    for b in (1, 4, 8):
        forward_times(preds[b], images[:b].to(dev), card,
                      f"path D Predictor(batch_size={b}) bf16 {SIZE}x{SIZE}", phase=8)
    # xnor-net-plus.yaml: the downsample shortcuts binary too
    plus, _ = path_d_model("xnor-net-plus", 2)
    plus = randomize_norms(plus, torch.Generator().manual_seed(SEED + 18)).eval()
    for b, want in ((4, {"fused_chain": 4, "binary_conv2d": 3}),
                    (8, {"binary_gemm": 1, "binary_conv2d": 21})):
        pred = Predictor(copy.deepcopy(plus), batch_size=b)
        fused = sorted({type(m).__name__ for m in pred.model.modules()
                        if type(m).__name__.startswith("Fused")})
        _, launches = serve_counted(
            kernels, pred, (images[:b], images[b:2 * b + 1]),
            f"path D after xnor-net-plus.yaml Predictor(batch_size={b}) bf16 (fused "
            f"modules {fused})", want, phase=8)
        for k, v in launches.items():
            totals[k] += v
        if b == 4:
            for kname, label, fn, plain, args, kw, head in zoo_calls(
                    kernels, megablock, stages, pred, images[:b].to(dev)):
                errs[kname] = max(errs[kname], check_exact(
                    f"path D xnor-net-plus batch {b} {label}", fn(), plain(), head,
                    phase=8))
            forward_times(pred, images[:b].to(dev), card,
                          f"path D after xnor-net-plus.yaml Predictor(batch_size={b}) bf16",
                          phase=8)
    return preds[4]


def path_e(kernels, Predictor, make_train_step, dev, card, errs, totals):
    """(d) Path E: the BATS CIFAR network trained (aux loss, drop-path) and
    served at batch 1 and 8 with its launches (binary_gemm per pointwise
    conv in gemm mode, binary_conv2d per ungrouped conv in conv mode); every
    binary_gemm call held against its plain version; the f32 build at batch
    2 against the CPU's plain versions. Returns the batch-8 predictor, the
    images and its launches per forward."""
    import bnn_tpu_torch as bt
    from bnn_tpu_torch.inference import DeployedConv, DeployedLinear
    from bnn_tpu_torch.ops import (BasicInputBinarizer, BasicScaleBinarizer,
                                   XNORWeightBinarizer)

    deploy = importlib.import_module("bnn_tpu_torch.inference.deploy")
    batch, steps, aux_weight, drop = PATH_E_TRAIN
    marks = [("start", time.perf_counter())]
    net = bt.models.BATSNetworkCIFAR(36, BATS_CLASSES, 20, True, bt.models.BATS_EXAMPLE,
                                     groups=4, generator=torch.Generator().manual_seed(SEED),
                                     seed=SEED)
    net = bt.prepare_binary_model(
        net, bt.BConfig(BasicInputBinarizer, BasicScaleBinarizer, XNORWeightBinarizer),
        ignore_layers_name=["_first_", "_last_"]).to(dev).train()
    net.drop_path_prob = drop
    gen = torch.Generator().manual_seed(SEED + 19)
    x = torch.randn((batch, 3, BATS_SIZE, BATS_SIZE), generator=gen).to(dev)
    y = torch.randint(0, BATS_CLASSES, (batch,), generator=gen).to(dev)
    opt = torch.optim.SGD(net.parameters(), lr=0.025, momentum=0.9, weight_decay=3e-4)
    marks.append(("build", time.perf_counter()))
    # cuDNN deterministic, so that the trained weights are the same in every
    # run: the f32 check below compares signs, and the weights of a
    # non-deterministic run can put a pre-sign value within rounding of 0
    with cudnn_deterministic():
        train_case(make_train_step, net, {"aux_weight": aux_weight}, x, y, steps,
                   f"path E: BATS CIFAR (C=36, 20 layers, groups 4, auxiliary head, "
                   f"aux_weight {aux_weight}, drop_path_prob {drop}), f32, batch {batch}, "
                   "SGD 0.025 momentum 0.9, cuDNN deterministic", card, opt=opt, phase=8)
    net.eval()
    marks.append(("train", time.perf_counter()))
    images = torch.randn((24, 3, BATS_SIZE, BATS_SIZE), generator=gen)
    preds = {}
    for b in (1, 8):
        preds[b] = Predictor(copy.deepcopy(net), batch_size=b)
        # the auxiliary head runs in train mode only
        served = [m for n, m in preds[b].model.named_modules()
                  if not n.startswith("auxiliary_head")]
        convs = [m for m in served if isinstance(m, DeployedConv)]
        gemm = sum(m.mode == "gemm" for m in convs)
        gemm += sum(isinstance(m, DeployedLinear) for m in served)
        # conv mode: binary_conv2d where the kernel takes the geometry
        conv2d = sum(m.mode == "conv" and m._kernel_geometry for m in convs)
        want = {"binary_gemm": gemm, "binary_conv2d": conv2d}
        if b == 1:
            print(f"phase 8: path E deployed: {gemm} layers on binary_gemm (gemm mode), "
                  f"{sum(m.mode == 'conv' and not m._kernel_geometry for m in convs)} "
                  f"grouped or dilated convs in conv mode (unfold + torch._int_mm) and "
                  f"{conv2d} others (binary_conv2d)")
        _, launches = serve_counted(
            kernels, preds[b], (images[:b], images[b:2 * b + 1]),
            f"path E: BATS CIFAR Predictor(batch_size={b}) bf16", want,
            classes=BATS_CLASSES, phase=8)
        for k, v in launches.items():
            totals[k] += v
        calls = capture_calls(deploy, "binary_gemm", lambda: preds[b](images[:b].to(dev)))
        e = [hold_gemm(kernels, f"path E B={b} call {i}", a, k, phase=8)
             for i, (a, k) in enumerate(calls)]
        errs["binary_gemm"] = max([errs["binary_gemm"]] + e)
        print(f"phase 8: path E batch {b}: {len(calls)} binary_gemm calls held against "
              f"the plain version: bit-identical; (M, K, N) "
              f"{sorted({(a[0].shape[0], a[2], a[1].shape[1]) for a, _ in calls})}")
    marks.append(("serve", time.perf_counter()))
    check_trained_serving(
        Predictor(copy.deepcopy(net), batch_size=2, dtype=None),
        Predictor(copy.deepcopy(net).cpu(), batch_size=2, dtype=None, device="cpu"),
        images[:2], 2, phase=8, name="path E trained", stem=lambda m: m.stem[0])
    marks.append(("f32 vs CPU", time.perf_counter()))
    for b in (1, 8):
        # a forward is about 3,000 launches: the profiler's trace of 10
        # takes tens of seconds to read back
        forward_times(preds[b], images[:b].to(dev), card,
                      f"path E Predictor(batch_size={b}) bf16 {BATS_SIZE}x{BATS_SIZE}",
                      phase=8, profile_iters=2)
    marks.append(("times", time.perf_counter()))
    print("phase 8: path E took " + ", ".join(
        f"{name} {t - marks[i][1]:.1f} s" for i, (name, t) in enumerate(marks[1:])))
    return preds[8], images, want


def grads_card_vs_cpu(name, module, x, dev, tol=1e-4):
    """(e) One train-mode forward and backward of ``module`` on ``x`` on the
    card and on the CPU, in float64: output, input gradient and every
    parameter gradient within ``tol`` (each against the larger of its own
    largest value and 1e-3 of the largest parameter gradient)."""
    runs = []
    for device in (dev, torch.device("cpu")):
        m = copy.deepcopy(module).double().to(device).train()
        xi = x.double().to(device).requires_grad_(True)
        out = m(xi)
        out.backward(torch.ones_like(out) * torch.linspace(-1, 1, out.shape[-1],
                                                            device=device, dtype=out.dtype))
        runs.append((out.detach().cpu(), xi.grad.cpu(),
                     {k: p.grad.cpu() for k, p in m.named_parameters()}))
    (o_c, g_c, p_c), (o, g, p) = runs
    floor = 1e-3 * max(v.abs().max().item() for v in p.values())
    worst = max((p_c[k] - v).abs().max().item() / max(v.abs().max().item(), floor)
                for k, v in p.items())
    out_err, in_err = rel_max(o_c, o), rel_max(g_c, g)
    print(f"phase 8: {name}: one forward and backward, card vs CPU (float64): output "
          f"{out_err:.3g}, input gradient {in_err:.3g}, worst parameter gradient "
          f"{worst:.3g} of {len(p)} (limit {tol})")
    if max(out_err, in_err, worst) > tol:
        raise AssertionError(f"{name}: the card differs from the CPU")


def no_serving_paths(dev):
    """(e) HBlock and binarized attention, which no serving path runs."""
    import bnn_tpu_torch as bt
    from bnn_tpu_torch.ops import (BasicInputBinarizer, BasicScaleBinarizer, Identity,
                                   XNORWeightBinarizer)

    gen = torch.Generator().manual_seed(SEED + 20)
    torch.manual_seed(SEED + 20)
    hb = bt.prepare_binary_model(
        torch.nn.Sequential(bt.models.layers.HBlock(256, 256),
                            bt.models.layers.HBlock(256, 256)),
        bt.BConfig(BasicInputBinarizer, BasicScaleBinarizer, XNORWeightBinarizer))
    grads_card_vs_cpu("two binarized HBlocks (256 channels, 28x28, batch 8)",
                      randomize_norms(hb, gen),
                      torch.randn((8, 256, 28, 28), generator=gen), dev)
    attn = bt.prepare_binary_model(
        torch.nn.Sequential(bt.nn.LayerNorm(256), bt.nn.MultiheadAttention(256, 8)),
        bt.BConfig(BasicInputBinarizer, Identity, XNORWeightBinarizer))
    grads_card_vs_cpu("LayerNorm + binarized MultiheadAttention (256 wide, 8 heads, "
                      "64 tokens, batch 8)", attn,
                      torch.randn((8, 64, 256), generator=gen), dev)


def zoo_phase(kernels, Predictor, dev, card, errs, totals) -> None:
    """Phase 8: the recipes, paths D and E, HBlock and attention, and the two
    paths' bundles; the counted launches join ``totals`` and the largest
    kernel differences ``errs``."""
    from bnn_tpu_torch.parallel import make_train_step

    t0 = time.perf_counter()
    parts, last = [], [t0]

    def done(part):
        now = time.perf_counter()
        parts.append(f"{part} {now - last[0]:.1f} s")
        last[0] = now

    loader = recipes_check()
    print(f"phase 8: recipes read with {loader}")
    gen = torch.Generator().manual_seed(SEED + 21)
    images = torch.randn((24, 3, SIZE, SIZE), generator=gen)
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    try:
        trained = train_path_d(make_train_step, dev, card)
        done("(a)+(b)")
        pred_d = serve_path_d(kernels, Predictor, trained, images, dev, card, errs, totals)
        del trained
        torch.cuda.empty_cache()
        done("(c)")
        pred_e, images_e, launches_e = path_e(kernels, Predictor, make_train_step, dev,
                                              card, errs, totals)
        torch.cuda.empty_cache()
        done("(d)")
        no_serving_paths(dev)
        done("(e)")
        export_and_load(SMOKE_DIR / "zoo_bundles", {
            "path_d_b4": (pred_d, PATH_D_SMALL, images[:4]),
            "path_e_b8": (pred_e, launches_e, images_e[:8]),
        }, card, phase=8)
        done("(f)")
    finally:
        shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    print(f"phase 8: took {time.perf_counter() - t0:.1f} s ({', '.join(parts)})")



# phase 9's host pipeline: ImageNet's normalisation and a store of 2,048
# images of 224x224x3 (uint8, 308 MB), as NativeDataLoader feeds a trainer
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
STORE_IMAGES = 2048
TRAINER_BATCH = 256
FED_STEPS = STORE_IMAGES // TRAINER_BATCH
TRACE_CALLS = 10  # binary_gemm calls inside phase 9 (c)'s trace()


def run_trainer(extra, out, card) -> list:
    """``python -m bnn_tpu_torch.examples.cifar10 --synthetic`` at batch 256
    on the card as a subprocess with ``extra`` flags: its epochs' lines
    ``(epoch, images, seconds, images/s)``, each printed."""
    import re

    cmd = [sys.executable, "-m", "bnn_tpu_torch.examples.cifar10", "--synthetic",
           "--batch-size", str(TRAINER_BATCH), "--out", str(out), *extra]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"the CIFAR-10 trainer {extra} exited {run.returncode}:\n"
                             f"{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
    epochs = [(int(e), int(n), float(s), float(r)) for e, n, s, r in re.findall(
        r"Epoch (\d+): trained (\d+) images in ([\d.]+) s \(([\d.]+) images/s\)",
        run.stdout)]
    losses = [float(v) for v in re.findall(r"\tLoss (\S+) \(", run.stdout)]
    tests = re.findall(r"Epoch (\d+): test acc ([\d.]+)% \(loss (\S+)\)", run.stdout)
    if (not epochs or len(tests) != len(epochs) or "Best accuracy" not in run.stdout
            or not all(math.isfinite(v) for v in losses + [float(t[2]) for t in tests])):
        raise AssertionError(f"the CIFAR-10 trainer {extra} printed:\n{run.stdout[-3000:]}")
    print(f"phase 9: (a) trainer {' '.join(extra)}: exited 0 after {wall:.1f} s; first "
          f"losses of its epochs {losses}; test acc / loss "
          f"{[(float(a), float(b)) for _, a, b in tests]}")
    return epochs


def trainer_run(out, card) -> None:
    """(a): the CIFAR-10 trainer for 2 epochs, then resumed to 3; the
    checkpoint's epoch, Adam's step count and every state tensor finite."""
    from bnn_tpu_torch.utils import assert_finite, load_checkpoint

    epochs = run_trainer(["--epochs", "2"], out, card)
    epochs += run_trainer(["--epochs", "3", "--resume", str(out)], out, card)
    if [e[0] for e in epochs] != [0, 1, 2]:
        raise AssertionError(f"trainer epochs {epochs}")
    for e, n, s, r in epochs[1:]:
        note = ("the first epoch of the resumed process" if e == 2
                else "after the first epoch of its process")
        print(f"phase 9: (a) CIFAR-10 ResNet-18 (10 classes, 32x32, batch 256, Adam) "
              f"epoch {e} ({note}): {n} images in {s:.3f} s, {r:.1f} images/s | {card}")
    payload = load_checkpoint(out)
    steps = {float(st["step"]) for st in payload["opt_state"]["state"].values()}
    meta = payload["metadata"]
    if meta["epoch"] != 3 or steps != {3.0 * FED_STEPS}:
        raise AssertionError(f"checkpoint epoch {meta['epoch']}, Adam steps {steps}")
    assert_finite(payload["model"], "the trained CIFAR-10 model")
    print(f"phase 9: (a) checkpoint: epoch {meta['epoch']}, best_acc "
          f"{meta['best_acc']:.2f}, Adam's step count {int(steps.pop())} on every "
          f"parameter, every state tensor finite")
    cifar_step_breakdown(epochs[1], card)


def cifar_step_breakdown(epoch, card) -> None:
    """Where the trainer's time goes: its host work for one batch (numpy crop
    and flip, normalisation, NCHW copy to the card) and its train step on a
    batch already on the card, with the device's busy share."""
    import numpy as np

    from bnn_tpu_torch.examples import cifar10
    from bnn_tpu_torch.parallel import make_train_step

    dev = torch.device("cuda", 0)
    (x_train, y_train), _ = cifar10.synthetic_cifar10()
    rng = np.random.default_rng(SEED)
    idx = rng.permutation(len(x_train))[:TRAINER_BATCH]
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        xb, yb = cifar10.to_device(cifar10.normalize(cifar10.augment(x_train[idx], rng)),
                                   y_train[idx], dev)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    model = cifar10.build_model(SEED).to(dev).train()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = make_train_step()
    by_kernel, wall = device_profile(lambda: step(model, opt, xb, yb), iters=5,
                                     whole=False)
    busy = sum(by_kernel.values())
    per_epoch = epoch[2] / (epoch[1] / TRAINER_BATCH) * 1e3
    print(f"phase 9: (a) the trainer's {per_epoch:.2f} ms a step (epoch {epoch[0]}): "
          f"host work for a batch (crop, flip, normalise, copy) {min(host):.2f} ms; the "
          f"step on a batch on the card (TF32 off, as in this script) {wall:.2f} ms under "
          f"torch.profiler, device busy "
          f"{busy:.2f} ms ({100 * busy / wall:.1f}%), {len(by_kernel)} distinct kernels "
          f"| {card}")
    del model, opt


def interval_union_ms(events) -> float:
    """The length of the union of ``(start_us, end_us)`` intervals, in ms."""
    total, end = 0.0, -math.inf
    for s, e in sorted(events):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def fed_training(kernels, dev, card) -> None:
    """(b): NativeDataLoader and prefetch_to_device feeding phase 5's bf16
    batch-256 flagship step, beside the step on a batch already on the card."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bnn_tpu_torch import native
    from bnn_tpu_torch.data import NativeDataLoader, prefetch_to_device
    from bnn_tpu_torch.parallel import make_train_step

    rng = np.random.default_rng(SEED)
    store = rng.integers(0, 256, (STORE_IMAGES, SIZE, SIZE, 3), dtype=np.uint8)
    labels = rng.integers(0, 1000, STORE_IMAGES).astype(np.int32)
    loader = NativeDataLoader(store, labels, batch_size=TRAINER_BATCH, pad=4,
                              flip=True, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                              seed=SEED)
    if not loader.use_native or len(loader) != FED_STEPS:
        raise AssertionError("NativeDataLoader did not take the native path")
    batch_mb = TRAINER_BATCH * 3 * SIZE * SIZE * 4 / 1e6
    epochs = []
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        t0 = time.perf_counter()
        n = sum(x.shape[0] for x, _ in loader)
        epochs.append(time.perf_counter() - t0)
    best = min(epochs)
    print(f"phase 9: (b) NativeDataLoader alone (pad 4, flip, ImageNet mean/std, "
          f"{STORE_IMAGES} uint8 images of {SIZE}x{SIZE}x3, batch {TRAINER_BATCH}): "
          f"{n / best:.1f} images/s, {best / FED_STEPS * 1e3:.2f} ms a batch of "
          f"{batch_mb:.1f} MB of float32 (epochs {[round(t, 3) for t in epochs]} s), "
          f"loader_num_threads() {native.loader_num_threads()}, use_native "
          f"{loader.use_native} | {card}")

    x, y = next(iter(loader))
    pin_ms = []
    for _ in range(2):  # the first allocates page-locked memory, the second reuses it
        t0 = time.perf_counter()
        pinned = x.pin_memory()
        pin_ms.append((time.perf_counter() - t0) * 1e3)
        if len(pin_ms) == 1:
            del pinned
    copy_ms = cuda_ms(lambda: pinned.to(dev, non_blocking=True), iters=10, warmup=2)
    print(f"phase 9: (b) host-to-card copy of one batch: {copy_ms:.3f} ms from pinned "
          f"memory ({x.numel() * 4 / copy_ms / 1e6:.1f} GB/s); pin_memory() on the host "
          f"{pin_ms[0]:.3f} ms the first time (page-locking new memory), "
          f"{pin_ms[1]:.3f} ms from the host allocator's cache | {card}")
    del pinned

    model = flagship(torch.Generator().manual_seed(SEED + 30)).train().to(dev)
    opt = adamw(model)
    step = make_train_step(compute_dtype=torch.bfloat16)
    resident = (x.to(dev), y.to(dev))
    for _ in range(WARMUP_STEPS):
        step(model, opt, *resident)
    torch.cuda.synchronize()

    def fed():
        return [step(model, opt, xb, yb)["loss"]
                for xb, yb in prefetch_to_device(iter(loader), size=2, device=dev)]

    def on_card():
        return [step(model, opt, *resident)["loss"] for _ in range(FED_STEPS)]

    def timed(run, epoch) -> float:
        loader.set_epoch(epoch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / FED_STEPS * 1e3
        if len(losses) != FED_STEPS or not all(math.isfinite(v.item()) for v in losses):
            raise AssertionError(f"steps: {[v.item() for v in losses]}")
        return ms

    first = timed(fed, 2)  # the prefetcher's first page-locked buffers are made here
    runs = {"fed": [], "on the card": []}
    for i, name in enumerate(("fed", "on the card", "on the card", "fed")):
        runs[name].append(timed(fed if name == "fed" else on_card, 3 + i))
    print(f"phase 9: (b) flagship bf16 batch-{TRAINER_BATCH} train step, in turns: "
          f"fed by NativeDataLoader + prefetch_to_device "
          f"{[round(v, 2) for v in runs['fed']]} ms a step, on a batch already on the "
          f"card {[round(v, 2) for v in runs['on the card']]} ms a step (host clock "
          f"over {FED_STEPS} steps, the fed runs from the first batch's wait; the first "
          f"fed epoch, which page-locks the prefetcher's buffers, {first:.2f}) | {card}")

    # CUPTI now and then delivers no device event: the profiled run is taken
    # again, up to three times, as device_profile does
    for attempt in range(1, 4):
        for k in KERNELS:
            getattr(kernels, k).launches = 0
        loader.set_epoch(6 + attempt)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fed()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        launches = {k: getattr(kernels, k).launches for k in KERNELS}
        device = [(e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if device:
            break
    copies = [(e.time_range.start, e.time_range.end) for e in prof.events()
              if e.device_type == DeviceType.CUDA and "Memcpy" in e.name]
    busy = interval_union_ms(device) / FED_STEPS
    fed_ms = min(runs["fed"])
    print(f"phase 9: (b) fed steps under torch.profiler: {wall / FED_STEPS:.2f} ms a "
          f"step, device busy {busy:.2f} ms a step ({100 * busy * FED_STEPS / wall:.1f}% "
          f"of the profiled wall; {100 * busy / fed_ms:.1f}% of the unprofiled fed step's "
          f"{fed_ms:.2f} ms), of which host-to-card copies "
          f"{interval_union_ms(copies) / FED_STEPS:.2f} ms; launches of the port's "
          f"kernels {launches} (the training step runs none); profiled run "
          f"{attempt} of 3 | {card}")
    if not device:
        raise AssertionError("three traces of the fed steps hold no device event")
    del model, opt, resident, store
    torch.cuda.empty_cache()


def gemm_case(kernels, dev) -> tuple:
    """(c)'s ``binary_gemm`` call: ResNet-50 batch 8's widest K among its
    N=512 calls, bf16 inputs already signed, from the seed."""
    gen = torch.Generator().manual_seed(SEED + 31)
    m, k, n = 196, 1024, 512
    x = torch.where(torch.randn((m, k), generator=gen) >= 0, 1.0, -1.0).to(
        dev, torch.bfloat16)
    wp = kernels.pack_bits(torch.randn((k, n), generator=gen), axis=-2).to(dev)
    scale = (0.5 + torch.rand(n, generator=gen)).to(dev)
    add = torch.randn(n, generator=gen).to(dev)
    return x, wp, k, scale, add


def trace_gemm(log_dir: str) -> dict:
    """``trace()`` of TRACE_CALLS of (c)'s ``binary_gemm`` calls, written
    into ``log_dir``: the file, its events, and the kernel's among them."""
    from bnn_tpu_torch import kernels
    from bnn_tpu_torch.utils import trace

    x, wp, k, scale, add = gemm_case(kernels, torch.device("cuda"))
    kernels.binary_gemm(x, wp, k, scale, add, sign_inputs=False)
    torch.cuda.synchronize()
    with trace(log_dir):
        for _ in range(TRACE_CALLS):
            kernels.binary_gemm(x, wp, k, scale, add, sign_inputs=False)
        torch.cuda.synchronize()
    files = sorted(pathlib.Path(log_dir).glob("*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"trace() wrote {files}, not one trace file")
    events = json.loads(files[0].read_text())["traceEvents"]
    hits = [e for e in events if "binary_gemm_kernel" in e.get("name", "")]
    return {"file": files[0].name, "bytes": files[0].stat().st_size,
            "events": len(events), "hits": len(hits),
            "first": [hits[0].get("cat"), hits[0].get("dur")] if hits else None}


# (c)'s trace in a process of its own: argv[1] is the log directory
TRACE_CHILD = """
import json, sys
import chip_smoke
print(json.dumps(chip_smoke.trace_gemm(sys.argv[1])), flush=True)
"""


def utilities_on_card(kernels, dev, card) -> None:
    """(c): loop_time, trace, compiled_stats, debug_nans and count_ops on
    the card."""
    from bnn_tpu_torch.utils import (compiled_stats, count_ops, debug_nans,
                                     loop_time)

    x, wp, k, scale, add = gemm_case(kernels, dev)
    m, n = x.shape[0], add.shape[0]

    def call(a, *rest):
        return kernels.binary_gemm(a, *rest, sign_inputs=False)

    lt = loop_time(call, x, wp, k, scale, add, iters=200, rounds=3)
    feedback = loop_time(lambda a: a, x, iters=200, rounds=3)
    own, rest = own_ms(lambda: call(x, wp, k, scale, add), "binary_gemm_kernel")
    print(f"phase 9: (c) loop_time(binary_gemm) M={m} K={k} N={n} bf16: "
          f"{lt * 1e6:.2f} us a call, of which loop_time's feedback (an identity call: "
          f"sum, multiply, add) {feedback * 1e6:.2f} us; torch.profiler: the kernel "
          f"{own * 1e3:.2f} us, the call's other kernels {rest * 1e3:.2f} us | {card}")
    if not 0 < lt < 1:
        raise AssertionError(f"loop_time {lt}")

    # CUPTI now and then delivers no device event to a trace, and more often
    # in a process where an earlier profile saw another thread drive the
    # card (phase 6's stream): up to three traces here, then one in a fresh
    # process
    tries = []
    for attempt in range(3):
        tries.append(trace_gemm(str(SMOKE_DIR / f"trace{attempt}")))
        if tries[-1]["hits"]:
            break
    else:
        run = subprocess.run([sys.executable, "-c", TRACE_CHILD,
                              str(SMOKE_DIR / "trace_fresh")],
                             cwd=ROOT, capture_output=True, text=True, timeout=300)
        if run.returncode:
            raise AssertionError(f"(c)'s trace in a fresh process exited "
                                 f"{run.returncode}: {run.stderr[-2000:]}")
        tries.append(json.loads(run.stdout.strip().splitlines()[-1]))
        if not tries[-1]["hits"]:
            raise AssertionError(f"four traces without the kernel's event: {tries}")
    got = tries[-1]
    where = "a fresh process" if len(tries) == 4 else "this process"
    print(f"phase 9: (c) trace() wrote {got['file']} ({got['bytes']} B) in {where}: "
          f"{got['events']} events of {TRACE_CALLS} calls, the kernel's {got['hits']} "
          f"({got['first'][0]}, {got['first'][1]} us); trace {len(tries)} of 4"
          f"{f' (before it: {tries[:-1]})' if len(tries) > 1 else ''}")

    model = flagship(torch.Generator().manual_seed(SEED + 32)).to(dev)
    x1 = torch.randn((1, 3, SIZE, SIZE),
                     generator=torch.Generator().manual_seed(SEED + 35)).to(dev)
    ops = count_ops(model, (1, 3, SIZE, SIZE))
    with torch.no_grad():
        stats = compiled_stats(model, x1)
    print(f"phase 9: (c) count_ops(flagship, (1, 3, {SIZE}, {SIZE})): {ops.flops:,} "
          f"FLOPs, {ops.bops:,} BOPs, {ops.effective_flops:,.0f} effective; "
          f"compiled_stats of one f32 QAT forward: {stats['flops']:,} flops, peak "
          f"memory {stats['peak_memory_bytes']:,} B | {card}")
    if stats["flops"] != ops.flops + ops.bops or ops.bops == 0:
        raise AssertionError("compiled_stats' flops differ from count_ops' 2 * MACs")

    t = torch.ones(4, device=dev)
    bad = torch.tensor([1.0, float("nan"), 1.0, 1.0], device=dev)
    try:
        with debug_nans():
            t.mul_(bad)
    except FloatingPointError as e:
        print(f"phase 9: (c) debug_nans() on the card raised FloatingPointError: {e}")
    else:
        raise AssertionError("debug_nans() let a NaN into a CUDA tensor pass")
    del model


def native_gemm_on_host(kernels, card) -> None:
    """(d): the CPU XNOR GEMM at (c)'s shape, held against the plain
    version and timed on the card machine's CPU."""
    import numpy as np

    from bnn_tpu_torch import native

    rng = np.random.default_rng(SEED + 33)
    m, k, n = 196, 1024, 512
    x = rng.normal(size=(m, k)).astype(np.float32)
    wp = native.pack_weights(rng.normal(size=(k, n)).astype(np.float32))
    scale = np.abs(rng.normal(size=n)).astype(np.float32)
    add = rng.normal(size=n).astype(np.float32)
    got = native.gemm(x, wp, k, scale, add)
    want = kernels.binary_gemm_reference(
        torch.from_numpy(x), torch.from_numpy(wp.view(np.int32)), k,
        torch.from_numpy(scale), torch.from_numpy(add)).numpy()
    err = float(np.abs(got - want).max() / np.abs(want).max())
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        native.gemm(x, wp, k, scale, add)
        times.append(time.perf_counter() - t0)
    best = min(times)
    print(f"phase 9: (d) native.gemm M={m} K={k} N={n} on the host CPU: "
          f"{best * 1e3:.3f} ms ({2 * m * k * n / best / 1e9:.1f} GOPS), "
          f"num_threads() {native.num_threads()}; against the plain version max "
          f"|diff| / max |value| {err:.3g} (limit 1e-6) | {card}")
    if err > 1e-6:
        raise AssertionError("native.gemm differs from the plain version")


def reference_import(out, dev, card) -> None:
    """(e): (a)'s trained model saved in the reference's format and imported
    into a fresh model on the card: logits bit-identical."""
    from bnn_tpu_torch.examples import cifar10
    from bnn_tpu_torch.utils import (import_torch_checkpoint, load_checkpoint,
                                     restore_into)

    payload = load_checkpoint(out)
    path = SMOKE_DIR / "cifar10_reference.pth.tar"
    torch.save({"state_dict": payload["model"],
                "epoch": payload["metadata"]["epoch"]}, path)
    trained = cifar10.build_model(0).to(dev)
    restore_into(trained, payload)
    fresh = cifar10.build_model(1).to(dev)
    missing, unexpected = import_torch_checkpoint(fresh, str(path))
    xs = torch.randn((64, 3, 32, 32), generator=torch.Generator().manual_seed(SEED + 34))
    with torch.no_grad():
        a, b = trained.eval()(xs.to(dev)), fresh.eval()(xs.to(dev))
    if missing or unexpected or not torch.equal(a, b):
        raise AssertionError(f"reference import: missing {missing[:3]}, unexpected "
                             f"{unexpected[:3]}, max |diff| {(a - b).abs().max().item()}")
    print(f"phase 9: (e) the trained CIFAR-10 model as {{'state_dict', 'epoch'}} "
          f"({path.stat().st_size} B) imported into a fresh model on the card: missing "
          f"[], unexpected [], logits of 64 images bit-identical | {card}")


def trainer_phase(kernels, dev, card) -> None:
    """Phase 9: the host pipeline and the training utilities."""
    t0 = time.perf_counter()
    parts, last = [], [t0]

    def done(part):
        now = time.perf_counter()
        parts.append(f"{part} {now - last[0]:.1f} s")
        last[0] = now

    out = SMOKE_DIR / "cifar10"
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    try:
        trainer_run(out, card)
        done("(a)")
        # (b) last: a trace taken while the prefetcher's thread drives the
        # card left later traces in the process without device events
        utilities_on_card(kernels, dev, card)
        done("(c)")
        native_gemm_on_host(kernels, card)
        done("(d)")
        reference_import(out, dev, card)
        done("(e)")
        fed_training(kernels, dev, card)
        done("(b)")
    finally:
        shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    print(f"phase 9: took {time.perf_counter() - t0:.1f} s ({', '.join(parts)})")


# phase 10: the parallel paths (bnn_tpu_torch.parallel, inference.tp and
# inference.tp_packed), each world in processes of its own: (a) a world of
# one rank over NCCL, (b) two ranks on the one card over gloo
PHASE10_DIR = SMOKE_DIR / "phase10"
PHASE10_TIMEOUT = 300
# Which of gloo's collectives take CUDA tensors under the card's torch
# (2.11), as ``python3 chip_smoke.py --gloo-probe`` found them on the H100:
# a fixed table, so that the phase never decides by catching an exception.
GLOO_CUDA = {"all_gather": True, "all_reduce": True, "broadcast": True,
             "batch_isend_irecv": False}
GLOO_REFUSES = {"batch_isend_irecv": "gloo's TCP pair writes the send from the "
                "tensor's address (writev: Bad address) and the process aborts"}
# the collectives each two-rank path hands gloo; pair_rank runs those that
# GLOO_CUDA allows, and parallel_phase names the others
PAIR_PATHS = {
    "data-parallel ResNet-18": ("all_gather",),
    "tensor-parallel ResNet-18": ("all_gather",),
    "data-parallel ZeRO-1 training step": ("all_reduce", "all_gather"),
    "HeteroPipeline, two stages": ("batch_isend_irecv", "broadcast"),
    "packed_tp_chain, P=2": ("batch_isend_irecv", "all_gather"),
}
# phase 10 (b)'s data-parallel training step: the whole batch over both ranks
PAIR_TRAIN_BATCH = 64
PAIR_TRAIN_STEPS = 3
# rank 0 holds the first step against the plain step on the whole batch:
# the loss at JAX's data-parallel rtol (tests/test_parallel.py:112), and the
# whole gradient by the norm of its difference over its own norm. The
# BatchNorm sums are reduced in another order, which moves a few pre-sign
# activations across zero and gives the output scales under a train-mode
# BatchNorm (a gradient of noise) other values; a gradient not averaged, or
# BatchNorm over a rank's rows alone, is off by far more. Later steps are
# printed, not held: AdamW's first step moves each element by about lr
# whatever the size of its gradient, so an element whose noise gradient
# changed sign lies 2 lr apart, and the arms part from there
PAIR_GRAD_TOL = 1e-3
PAIR_LOSS_RTOL = 1e-5
CHAIN_SIZES = (4096, 4096, 4096, 1024)


def start_ranks(mode: str, world: int, gate=None) -> tuple:
    """Start ``chip_smoke.py --rank <mode>`` in ``world`` processes (one world
    of torch.distributed, rendezvous through a file in the checkout). With a
    ``gate`` (a path), each process imports the port and makes its CUDA
    context, then waits for the file before it joins the world: its start
    overlaps the work before it."""
    d = PHASE10_DIR / mode.replace(":", "-")
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    logs = [open(d / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--rank", mode,
                               str(r), str(world), str(d)] + ([str(gate)] if gate else []),
                              cwd=ROOT, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    return mode, world, d, logs, procs, time.monotonic() + PHASE10_TIMEOUT


def finish_ranks(started: tuple, phase: int = 10) -> list:
    """Wait for :func:`start_ranks`' processes and read each result back;
    raises on a failed rank or past PHASE10_TIMEOUT from the start."""
    mode, world, d, logs, procs, deadline = started
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        stop_ranks(started)
    text = "\n".join(f"--- rank {r}\n" + (d / f"rank{r}.log").read_text()[-4000:]
                     for r in range(world))
    if any(p.returncode for p in procs):
        raise AssertionError(f"phase {phase} ({mode}): a rank failed or ran past "
                             f"{PHASE10_TIMEOUT} s:\n{text}")
    for line in (d / "rank0.log").read_text().splitlines():
        print(line)
    return [json.loads((d / f"rank{r}.json").read_text()) for r in range(world)]


def stop_ranks(started: tuple) -> None:
    """Kill what is left of :func:`start_ranks`' processes; close their logs."""
    for p in started[4]:
        if p.poll() is None:
            p.kill()
            p.wait()
    for f in started[3]:
        f.close()


def run_ranks(mode: str, world: int) -> list:
    """:func:`start_ranks`, then :func:`finish_ranks`."""
    return finish_ranks(start_ranks(mode, world))


def _zero_counts(kernels):
    for k in KERNELS:
        getattr(kernels, k).launches = 0


def _counts(kernels) -> dict:
    torch.cuda.synchronize()
    return {k: getattr(kernels, k).launches for k in KERNELS
            if getattr(kernels, k).launches}


def _check_launches(name, got, want, forwards):
    want = {k: v * forwards for k, v in want.items()}
    if got != want:
        raise AssertionError(f"{name}: expected launches {want}, got {got}")


def _add(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def single_rank(rank: int, world: int, card: str) -> dict:
    """Phase 10 (a), a world of one rank over NCCL: the mesh Predictor, the
    data-parallel ZeRO-1 step, both pipelines with one stage and the packed
    chain at P=1, each against its plain version."""
    from bnn_tpu_torch import kernels
    from bnn_tpu_torch import parallel as P
    from bnn_tpu_torch.inference import (Predictor, pack_chain_weights,
                                         packed_tp_chain, reference_chain)

    dev = torch.device("cuda", 0)
    mesh = P.make_mesh()
    print(f"phase 10: (a) make_mesh() over NCCL: {mesh.shape} on {mesh.device}")
    qat = flagship(torch.Generator().manual_seed(SEED))
    images = torch.randn((BATCH, 3, SIZE, SIZE), generator=torch.Generator().manual_seed(SEED))
    launches: dict = {}
    for b, want in ((4, {"fused_stem": 1, "fused_chain": 4}), (8, R18_8)):
        plain = Predictor(copy.deepcopy(qat), batch_size=b)
        meshed = Predictor(copy.deepcopy(qat), batch_size=b, mesh=mesh)
        x = images[:b].to(dev)
        ref = plain(x)
        _zero_counts(kernels)
        got = meshed(x)
        counts = _counts(kernels)
        _check_launches(f"phase 10 (a) Predictor(mesh=) batch {b}", counts, want, 1)
        _add(launches, counts)
        if not torch.equal(got, ref):
            raise AssertionError(f"phase 10 (a): Predictor(mesh=) at batch {b} is not "
                                 "bit-identical to the plain Predictor")
        print(f"phase 10: (a) Predictor(mesh=1x1, batch_size={b}) bf16: logits "
              f"bit-identical to the plain Predictor's; launches {counts}")
        del plain, meshed

    # the data-parallel step with ZeRO-1 on phase 5 (b)'s configuration
    from bnn_tpu_torch.parallel import make_train_step
    gen = torch.Generator().manual_seed(SEED + 3)
    x = torch.randn((256, 3, SIZE, SIZE), generator=gen).to(dev)
    y = torch.randint(0, 1000, (256,), generator=gen).to(dev)
    arms = {}
    for tag in ("plain", "mesh"):
        model = copy.deepcopy(qat).to(dev).train()
        opt = adamw(model)
        xb, yb = x, y
        if tag == "mesh":
            P.shard_model(model, mesh)
            P.shard_model(opt, mesh)
            P.shard_optimizer_zero1(opt, mesh)
            xb, yb = P.shard_batch((x, y), mesh)
        arms[tag] = (model, opt, xb, yb)
    step = make_train_step(compute_dtype=torch.bfloat16)
    times = {"plain": ([], []), "mesh": ([], [])}
    with cudnn_deterministic():
        for i in range(3):  # in turns, the order flipped each step
            for tag in (("plain", "mesh") if i % 2 == 0 else ("mesh", "plain")):
                model, opt, xb, yb = arms[tag]
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                loss = float(step(model, opt, xb, yb)["loss"])
                end.record()
                torch.cuda.synchronize()
                times[tag][0].append(start.elapsed_time(end))
                times[tag][1].append(loss)
    states = {tag: {k: v.detach().clone() for k, v in arm[0].named_parameters()}
              for tag, arm in arms.items()}
    del arms
    diffs = {k: float((states["mesh"][k].float() - v.float()).abs().max())
             for k, v in states["plain"].items()}
    worst = sorted(diffs.items(), key=lambda kv: -kv[1])[:3]
    print(f"phase 10: (a) data-parallel step (shard_model, shard_optimizer_zero1, "
          f"bf16 compute, batch 256, AdamW, 3 steps, cuDNN deterministic) against the "
          f"plain step: {sum(v == 0 for v in diffs.values())} of {len(diffs)} parameters "
          f"bit-identical, largest difference per parameter max {max(diffs.values()):.3g} "
          f"(worst {worst}); losses {times['mesh'][1]} vs {times['plain'][1]}; ms a step "
          f"in turns (the first with cuDNN's warm-up) {[round(v, 2) for v in times['mesh'][0]]} "
          f"vs plain {[round(v, 2) for v in times['plain'][0]]} | {card}")
    if max(diffs.values()) != 0.0:
        raise AssertionError("phase 10 (a): the data-parallel step at world size 1 "
                             f"differs from the plain step: {worst}")
    del states

    # both pipelines with one stage: the flagship's layer1 in f32
    stage = copy.deepcopy(qat.layer1).to(dev).float().eval()
    h = torch.randn((8, 64, 56, 56), generator=torch.Generator().manual_seed(SEED + 4)).to(dev)
    with torch.no_grad(), cudnn_deterministic():
        direct = torch.cat([stage(c) for c in h.chunk(2)])
        pmesh = P.make_pipeline_mesh(1)
        stacked = P.shard_stacked_state(P.stack_stage_states([stage]), pmesh)
        homo = P.pipeline_apply(P.make_stage_fn(stage), stacked, h, mesh=pmesh,
                                n_microbatches=2)
        hetero = P.HeteroPipeline([stage], (64, 56, 56), pmesh)
        het = hetero.apply(hetero.flat_params, h, n_microbatches=2)
    for name, got in (("pipeline_apply", homo), ("HeteroPipeline", het)):
        if not torch.equal(got, direct):
            raise AssertionError(f"phase 10 (a): {name} with one stage differs from the "
                                 f"stage applied directly: {(got - direct).abs().max()}")
    print("phase 10: (a) pipeline_apply and HeteroPipeline with one stage (ResNet-18 "
          "layer1, f32, batch 8 in 2 microbatches): bit-identical to the stage applied "
          "directly to each microbatch")

    # the packed chain at P=1
    chain, cx = _chain(dev)
    t0 = time.perf_counter()
    got = packed_tp_chain(chain, P.make_mesh(data=1, model=1))(cx)
    torch.cuda.synchronize()
    chain_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(got, reference_chain(chain)(cx)):
        raise AssertionError("phase 10 (a): packed_tp_chain at P=1 differs from reference_chain")
    print(f"phase 10: (a) packed_tp_chain at P=1, M=8, {' -> '.join(map(str, CHAIN_SIZES))}: "
          f"bit-identical to reference_chain ({chain_ms:.1f} ms host clock, plain torch "
          f"partial products) | {card}")
    return {"launches": launches}


def _chain(dev):
    from bnn_tpu_torch.inference import pack_chain_weights

    gen = torch.Generator().manual_seed(SEED + 5)
    sizes = CHAIN_SIZES
    ws = [torch.randn((k, n), generator=gen).sign().numpy() for k, n in zip(sizes, sizes[1:])]
    scales = [(0.5 + torch.rand(n, generator=gen)).numpy() for n in sizes[1:]]
    adds = [torch.randn(n, generator=gen).numpy() for n in sizes[1:]]
    chain = [layer._replace(w_packed=layer.w_packed.to(dev), scale=layer.scale.to(dev),
                            add=layer.add.to(dev))
             for layer in pack_chain_weights(ws, scales, adds)]
    return chain, torch.randn((8, sizes[0]), generator=gen).to(dev)


def pair_rank(rank: int, world: int, card: str) -> dict:
    """Phase 10 (b), two ranks on the one card over gloo: the paths whose
    collectives gloo takes with CUDA tensors (GLOO_CUDA), each against its
    single-process version."""
    from bnn_tpu_torch import kernels
    from bnn_tpu_torch import parallel as P
    from bnn_tpu_torch.inference import Predictor

    dev = torch.device("cuda", 0)
    qat = flagship(torch.Generator().manual_seed(SEED))
    images = torch.randn((BATCH, 3, SIZE, SIZE), generator=torch.Generator().manual_seed(SEED))
    x = images.to(dev)
    launches: dict = {}

    mesh = P.make_mesh(device=dev)
    pred = Predictor(copy.deepcopy(qat), batch_size=BATCH, mesh=mesh)
    plain = Predictor(copy.deepcopy(qat), batch_size=4)
    _zero_counts(kernels)
    got = pred(x)
    counts = _counts(kernels)
    _check_launches("phase 10 (b) data-parallel ResNet-18", counts,
                    {"fused_stem": 1, "fused_chain": 4}, 1)
    _add(launches, counts)
    for half in (0, 1):
        if not torch.equal(got[4 * half:4 * half + 4], plain(x[4 * half:4 * half + 4])):
            raise AssertionError(f"phase 10 (b): rank {rank}: data-parallel rows "
                                 f"{4 * half}-{4 * half + 3} differ from Predictor(batch_size=4)")
    plain8 = Predictor(copy.deepcopy(qat), batch_size=BATCH)
    # host clock, both ranks at once on the one card; in turns
    ms = [fwd_ms(pred, x, 10), fwd_ms(plain8, x, 10), fwd_ms(plain, x[:4], 10),
          fwd_ms(pred, x, 10)]
    print(f"phase 10: (b) data-parallel ResNet-18, Predictor(mesh=2x1, batch_size=8) "
          f"bf16: this rank's 4 rows through {counts}; the gathered logits "
          f"bit-identical to Predictor(batch_size=4) on each half; forward "
          f"{ms[0]:.3f}, {ms[3]:.3f} ms against Predictor(batch_size=8) {ms[1]:.3f} ms "
          f"and batch_size=4 {ms[2]:.3f} ms, host clock, both ranks serving | {card}")
    del pred, plain, plain8

    mesh = P.make_mesh(data=1, model=2, device=dev)
    before = torch.cuda.memory_allocated()
    tp = Predictor(copy.deepcopy(qat), batch_size=BATCH, mesh=mesh, tensor_parallel=True)
    held = torch.cuda.memory_allocated() - before
    ref = Predictor(copy.deepcopy(qat), batch_size=BATCH, fuse=False)
    gemm = tp.model.layer4[0].downsample[1]
    _zero_counts(kernels)
    got = tp(x)
    counts = _counts(kernels)
    _check_launches("phase 10 (b) tensor-parallel ResNet-18", counts,
                    {"binary_gemm": 1, "binary_conv2d": 18}, 1)
    _add(launches, counts)
    if gemm.w_packed.shape[1] != 256 or not torch.equal(got, ref(x)):
        raise AssertionError(f"phase 10 (b): rank {rank}: tensor-parallel ResNet-18 "
                             f"(layer4.0.downsample.1 {tuple(gemm.w_packed.shape)}) "
                             "differs from the replicated unfused Predictor")
    ms = [fwd_ms(tp, x, 10), fwd_ms(ref, x, 10), fwd_ms(tp, x, 10)]
    print(f"phase 10: (b) tensor-parallel ResNet-18, Predictor(mesh=1x2, "
          f"tensor_parallel=True, batch_size=8) bf16: {len(tp.tp_layers)} of "
          f"{tp.tp_total} deployed layers sharded, layer4.0.downsample.1 on "
          f"binary_gemm at N={gemm.w_packed.shape[1]}; logits bit-identical to the "
          f"replicated unfused Predictor; launches {counts}; state_bytes "
          f"{tp.state_bytes()} B (logical), {tp.local_state_bytes()} B on this rank "
          f"against {ref.state_bytes()} B replicated; card memory the predictor holds "
          f"{held / 1e6:.1f} MB; forward {ms[0]:.3f}, {ms[2]:.3f} ms against the "
          f"replicated unfused {ms[1]:.3f} ms, host clock, both ranks serving | {card}")
    del tp, ref

    return {"launches": launches, "train": pair_train(rank, qat, dev, card)}


def pair_train(rank: int, qat, dev, card: str) -> dict:
    """Phase 10 (b): the flagship's data-parallel step with shard_model and
    shard_optimizer_zero1 over the two ranks (f32, AdamW, BatchNorm over the
    whole batch), held (1) after every step to AdamW stepping the whole
    parameters on the same averaged gradients, bit for bit (ZeRO-1's cut
    update and its all-gather), (2) on rank 0 to the plain step on the whole
    batch (the first step's loss and gradient within PAIR_LOSS_RTOL and
    PAIR_GRAD_TOL; later losses and each parameter's largest difference
    printed); returns a digest of the
    parameters, which the ranks must share."""
    import hashlib

    import torch.distributed as dist

    from bnn_tpu_torch import parallel as P

    gen = torch.Generator().manual_seed(SEED + 3)
    x = torch.randn((PAIR_TRAIN_BATCH, 3, SIZE, SIZE), generator=gen).to(dev)
    y = torch.randint(0, 1000, (PAIR_TRAIN_BATCH,), generator=gen).to(dev)
    mesh = P.make_mesh(device=dev)
    model = copy.deepcopy(qat).to(dev).train()
    if rank == 0:
        base = copy.deepcopy(model)
        base_opt = adamw(base)
    shadow = [p.detach().clone().requires_grad_() for p in model.parameters()]
    shadow_opt = torch.optim.AdamW(shadow, lr=1e-3, weight_decay=1e-4)
    opt = adamw(model)
    P.shard_model(model, mesh)
    P.shard_model(opt, mesh)
    P.shard_optimizer_zero1(opt, mesh)
    cut = len(opt._bnn_zero1.entries)
    xb, yb = P.shard_batch((x, y), mesh)
    step = P.make_train_step()
    ms = {"mesh": [], "plain": []}
    losses = {"mesh": [], "plain": []}
    with cudnn_deterministic():
        for i in range(PAIR_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses["mesh"].append(float(step(model, opt, xb, yb)["loss"]))
            ms["mesh"].append((time.perf_counter() - t0) * 1e3)
            for s, p in zip(shadow, model.parameters()):
                s.grad = None if p.grad is None else p.grad.detach().clone()
            shadow_opt.step()
            bad = [n for (n, p), s in zip(model.named_parameters(), shadow)
                   if not torch.equal(p, s)]
            if bad:
                raise AssertionError(f"phase 10 (b): rank {rank}: after ZeRO-1 step {i + 1} "
                                     f"{len(bad)} parameters differ from AdamW on the whole "
                                     f"parameters: {bad[:3]}")
            if rank == 0:  # the other rank waits at the barrier meanwhile
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses["plain"].append(float(step(base, base_opt, x, y)["loss"]))
                ms["plain"].append((time.perf_counter() - t0) * 1e3)
                if i == 0:
                    pairs = [(n, p.grad, q.grad) for (n, p), q in
                             zip(model.named_parameters(), base.parameters())
                             if q.grad is not None]
                    grad_err = {n: float((g - h).abs().max() / h.abs().max().clamp_min(1e-30))
                                for n, g, h in pairs}
                    grad_norm = float(torch.stack([(g - h).double().norm() for _, g, h in pairs])
                                      .norm() / torch.stack([h.double().norm()
                                                             for _, _, h in pairs]).norm())
            dist.barrier()
    digest = hashlib.sha1()
    for p in model.parameters():
        digest.update(p.detach().cpu().numpy().tobytes())
    if rank != 0:
        return {"digest": digest.hexdigest()}
    diffs = {n: float((p - q).abs().max())
             for (n, p), q in zip(model.named_parameters(), base.parameters())}
    worst_grad = sorted(grad_err.items(), key=lambda kv: -kv[1])[:3]
    worst = sorted(diffs.items(), key=lambda kv: -kv[1])[:3]
    print(f"phase 10: (b) data-parallel ZeRO-1 training step over 2 ranks (flagship "
          f"ResNet-18, f32, batch {PAIR_TRAIN_BATCH} = 2 x {PAIR_TRAIN_BATCH // 2}, AdamW, "
          f"{PAIR_TRAIN_STEPS} steps, cuDNN deterministic; {cut} parameters' moments cut "
          f"in two): every step bit-identical on each rank to AdamW on the whole "
          f"parameters with the averaged gradients; against the plain step on the whole "
          f"batch: step 1's whole gradient |g - g_plain| / |g_plain| {grad_norm:.3g} "
          f"(limit {PAIR_GRAD_TOL}), per parameter as a share of its largest element max "
          f"{max(grad_err.values()):.3g} (worst {worst_grad}); losses {losses['mesh']} vs "
          f"{losses['plain']} (the first held at rtol {PAIR_LOSS_RTOL}); after "
          f"{PAIR_TRAIN_STEPS} steps {sum(v == 0 for v in diffs.values())} of {len(diffs)} "
          f"parameters bit-identical, largest difference per parameter max "
          f"{max(diffs.values()):.3g} (worst {worst}; AdamW moves an element by about "
          f"lr = 1e-3 a step); ms a step, host clock, {[round(v, 2) for v in ms['mesh']]} "
          f"(gloo through the host) vs plain {[round(v, 2) for v in ms['plain']]} | {card}")
    if not grad_norm <= PAIR_GRAD_TOL:
        raise AssertionError(f"phase 10 (b): the data-parallel gradient differs from the "
                             f"plain step's by {grad_norm} of its norm: {worst_grad}")
    if abs(losses["mesh"][0] - losses["plain"][0]) > PAIR_LOSS_RTOL * abs(losses["plain"][0]):
        raise AssertionError(f"phase 10 (b): the data-parallel first loss "
                             f"{losses['mesh'][0]} against plain {losses['plain'][0]}")
    return {"digest": digest.hexdigest()}


PROBE_OPS = ("all_gather", "all_reduce", "broadcast", "batch_isend_irecv")


def probe_rank(rank: int, world: int, card: str, op: str) -> dict:
    """``--gloo-probe``: one collective the parallel paths use, on CUDA
    tensors over gloo, by two ranks on the one card."""
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    if op == "all_gather":
        dist.all_gather([torch.empty(4, device=dev) for _ in range(world)],
                        torch.full((4,), float(rank), device=dev))
    elif op == "all_reduce":
        dist.all_reduce(torch.ones(4, device=dev))
    elif op == "broadcast":
        dist.broadcast(torch.full((4,), float(rank), device=dev), src=1)
    else:
        for w in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, torch.full((4,), float(rank), device=dev), 1 - rank),
                dist.P2POp(dist.irecv, torch.empty(4, device=dev), 1 - rank)]):
            w.wait()
    torch.cuda.synchronize()
    return {}


def gloo_probe() -> None:
    """Each collective in a world of its own (a refusal can abort the
    process): what gloo takes with CUDA tensors on this torch."""
    for op in PROBE_OPS:
        try:
            run_ranks(f"probe:{op}", 2)
            print(f"gloo probe, torch {torch.__version__}: {op} on CUDA tensors: ok")
        except AssertionError as e:  # the probe's question: did the ranks fail
            last = [line for line in str(e).splitlines() if line.strip()][-3:]
            print(f"gloo probe, torch {torch.__version__}: {op} on CUDA tensors: "
                  f"refused: {' | '.join(last)}")


def rank_main(argv) -> int:
    """``--rank <mode> <rank> <world> <dir> [gate]``: one rank of a phase-10
    or phase-11 world; with a gate, the port imported and the CUDA context
    made first, the world joined once the gate file exists."""
    import datetime
    import os

    import torch.distributed as dist

    mode, rank, world, d = argv[0], int(argv[1]), int(argv[2]), pathlib.Path(argv[3])
    mode, _, op = mode.partition(":")
    sys.path.insert(0, str(ROOT))
    torch.cuda.set_device(0)
    if len(argv) > 4:
        # what a first call pays, paid while the gate is shut: the port, the
        # CUDA context, the kernel libraries, cuDNN and cuBLAS
        importlib.import_module("bnn_tpu_torch.examples.imagenet")
        importlib.import_module("bnn_tpu_torch.examples.serve")
        from bnn_tpu_torch.kernels import _build
        for name in ("binary_gemm", "fused_stem", "fused_chain"):
            _build.load(name)
        x = torch.randn((2, 3, 16, 16), device="cuda")
        torch.nn.functional.conv2d(x, torch.randn((4, 3, 3, 3), device="cuda"))
        (x.reshape(48, 32) @ x.reshape(32, 48)).sum().item()
        gate, deadline = pathlib.Path(argv[4]), time.monotonic() + PHASE10_TIMEOUT
        while not gate.exists():
            if time.monotonic() > deadline:
                raise TimeoutError(f"no {gate} after {PHASE10_TIMEOUT} s")
            time.sleep(0.2)
    backend = "nccl" if mode == "single" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{d / 'store'}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = card_line()
        if mode == "probe":
            res = probe_rank(rank, world, card, op)
        else:
            res = {"single": single_rank, "pair": pair_rank,
                   "cli_export": cli_export_rank,
                   "cli_load": cli_load_rank}[mode](rank, world, card)
        tmp = d / f"rank{rank}.json.tmp"
        tmp.write_text(json.dumps(res))
        os.replace(tmp, d / f"rank{rank}.json")
    finally:
        dist.destroy_process_group()
    return 0


def parallel_phase(card) -> dict:
    """Phase 10: (a) a world of one rank over NCCL, then (b) two ranks on the
    one card over gloo; returns the launches by kernel name of both."""
    t0 = time.perf_counter()
    launches: dict = {}
    _add(launches, run_ranks("single", 1)[0]["launches"])
    print("phase 10: (b) gloo with CUDA tensors on torch 2.11 (GLOO_CUDA, from "
          f"chip_smoke.py --gloo-probe): {GLOO_CUDA}")
    for name, need in PAIR_PATHS.items():
        missing = [c for c in need if not GLOO_CUDA[c]]
        if missing:
            print(f"phase 10: (b) {name}: not run on the card: gloo takes no CUDA "
                  f"tensors in {missing} ({'; '.join(GLOO_REFUSES[c] for c in missing)}); "
                  "held by the CPU tests "
                  "(tests/test_torch_parallel.py, test_torch_pipeline.py, "
                  "test_torch_tp_serving.py)")
    pair = run_ranks("pair", 2)
    for r in pair:
        _add(launches, r["launches"])
    if pair[0]["train"]["digest"] != pair[1]["train"]["digest"]:
        raise AssertionError("phase 10 (b): after the data-parallel ZeRO-1 steps the two "
                             "ranks hold different parameters")
    print("phase 10: (b) both ranks hold bit-identical parameters after the "
          "data-parallel ZeRO-1 steps")
    shutil.rmtree(PHASE10_DIR, ignore_errors=True)
    print(f"phase 10: took {time.perf_counter() - t0:.1f} s; launches {launches}")
    return launches


# phase 11: the serve CLI's --data-parallel / --tensor-parallel and the
# ImageNet trainer, each main(argv) in rank processes (``--rank``): (a) a
# world of one over NCCL, (b) and (c) two ranks on the one card over gloo
PHASE11_DIR = SMOKE_DIR / "phase11"
RECIPE_BASELINE = ROOT / "examples" / "recipes" / "imagenet-baseline.yaml"
TRAINER_ARGS = ["--synthetic", "--arch", "resnet18", "--image-size", str(SIZE),
                "--steps-per-epoch", "4", "--print-freq", "1", "--recipe",
                str(RECIPE_BASELINE)]
PAIR_TRAINER_ARGS = ["--synthetic", "--arch", "resnet18", "--image-size", str(SIZE),
                     "-b", "64", "--steps-per-epoch", "2", "--epochs", "1",
                     "--print-freq", "1", "--recipe", str(RECIPE_BASELINE),
                     "--device", "cuda:0", "--dist-backend", "gloo"]
SERVE_CLI_ARGS = ["--device", "cuda:0", "--dist-backend", "gloo", "--num-classes", "1000",
                  "--size", str(SIZE), "--batch-size", str(BATCH), "--requests", "2"]
# launches a forward per rank: the data-parallel rank's 4 rows through the
# stem and stage kernels; the tensor-parallel rank's layer4.0.downsample.1 on
# binary_gemm at N = 512 / 2 (the other deployed convs run the int8 conv)
CLI_LAUNCHES = {"dp": {"fused_stem": 1, "fused_chain": 4},
                "tp": {"binary_gemm": 1, "binary_conv2d": 18}}


def printed(main, argv) -> str:
    """``main(argv)``'s standard output."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def trainer_losses(text: str) -> list:
    import re

    return [float(v) for v in re.findall(r"\tLoss ([-+0-9.e]+|nan|inf) \(", text)]


def trainer_rates(text: str) -> str:
    import re

    rates = re.findall(r" \* Epoch \d+: .*?\(([0-9.]+ images/s)\); ([0-9.]+ ms a step)",
                       text)
    return "; ".join(f"{a}, {b}" for a, b in rates)


def trainer_runs(card: str) -> None:
    """Phase 11 (a), in this process, a world of one rank over NCCL: ``python
    -m bnn_tpu_torch.examples.imagenet`` (its ``main``) at full width,
    224x224, batch 256 in bf16 through imagenet-baseline.yaml step 0; resumed
    to epoch 2 (the optimizer restored, training from ``Epoch[1]``);
    ``--evaluate``; ``--zero1``."""
    from bnn_tpu_torch import kernels
    from bnn_tpu_torch.examples import imagenet
    from bnn_tpu_torch.utils import load_checkpoint

    out = PHASE11_DIR / "trainer"
    base = TRAINER_ARGS + ["-b", "256", "--bf16", "--device", "cuda:0"]
    runs = {"train": ["--epochs", "1", "--out", str(out)],
            "resume": ["--epochs", "2", "--out", str(out), "--resume", str(out)],
            "evaluate": ["--epochs", "2", "--out", str(out), "--resume", str(out),
                         "--evaluate"],
            "zero1": ["--epochs", "1", "--zero1", "--out", str(out) + "-zero1"]}
    _zero_counts(kernels)
    texts = {}
    for name, extra in runs.items():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        # each run makes its own world of one over NCCL and destroys it
        texts[name] = text = printed(imagenet.main, base + extra)
        seconds = time.perf_counter() - t0
        losses = trainer_losses(text)
        print(f"phase 11: (a) imagenet {name} ({' '.join(extra)}): {seconds:.1f} s; "
              f"losses {[round(v, 4) for v in losses]}; "
              f"{trainer_rates(text) or 'no training'}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB | {card}")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"phase 11 (a) {name}: a loss is not finite: {losses}")
    if "Epoch[0][3/4]" not in texts["train"] or len(trainer_losses(texts["train"])) != 4:
        raise AssertionError(f"phase 11 (a): the trainer did not take 4 steps:\n{texts['train']}")
    resumed = texts["resume"]
    if ("Epoch[1][0/4]" not in resumed or "Epoch[0]" in resumed
            or "moments reset" in resumed or "skipped" in resumed):
        raise AssertionError(f"phase 11 (a): the resumed run:\n{resumed}")
    steps = {float(st["step"]) for st in load_checkpoint(str(out))["opt_state"]["state"].values()}
    if steps != {8.0}:
        raise AssertionError(f"phase 11 (a): the resumed optimizer's step counts {steps}, "
                             "not 8 (4 restored + 4)")
    if " * Evaluate: Acc@1" not in texts["evaluate"] or "Epoch[" in texts["evaluate"]:
        raise AssertionError(f"phase 11 (a): --evaluate:\n{texts['evaluate']}")
    if "==> mesh {'data': 1, 'model': 1} over 1 ranks" not in texts["zero1"]:
        raise AssertionError(f"phase 11 (a): --zero1:\n{texts['zero1']}")
    print("phase 11: (a) the resumed run restored the optimizer (8 AdamW steps in the "
          "checkpoint) and trained from Epoch[1]; --evaluate trained nothing; the "
          f"trainer launched {_counts(kernels) or 'none'} of the serving kernels")


def cli_export_rank(rank: int, world: int, card: str) -> dict:
    """Phase 11 (b) and (c), two ranks on the one card over gloo: the serve
    CLI's ``--data-parallel 2`` and ``--tensor-parallel 2 --export``, the
    live mesh predictor the CLI built (``main``'s return) kept on rank 0
    (its logits on the phase's images); then the trainer with ``--zero1`` and with
    ``--model-parallel 2``."""
    from bnn_tpu_torch.examples import imagenet, serve

    dev = torch.device("cuda", 0)
    images = torch.randn((BATCH, 3, SIZE, SIZE),
                         generator=torch.Generator().manual_seed(SEED)).to(dev)
    say = print if rank == 0 else (lambda *a: None)
    for tag, flag in (("dp", "--data-parallel"), ("tp", "--tensor-parallel")):
        t0 = time.perf_counter()
        served = []
        text = printed(lambda argv: served.append(serve.main(argv)), SERVE_CLI_ARGS + [
            flag, "2", "--export", str(PHASE11_DIR / f"bundle_{tag}")])
        seconds = time.perf_counter() - t0
        for line in text.splitlines():
            say(f"phase 11: (b) serve {flag} 2 --export: {line}")
        say(f"phase 11: (b) serve {flag} 2 --export took {seconds:.1f} s | {card}")
        if rank == 0 and "exported serving bundle" not in text:
            raise AssertionError(f"phase 11 (b) {flag} --export:\n{text}")
        live = served[0](images)  # the live mesh predictor the CLI exported
        if rank == 0:
            torch.save(live.cpu(), PHASE11_DIR / f"live_{tag}.pt")
        del live
    for name, extra in (("--zero1", ["--zero1"]), ("--model-parallel 2",
                                                  ["--model-parallel", "2"])):
        t0 = time.perf_counter()
        text = printed(imagenet.main, PAIR_TRAINER_ARGS + extra + [
            "--out", str(PHASE11_DIR / f"pair-{extra[0][2:]}")])
        seconds = time.perf_counter() - t0
        losses = trainer_losses(text)
        if rank == 0 and (len(losses) != 2 or not all(math.isfinite(v) for v in losses)):
            raise AssertionError(f"phase 11 (c) {name}: losses {losses}:\n{text}")
        say(f"phase 11: (c) imagenet {name} on two gloo ranks (f32, batch 64, 2 steps): "
            f"{seconds:.1f} s; losses {[round(v, 4) for v in losses]}; "
            f"{trainer_rates(text)} | {card}")
    return {}


def cli_load_rank(rank: int, world: int, card: str) -> dict:
    """Phase 11 (b) in a fresh world of two ranks on the one card over gloo:
    the serve CLI's ``--load`` of each mesh bundle (2 requests, launches
    counted by kernel name), then each bundle through ``load_serving``: its
    logits bit-identical to the live mesh predictor's, this rank's
    ``state_bytes`` and the card memory its state takes."""
    from bnn_tpu_torch import kernels
    from bnn_tpu_torch.examples import serve
    from bnn_tpu_torch.inference import load_serving

    dev = torch.device("cuda", 0)
    images = torch.randn((BATCH, 3, SIZE, SIZE),
                         generator=torch.Generator().manual_seed(SEED)).to(dev)
    launches, report = {}, {}
    for tag in ("dp", "tp"):
        path = str(PHASE11_DIR / f"bundle_{tag}")
        _zero_counts(kernels)
        t0 = time.perf_counter()
        text = printed(serve.main, SERVE_CLI_ARGS + ["--load", path])
        seconds = time.perf_counter() - t0
        counts = _counts(kernels)
        _check_launches(f"phase 11 (b) serve --load {tag} (rank {rank})", counts,
                        CLI_LAUNCHES[tag], 2)
        _add(launches, counts)
        if rank == 0:
            for line in text.splitlines():
                print(f"phase 11: (b) serve --load bundle_{tag}: {line}")
            print(f"phase 11: (b) serve --load bundle_{tag}: {seconds:.1f} s; rank 0 "
                  f"launches {counts} over 2 requests | {card}")
        gc.collect()  # the CLI's server, so that its memory is not counted as freed
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        server = load_serving(path, device=dev)
        held = torch.cuda.memory_allocated() - before
        got = server(images)
        if not torch.equal(got.cpu(), torch.load(PHASE11_DIR / f"live_{tag}.pt")):
            raise AssertionError(f"phase 11 (b): rank {rank}: the loaded {tag} bundle is "
                                 "not bit-identical to the live mesh predictor")
        n = None
        if tag == "tp":
            n = server.program.state_dict["model.layer4.0.downsample.1.w_packed"].shape[1]
            if n != 256:
                raise AssertionError(f"phase 11 (b): rank {rank}: layer4.0.downsample.1 "
                                     f"holds N = {n} on this rank, not 256")
        report[tag] = {"state_bytes": server.state_bytes(), "card_bytes": held,
                       "mesh": server.mesh.shape, "n": n}
        del server
    return {"launches": launches, "report": report}


def cli_phase(card) -> dict:
    """Phase 11: (a) the trainer in a world of one rank over NCCL (this
    process's), then (b)
    the serve CLI's mesh bundles exported in one world of two gloo ranks on
    the one card and loaded in another, with (c) the trainer's ZeRO-1 and
    tensor-parallel runs in the first; returns the launches by kernel name."""
    t0 = time.perf_counter()
    shutil.rmtree(PHASE11_DIR, ignore_errors=True)
    PHASE11_DIR.mkdir(parents=True)
    launches: dict = {}
    # each world's processes start now and join their world when its gate
    # opens: their start-up overlaps the work before them
    exporting = start_ranks("cli_export", 2, gate=PHASE11_DIR / "export-go")
    loading = start_ranks("cli_load", 2, gate=PHASE11_DIR / "load-go")
    try:
        trainer_runs(card)
        (PHASE11_DIR / "export-go").touch()
        finish_ranks(exporting, phase=11)
        (PHASE11_DIR / "load-go").touch()
        loaded = finish_ranks(loading, phase=11)
    finally:
        stop_ranks(exporting)
        stop_ranks(loading)
    for r, res in enumerate(loaded):
        _add(launches, res["launches"])
        for tag, rep in res["report"].items():
            print(f"phase 11: (b) load_serving(bundle_{tag}) on rank {r} of the fresh world "
                  f"(mesh {rep['mesh']}): logits bit-identical to the live mesh predictor's; "
                  f"state_bytes {rep['state_bytes']} B on this rank, card memory its state "
                  f"takes {rep['card_bytes'] / 1e6:.2f} MB"
                  + (f"; layer4.0.downsample.1 at N={rep['n']}" if rep["n"] else "")
                  + f" | {card}")
    print(f"phase 11: (b) --pipeline 2 not run on the card: gloo takes no CUDA tensors in "
          f"batch_isend_irecv ({GLOO_REFUSES['batch_isend_irecv']}); held by the CPU tests "
          "(tests/test_torch_imagenet_example.py)")
    shutil.rmtree(PHASE11_DIR, ignore_errors=True)
    shutil.rmtree(PHASE10_DIR, ignore_errors=True)
    print(f"phase 11: took {time.perf_counter() - t0:.1f} s; launches {launches}")
    return launches


def plain_phase(kernels, Predictor, dev, card) -> dict:
    """Phase 12: the plain serving paths beside the kernels. For the
    flagship ResNet-18 at batch 1 and 8, ResNet-50 at batch 8 and path C
    (the Z1-PReLU ResNet-50 with ``binary_gemm_impl='popcount'``) at batch
    8, the default ``Predictor`` and ``Predictor(use_pallas=False)`` of the
    same weights: the ten kernels' launches (phase 3's under the default,
    none under ``use_pallas=False``), their f32 logits against each other
    (1e-3, argmax equal), and in bf16 each one's forward latency (host
    clock, in turns) and device busy. Returns the default paths' launches."""
    t0 = time.perf_counter()
    images = torch.randn((BATCH, 3, SIZE, SIZE),
                         generator=torch.Generator().manual_seed(SEED + 41))
    qat18 = flagship(torch.Generator().manual_seed(SEED))
    qat50 = flagship(torch.Generator().manual_seed(SEED), depth=50)
    qz50 = flagship(torch.Generator().manual_seed(SEED), depth=50, z1_prelu=True)
    popcount = {"binary_gemm_impl": "popcount"}
    paths = (("ResNet-18", qat18, 1, {}, {"fused_stem": 1, "fused_chain": 4}),
             ("ResNet-18", qat18, BATCH, {}, R18_8),
             ("ResNet-50", qat50, BATCH, {}, R50_8),
             ("path C: Z1-PReLU ResNet-50 popcount", qz50, BATCH, popcount, PATH_C))
    totals = dict.fromkeys(KERNELS, 0)
    for name, qat, b, kw, want in paths:
        xb = images[:b]
        preds = {}
        for mode, extra, want_pf in (("kernels", {}, want),
                                     ("plain", {"use_pallas": False}, {})):
            preds[mode] = Predictor(copy.deepcopy(qat), batch_size=b, **kw, **extra)
            _, launches = serve_counted(
                kernels, preds[mode], (xb, xb), f"{name} Predictor(batch_size={b}"
                f"{', use_pallas=False' if extra else ''}) bf16", want_pf, phase=12)
            if mode == "kernels":
                for k, v in launches.items():
                    totals[k] += v
        logits = {}
        for mode, extra in (("kernels", {}), ("plain", {"use_pallas": False})):
            pred32 = Predictor(copy.deepcopy(qat), batch_size=b, dtype=None, **kw, **extra)
            logits[mode] = pred32(xb).cpu()
        torch.testing.assert_close(logits["kernels"], logits["plain"], rtol=1e-3, atol=1e-3)
        if not bool((logits["kernels"].argmax(1) == logits["plain"].argmax(1)).all()):
            raise AssertionError(f"phase 12: {name} batch {b}: argmax differs between "
                                 "the kernels and use_pallas=False")
        gap = (logits["kernels"] - logits["plain"]).abs().max().item()
        xd = xb.to(dev)
        fwd = {"kernels": [], "plain": []}
        for mode in ("kernels", "plain", "plain", "kernels"):
            fwd[mode].append(fwd_ms(preds[mode], xd, iters=10))
        busy = {mode: sum(device_profile(lambda p=pred: p(xd), iters=5,
                                         whole=False)[0].values())
                for mode, pred in preds.items()}
        print(f"phase 12: {name} batch {b} bf16: kernels "
              f"{[round(v, 3) for v in fwd['kernels']]} ms a forward, device busy "
              f"{busy['kernels']:.3f} ms; use_pallas=False "
              f"{[round(v, 3) for v in fwd['plain']]} ms, device busy "
              f"{busy['plain']:.3f} ms; f32 logits max |diff| {gap:.3g} (limit 1e-3), "
              f"argmax equal | {card}")
    print(f"phase 12: took {time.perf_counter() - t0:.1f} s; launches of the default "
          f"paths {totals}")
    return totals


def forwards_only() -> int:
    """``--forwards``: the live predictor's forward at ResNet-18 batch 1 and
    8 and ResNet-50 batch 1 (bf16, 224x224, the flagship recipe's random
    weights), host clock (three runs of 50 synchronised forwards, and three
    of 50 issued back to back: the host's own time) and device busy, for the
    ``bnn_tpu_torch`` of the current directory: run from a parent unpacked
    with ``git archive`` and from the change, in turns, it shows what a
    change costs a forward on the host. Prints the card line, then one JSON
    line a path."""
    import os

    sys.path.insert(0, os.getcwd())
    from bnn_tpu_torch.inference import Predictor
    from bnn_tpu_torch.kernels import _build

    _build.build()
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    images = torch.randn((BATCH, 3, SIZE, SIZE), generator=torch.Generator().manual_seed(SEED))
    for depth, b in ((18, 1), (18, BATCH), (50, 1)):
        pred = Predictor(flagship(torch.Generator().manual_seed(SEED), depth=depth),
                         batch_size=b)
        xb = images[:b].to(dev)
        fwd = [fwd_ms(pred, xb, iters=50) for _ in range(3)]
        issue = [host_ms(lambda: pred(xb), iters=50) for _ in range(3)]
        by_kernel, _ = device_profile(lambda: pred(xb), iters=10, whole=False)
        print(json.dumps({"label": os.path.basename(os.getcwd()),
                          "path": f"ResNet-{depth} batch {b}", "forward_ms": fwd,
                          "host_issue_ms": issue, "busy_ms": sum(by_kernel.values()),
                          "card": card}))
    return 0


def main() -> int:
    quick = "--quick" in sys.argv[1:]
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "measures the port on a GPU and has nothing to run here",
              file=sys.stderr)
        return 1
    if "--forwards" in sys.argv[1:]:
        return forwards_only()
    if sys.argv[1:2] == ["--rank"]:
        return rank_main(sys.argv[2:])
    if "--gloo-probe" in sys.argv[1:]:
        print(card_line())
        gloo_probe()
        return 0
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
    if "--zoo" in sys.argv[1:]:
        zoo_phase(kernels, Predictor, dev, card,
                  {"fused_chain": 0.0, "fused_basic_block": 0.0, "binary_gemm": 0.0},
                  dict.fromkeys(KERNELS, 0))
        print("chip_smoke: --zoo: phases 1 and 8 passed", file=sys.stderr)
        return 0
    if "--trainer" in sys.argv[1:]:
        trainer_phase(kernels, dev, card)
        print("chip_smoke: --trainer: phases 1 and 9 passed", file=sys.stderr)
        return 0
    if "--parallel" in sys.argv[1:]:
        parallel_phase(card)
        print("chip_smoke: --parallel: phases 1 and 10 passed", file=sys.stderr)
        return 0
    if "--cli" in sys.argv[1:]:
        cli_phase(card)
        print("chip_smoke: --cli: phases 1 and 11 passed", file=sys.stderr)
        return 0
    if "--plain" in sys.argv[1:]:
        plain_phase(kernels, Predictor, dev, card)
        print("chip_smoke: --plain: phases 1 and 12 passed", file=sys.stderr)
        return 0
    for name in ("binary_gemm", "binary_conv2d_s1", "popcount_gemm", "fused_chain",
                 "fused_basic_block", "fused_downsample_block", "fused_stem_chain",
                 "fused_bottleneck", "fused_stem", "binary_conv2d"):
        counts, line = sass_counts(_build._target(name))
        print(f"phase 1: lib{name}: {line}")
        if name in ("fused_chain", "fused_bottleneck", "fused_basic_block",
                    "fused_downsample_block", "fused_stem_chain", "binary_conv2d") and (
                counts is None or counts["IMMA"] == 0 or counts["IDP4A"] > 0):
            raise AssertionError(f"lib{name}: {line}; its GEMM phases run "
                                 "on the int8 tensor cores, not __dp4a")
        if name in ("fused_stem", "fused_stem_chain") and (
                counts is None or counts["HMMA"] == 0):
            raise AssertionError(f"lib{name}: {line}; the stem's conv runs on "
                                 "the bf16 tensor cores")

    gen = torch.Generator().manual_seed(SEED)
    gemm_err = check_gemm(kernels, BATCH * 7 * 7, 256, 512, torch.bfloat16,
                          False, gen, dev)
    check_gemm(kernels, 37, 77, 65, torch.float32, True, gen, dev)
    check_gemm(kernels, 37, 300, 65, torch.bfloat16, True, gen, dev)
    # every tile and loader instance; its own generator keeps the draws
    # below as they were
    gemm_err = max(gemm_err, check_gemms(kernels, torch.Generator().manual_seed(SEED + 2),
                                         dev))
    stem_err = check_stem(kernels, (BATCH, SIZE, SIZE, 3), gen, dev)  # v3
    check_stem(kernels, (1, SIZE, SIZE - 4, 3), gen, dev)     # v2: B=1, W%8
    check_stem(kernels, (2, 200, 196, 3), gen, dev)           # v1: H%16
    # f32 weights (3 passes) and f32 x and weights (6 passes), on their own
    # generator so that every other case draws as before
    gen_stem = torch.Generator().manual_seed(SEED + 5)
    stem_err = max(stem_err, check_stem(kernels, (BATCH, SIZE, SIZE, 3), gen_stem, dev,
                                        w_dtype=torch.float32))
    check_stem(kernels, (BATCH, SIZE, SIZE, 3), gen_stem, dev, torch.float32,
               torch.float32)
    # the batches R18, R50 and path A feed the stem besides 8, and a
    # geometry whose last item has fewer pooled rows than the plan's
    for shape in ((4, SIZE, SIZE, 3), (1, SIZE, SIZE, 3),
                  partial_stem_shape(kernels, dev)):
        stem_err = max(stem_err, check_stem(kernels, shape, gen_stem, dev))
    # the JAX package's v2 and v3 entry points, each through its own name,
    # then bf16 x stored as f32 by the kernel (out_dtype), and each entry
    # point's refusal of a shape outside its scope
    gen_entry = torch.Generator().manual_seed(SEED + 40)
    for entry, shape in (("fused_stem_v2", (1, SIZE, SIZE - 4, 3)),
                         ("fused_stem_v3", (BATCH, SIZE, SIZE, 3)),
                         ("fused_stem_v3", (1, SIZE, SIZE, 3))):
        stem_err = max(stem_err, check_stem(kernels, shape, gen_entry, dev,
                                            entry=entry))
    for entry, shape in (("fused_stem_v3", (BATCH, SIZE, SIZE, 3)),
                         ("fused_stem_v2", (1, SIZE, SIZE, 3)),
                         ("fused_stem", (1, SIZE, SIZE, 3))):
        stem_err = max(stem_err, check_stem(kernels, shape, gen_entry, dev,
                                            entry=entry, out_dtype=torch.float32))
    w_out = torch.zeros((7, 7, 3, 64), dtype=torch.bfloat16, device=dev)
    for entry, shape in (("fused_stem", (1, 220, SIZE, 3)),
                         ("fused_stem_v2", (2, SIZE, SIZE, 3)),
                         ("fused_stem_v3", (1, SIZE, SIZE - 4, 3))):
        try:
            getattr(kernels.stem, entry)(
                torch.zeros(shape, dtype=torch.bfloat16, device=dev), w_out)
        except ValueError as e:
            print(f"phase 2: {entry} refuses {shape}: {e}")
        else:
            raise AssertionError(f"{entry} took {shape}, outside its scope")
    block_errs = check_blocks(kernels, gen, dev)
    block_errs["fused_bottleneck"] = check_bottlenecks(kernels, gen, dev)
    # the opt-in paths' kernels draw from their own generator, so that the
    # inputs above and the images below stay as they were
    gen_opt = torch.Generator().manual_seed(SEED + 1)
    conv_err = check_convs(kernels, gen_opt, dev)
    pop_err = check_popcounts(kernels, gen_opt, dev)
    entry_err = check_stem_chains(kernels, gen_opt, dev)
    conv2d_err = check_conv2ds(kernels, torch.Generator().manual_seed(SEED + 50), dev)
    if quick:
        print("chip_smoke: --quick: phases 1 and 2 passed", file=sys.stderr)
        return 0

    from bnn_tpu_torch.inference import (fuse_entry, megablock,
                                         optimize_deployed,
                                         space_to_depth_stem, stages)
    deploy = importlib.import_module("bnn_tpu_torch.inference.deploy")
    qat = flagship(torch.Generator().manual_seed(SEED))
    images = torch.randn((24, 3, SIZE, SIZE), generator=gen)
    totals = dict.fromkeys(KERNELS, 0)

    def add(launches):
        for k, v in launches.items():
            totals[k] += v

    pred = Predictor(copy.deepcopy(qat), batch_size=BATCH)
    outs, launches = serve_counted(
        kernels, pred, (images[:8], images[8:11], images[11:24]),
        "ResNet-18 Predictor(batch_size=8) bf16",
        {"binary_gemm": 1, "fused_stem": 1, "binary_conv2d": 18})
    add(launches)
    gpu32 = Predictor(copy.deepcopy(qat), batch_size=BATCH, dtype=None)
    cpu32 = Predictor(copy.deepcopy(qat), batch_size=BATCH, dtype=None,
                      device="cpu")
    ref8 = cpu32(images[:BATCH])
    check_f32(gpu32, ref8, images[:BATCH], "ResNet-18 batch 8")
    bf16_gap = (outs[0].float().cpu() - ref8).abs().max().item()
    print(f"phase 3: bf16 serving vs f32 CPU at batch 8: max |diff| {bf16_gap:.3g}")

    small = {}
    for b, requests in ((1, (images[:1], images[1:3])), (4, (images[:4], images[4:7]))):
        small[b] = Predictor(copy.deepcopy(qat), batch_size=b)
        _, launches = serve_counted(
            kernels, small[b], requests, f"ResNet-18 Predictor(batch_size={b}) bf16",
            {"fused_stem": 1, "fused_chain": 4})
        add(launches)
    cpu4 = Predictor(copy.deepcopy(qat), batch_size=4, dtype=None, device="cpu")
    ref4 = cpu4(images[:4])
    for b in (1, 4):
        check_f32(Predictor(copy.deepcopy(qat), batch_size=b, dtype=None), ref4,
                  images[:4], f"ResNet-18 batch {b}")

    qat34 = flagship(torch.Generator().manual_seed(SEED), depth=34)
    pred34 = Predictor(copy.deepcopy(qat34), batch_size=1)
    _, launches = serve_counted(
        kernels, pred34, (images[:1], images[1:2]),
        "ResNet-34 Predictor(batch_size=1) bf16",
        {"fused_stem": 1, "fused_chain": 3, "fused_downsample_block": 1,
         "fused_basic_block": 2})
    add(launches)
    ref34 = Predictor(copy.deepcopy(qat34), batch_size=2, dtype=None,
                      device="cpu")(images[:2])
    check_f32(Predictor(copy.deepcopy(qat34), batch_size=1, dtype=None), ref34,
              images[:2], "ResNet-34 batch 1")

    # ResNet-50: 13 stride-1 Bottlenecks on fused_bottleneck at B <= 4; the
    # three strided ones on deployed convs, whose pointwise convs with
    # K >= 256 run binary_gemm (8 at B <= 4, all 27 at B = 8) and the rest
    # binary_conv2d (4 at B <= 4, 25 at B = 8)
    qat50 = flagship(torch.Generator().manual_seed(SEED), depth=50)
    pred50 = {}
    for b, requests, want in (
            (1, (images[:1], images[1:3]), R50_SMALL),
            (4, (images[:4], images[4:7]), R50_SMALL),
            (8, (images[:8], images[8:11]), R50_8)):
        pred50[b] = Predictor(copy.deepcopy(qat50), batch_size=b)
        _, launches = serve_counted(
            kernels, pred50[b], requests, f"ResNet-50 Predictor(batch_size={b}) bf16",
            want)
        add(launches)
    ref50 = Predictor(copy.deepcopy(qat50), batch_size=2, dtype=None,
                      device="cpu")(images[:2])
    for b in (1, 4, 8):
        check_f32(Predictor(copy.deepcopy(qat50), batch_size=b, dtype=None), ref50,
                  images[:2], f"ResNet-50 batch {b}")

    # path A: the batch 1 and 4 ResNet-18 predictors after fuse_entry: the
    # stem and layer1 as one fused_stem_chain launch, bit-identical
    pred_a = {}
    for b, requests in ((1, (images[:1], images[1:3])), (4, (images[:4], images[4:7]))):
        pred_a[b] = Predictor(copy.deepcopy(qat), batch_size=b)
        if fuse_entry(pred_a[b].model) != 1:
            raise AssertionError("fuse_entry merged no entry")
        outs, launches = serve_counted(
            kernels, pred_a[b], requests,
            f"path A: ResNet-18 Predictor(batch_size={b}) + fuse_entry bf16",
            {"fused_stem_chain": 1, "fused_chain": 3})
        add(launches)
        for r, o in zip(requests, outs):
            if not torch.equal(o, small[b](r)):
                raise AssertionError(f"path A batch {b}: logits differ from the "
                                     "Predictor without fuse_entry")
        print(f"phase 3: path A batch {b}: bf16 logits equal the same Predictor "
              "without fuse_entry, bit for bit")
    for b in (1, 4):
        pa32 = Predictor(copy.deepcopy(qat), batch_size=b, dtype=None)
        fuse_entry(pa32.model)
        check_f32(pa32, ref4, images[:4], f"path A ResNet-18 + fuse_entry batch {b}")

    # path B: the Z1-PReLU ResNet-18 with its 13 stride-1 3x3 convs in mode
    # pallas-conv, at batch 8; layer4.0's shortcut (K = 256) on binary_gemm
    qz18 = flagship(torch.Generator().manual_seed(SEED), z1_prelu=True)
    served_b = Served(pallas_conv_model(qz18, torch.bfloat16), BATCH, dev,
                      torch.bfloat16)
    run = []
    calls = capture_calls(deploy, "binary_conv2d_s1", lambda: run.append(serve_counted(
        kernels, served_b, (images[:8], images[8:11]),
        "path B: Z1-PReLU ResNet-18 pallas-conv batch 8 bf16", PATH_B)))
    add(run[0][1])
    check_share("path B binary_conv2d_s1",
                [(int((a[0] >= 0).sum()), a[0].numel()) for a, _ in calls[:13]])
    b32 = Served(pallas_conv_model(qz18, None), BATCH, dev, torch.float32)
    ref_b = Served(pallas_conv_model(qz18, None), 2, torch.device("cpu"),
                   torch.float32)(images[:2])
    check_f32(b32, ref_b, images[:2], "path B Z1-PReLU ResNet-18 pallas-conv batch 8")
    conv_mode = deploy.deploy(copy.deepcopy(qz18), weight_format="int8")
    optimize_deployed(conv_mode)
    space_to_depth_stem(conv_mode)
    check_f32(b32, Served(conv_mode.eval(), BATCH, dev, torch.float32)(images[:2]).cpu(),
              images[:2], "path B against the same model in the conv mode, on the card,")

    # path C: the Z1-PReLU ResNet-50 through the popcount Predictor, which
    # serves unfused with its 36 pointwise convs on popcount_gemm
    qz50 = flagship(torch.Generator().manual_seed(SEED), depth=50, z1_prelu=True)
    pred_c = {}
    for b, requests in ((8, (images[:8], images[8:11])), (1, (images[:1], images[1:3]))):
        pred_c[b] = Predictor(copy.deepcopy(qz50), batch_size=b,
                              binary_gemm_impl="popcount")
        if len(pred_c[b].popcount_layers) != 36:
            raise AssertionError(f"path C: {len(pred_c[b].popcount_layers)} "
                                 "popcount layers, expected 36")
        run = []
        calls = capture_calls(deploy, "popcount_gemm", lambda: run.append(serve_counted(
            kernels, pred_c[b], requests,
            f"path C: Z1-PReLU ResNet-50 Predictor(batch_size={b}, "
            "binary_gemm_impl='popcount') bf16", PATH_C)))
        add(run[0][1])
        check_share(f"path C batch {b} popcount_gemm", [
            (int((kernels.unpack_bits(a[0], a[2], axis=-1) > 0).sum()),
             a[0].shape[0] * a[2]) for a, _ in calls[:36]])
    c32 = Predictor(copy.deepcopy(qz50), batch_size=BATCH, dtype=None,
                    binary_gemm_impl="popcount")
    ref_c = Predictor(copy.deepcopy(qz50), batch_size=2, dtype=None,
                      binary_gemm_impl="popcount", device="cpu")(images[:2])
    check_f32(c32, ref_c, images[:2], "path C Z1-PReLU ResNet-50 popcount batch 8")
    check_f32(c32, Predictor(copy.deepcopy(qz50), batch_size=BATCH, dtype=None,
                             fuse=False)(images[:2]).cpu(), images[:2],
              "path C against binary_gemm_impl='mxu', fuse=False, on the card,")
    print(f"phase 3: launches over every serving run above: {totals}")

    # times at the serving paths' shapes
    def time_gemm(m, k, n):
        """binary_gemm on ternary bf16 rows, its plain version and
        torch._int_mm on the same product: (times, bound, bound_by)."""
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

        hold_gemm(kernels, f"timed M={m} K={k} N={n}", (xg, wp, k, sc, ad),
                  dict(sign_inputs=False), phase=4)
        tile, loader = gemm_plan_of(kernels, xg, wp, k)
        print(f"phase 4: binary_gemm M={m} K={k} N={n}: tile {tile}x{tile}, "
              f"{-(-m // tile) * -(-n // tile)} blocks, {loader} loader")
        return ({f.__name__: (device_ms(f), cuda_ms(f)) for f in (gemm, gemm_plain, gemm_lib)},
                *bound_ms(nbytes(xg, wp, sc, ad) + m * n * 4, 2 * m * k * n, torch.int8))

    m, k, n = BATCH * 7 * 7, 256, 512  # ResNet-18 layer4.0's shortcut at B=8
    gemm_t, gemm_bound, gemm_by = time_gemm(m, k, n)
    m50 = (196, 1024, 512)  # ResNet-50 layer4.0's conv1 at B=1

    xs = torch.randn((BATCH, SIZE, SIZE, 3), generator=gen).to(dev, torch.bfloat16)
    ws = (0.1 * torch.randn((7, 7, 3, 64), generator=gen)).to(dev, torch.bfloat16)
    bs = (0.1 * torch.randn(64, generator=gen)).to(dev, torch.bfloat16)
    stem_desc = kernels.StemDesc(ws, bs)

    def time_stem(x, entry="fused_stem", out_dtype=None):
        """The stem at x's shape, storing ``out_dtype``: the kernel through a
        descriptor (the kernels line's ``ms``) and through the public entry
        point ``entry`` (both on the operator's kept weights), its plain
        version and cuDNN's conv + relu + max_pool, three calls."""
        xn, wn = x.permute(0, 3, 1, 2).contiguous(), ws.permute(3, 2, 0, 1).contiguous()
        out_size = torch.finfo(out_dtype or x.dtype).bits // 8

        def stem():
            return stem_desc(x, out_dtype)

        def stem_public():
            return getattr(kernels.stem, entry)(x, ws, bs, out_dtype=out_dtype)

        def stem_plain():
            return kernels.fused_stem_reference(x, ws, bs, out_dtype=out_dtype)

        def stem_cudnn_3_calls():
            return torch.nn.functional.max_pool2d(
                torch.relu(torch.nn.functional.conv2d(xn, wn, bs, 2, 3)), 3, 2, 1)

        nb, h, w, _ = x.shape
        print(f"phase 4: {entry} {tuple(x.shape)}: "
              f"{stem_plan_text(stem_desc.plan(x, out_dtype), h // 4)}")
        return ({f.__name__: (device_ms(f), cuda_ms(f))
                 for f in (stem, stem_public, stem_plain, stem_cudnn_3_calls)},
                *bound_ms(nbytes(x, ws, bs) + nb * (h // 4) * (w // 4) * 64 * out_size,
                          2 * nb * (h // 2) * (w // 2) * 64 * 7 * 7 * 3, torch.bfloat16))

    stem_t, stem_bound, stem_by = time_stem(xs, "fused_stem_v3")
    timed = [(f"binary_gemm M={m} K={k} N={n} bf16", gemm_t, gemm_bound, gemm_by),
             ("ResNet-50 binary_gemm M={} K={} N={} bf16".format(*m50), *time_gemm(*m50)),
             (f"fused_stem_v3 ({BATCH},{SIZE},{SIZE},3) bf16", stem_t, stem_bound,
              stem_by)]
    # batches 4 and 1 of the serving paths, and the geometries of the v2 and
    # v1 entry points, which the same kernel serves
    # (the batches on a generator of their own: the draws from gen stay)
    gen_b = torch.Generator().manual_seed(SEED + 6)
    for shape, g, entry in (((4, SIZE, SIZE, 3), gen_b, "fused_stem_v3"),
                            ((1, SIZE, SIZE, 3), gen_b, "fused_stem_v3"),
                            ((1, SIZE, SIZE - 4, 3), gen, "fused_stem_v2"),
                            ((2, 200, 196, 3), gen, "fused_stem")):
        xo = torch.randn(shape, generator=g).to(dev, torch.bfloat16)
        timed.append((f"{entry} {shape} bf16", *time_stem(xo, entry)))
    # bf16 x stored as f32 (out_dtype) at batch 8 and 1: the x drawn above
    for xo in (xs, xs[:1]):
        timed.append((f"fused_stem_v3 {tuple(xo.shape)} bf16 -> f32",
                      *time_stem(xo, "fused_stem_v3", torch.float32)))
    for name, times, bound, by in timed:
        parts = ", ".join(f"{f} {d * 1e3:.2f} us device / {c * 1e3:.2f} us per call"
                          for f, (d, c) in times.items())
        print(f"phase 4: {name}: {parts}; bound {bound * 1e3:.3f} us ({by}) | {card}")

    # the residual-block kernels at the shapes the serving paths gave them:
    # every call is held against its plain version (bf16, as served), and
    # the R18 chains and R34's block kernels are timed
    block_t = {}   # kernel -> [(label, (dev, call), (plain dev, plain call), bound, by)]

    def check_call(kname, label, fn, plain, head=False):
        err = check_exact(label, fn(), plain(), head, phase=4)
        block_errs[kname] = max(block_errs[kname], err)

    def record(kname, label, fn, plain, bound, head=False):
        check_call(kname.split("@")[0], label, fn, plain, head)
        k_t, p_t = time_kernel(fn, plain)
        block_t.setdefault(kname, []).append((label, k_t, p_t) + bound)

    def chain_calls(pred, xb):
        """(label, kernel call, plain call, bound, head) of each fused_chain
        call that ``pred`` makes on ``xb``."""
        calls = []
        for args, kw in capture_calls(stages, "fused_chain", lambda: pred(xb)):
            xh, blocks = args[0], args[1]
            wfc, bfc = (args[2], args[3]) if len(args) > 2 else (None, None)
            n, h, w, _ = xh.shape
            if blocks[0].kind == "down":
                h, w = h // 2, w // 2
            out_numel, out_size = ((n * wfc.shape[1], 4) if wfc is not None else
                                   (n * h * w * blocks[-1].co, xh.element_size()))
            label = (f"fused_chain {'+'.join(x.kind for x in blocks)}"
                     f"{'+head' if wfc is not None else ''} {tuple(xh.shape)} bf16")
            calls.append((label, lambda a=args, k=kw: kernels.fused_chain(*a, **k),
                          lambda a=args, k=kw: kernels.fused_chain_reference(*a, **k),
                          chain_bound(xh, blocks, wfc, bfc, out_numel, out_size),
                          wfc is not None))
        return calls

    for b in (1, 4):
        for label, fn, plain, bound, head in chain_calls(small[b], images[:b].to(dev)):
            record(f"fused_chain@{b}", label, fn, plain, bound, head)
    x1 = images[:1].to(dev)
    for label, fn, plain, _, head in chain_calls(pred34, x1):
        check_call("fused_chain", "ResNet-34 " + label, fn, plain, head)
    # FusedBottleneck calls the fused_bottleneck operator: capture its calls
    def bottleneck_calls(xb):
        """(x, BottleneckDesc of the call's weights and rows, its options) of
        each fused_bottleneck call of ``pred50[1 or 4]`` on ``xb``."""
        calls = []
        for args, kw in capture_calls(megablock, "fused_bottleneck",
                                      lambda: pred50[xb.shape[0]](xb)):
            xh, w1, w2, w3 = args
            rows = {r: kw[r] for r in kernels.bottleneck.ROWS if r in kw}
            desc = kernels.BottleneckDesc(xh.shape[-1], w1, w2, w3, kw.get("wd"), rows)
            calls.append((xh, desc, (kw["act"], kw["zero_to_one"], kw["out_dtype"])))
        return calls

    for b in (1, 4):
        for xh, desc, opts in bottleneck_calls(images[:b].to(dev)):
            if b == 4:
                plan = desc.plan(xh)
                print(f"phase 4: ResNet-50 B=4 fused_bottleneck {tuple(xh.shape)} "
                      f"-> {desc.cout} plan on {plan.pop('blocks')} resident "
                      "blocks, (tiles, K slices) per GEMM: " + ", ".join(
                          f"{k} {v}" for k, v in plan.items() if v is not None))
            record(f"fused_bottleneck@{b}",
                   f"ResNet-50 fused_bottleneck {tuple(xh.shape)} -> {desc.cout} bf16",
                   lambda d=desc, x=xh, o=opts: d(x, *o),
                   lambda d=desc, x=xh, o=opts: d.reference(x, *o),
                   bottleneck_bound(xh, desc))
    # host time of R50's 13 B=1 calls through the operator, its kernel
    # arguments kept
    calls50 = bottleneck_calls(x1)
    kept_us = sum(1e3 * host_ms(lambda d=desc, x=xh, o=opts: d(x, *o))
                  for xh, desc, opts in calls50)
    print(f"phase 4: ResNet-50 B=1 fused_bottleneck host time per call, summed "
          f"over its {len(calls50)} calls: {kept_us:.2f} us | {card}")
    # every binary_gemm call of the ResNet-50 paths (the strided blocks'
    # pointwise convs; all of them at B=8) on its own inputs
    gemm_calls = {}
    for b in (1, 4, 8):
        xb = images[:b].to(dev)
        calls = capture_calls(deploy, "binary_gemm", lambda: pred50[b](xb))
        errs = [hold_gemm(kernels, f"ResNet-50 B={b} call {i}", a, k, phase=4)
                for i, (a, k) in enumerate(calls)]
        gemm_err = max([gemm_err] + errs)
        gemm_calls[f"ResNet-50 batch {b}"] = calls
        shapes = sorted({(a[0].shape[0], a[2], a[1].shape[1]) for a, _ in calls})
        print(f"phase 4: ResNet-50 Predictor(batch_size={b}): {len(calls)} "
              f"binary_gemm calls held against the plain version: bit-identical "
              f"(max |err| {max(errs):.3g}); (M, K, N) {shapes}")
    gemm_calls[f"ResNet-18 batch {BATCH}"] = capture_calls(
        deploy, "binary_gemm", lambda: pred(images[:BATCH].to(dev)))
    # binary_gemm per distinct (M, K, N) of those calls, on the call's own
    # inputs: the kernel with the host's tile (its own device time), the
    # other tile and torch._int_mm on the same int8 product (the plain
    # version is timed at the two shapes above)
    for path in ("ResNet-50 batch 1", "ResNet-50 batch 8", f"ResNet-18 batch {BATCH}"):
        rows = {}
        for a, kw in gemm_calls[path]:
            x, wp, kk = a[:3]
            m, n = x.shape[0], wp.shape[1]
            if (m, kk, n) in rows:
                rows[(m, kk, n)][1] += 1
                continue
            tile, loader = gemm_plan_of(kernels, x, wp, kk)
            x8 = (torch.where(x >= 0, 1, -1) if kw.get("sign_inputs", True) else x).to(torch.int8)
            w8 = kernels.unpack_bits(wp, kk, axis=-2, dtype=torch.int8)[:kk].t().contiguous()
            fn = lambda a=a, kw=kw: kernels.binary_gemm(*a, **kw)
            t = {}
            if m > 16 and kk % 8 == 0 and n % 8 == 0:  # what torch._int_mm takes
                t = timed_row({"library": lambda x8=x8, w8=w8: torch._int_mm(x8, w8.t())})
            # the kernel alone: the wrapper casts bf16 epilogue rows to f32
            own, casts = own_ms(fn, "binary_gemm_kernel")
            t["kernel"] = (own, cuda_ms(fn))
            alt = [tl for tl in kernels.gemm.GEMM_TILES if tl != tile][0]
            alt_ms = own_ms(lambda a=a, kw=kw, p=(alt, loader): kernels.gemm.binary_gemm_planned(
                *a, plan=p, **kw), "binary_gemm_kernel")[0]
            params = [v for v in a[3:] if isinstance(v, torch.Tensor)]
            rows[(m, kk, n)] = [
                f"binary_gemm M={m} K={kk} N={n} {str(x.dtype)[6:]} ({path}; tile "
                f"{tile}x{tile}, {-(-m // tile) * -(-n // tile)} blocks, {loader} loader; "
                f"{alt}x{alt} {alt_ms * 1e3:.2f} us; the wrapper's epilogue casts "
                f"{casts * 1e3:.2f} us)",
                1, t,
                bound_ms(nbytes(x, wp, *params) + m * n * 4, 2 * m * kk * n, torch.int8)]
        print_rows(f"binary_gemm ({path}, {len(gemm_calls[path])} calls)",
                   list(rows.values()), card, "torch._int_mm")
    for kname in ("fused_downsample_block", "fused_basic_block"):
        for args, kw in capture_calls(megablock, kname, lambda: pred34(x1)):
            xh = args[0]
            fn = getattr(kernels, kname)
            plain = getattr(kernels, kname + "_reference")
            if kname == "fused_basic_block":
                plan = kernels.block.fused_basic_block_plan(xh)
            else:
                plan = kernels.strided_block.fused_downsample_block_plan(
                    xh, args[2].shape[-1])
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            print(f"phase 4: ResNet-34 {kname} {tuple(xh.shape)}, kept arguments: "
                  f"a grid of {plan['blocks']} blocks ({plan['blocks'] / sms:g} an "
                  f"SM, {plan['resident_per_sm']} resident), each conv "
                  f"{plan['tiles']} tiles, K slices {plan['k_slices']}")
            record(kname, f"{kname} {tuple(xh.shape)} bf16",
                   lambda a=args, k=kw: fn(*a, **k),
                   lambda a=args, k=kw: plain(*a, **k),
                   block_bound(kname, args, kw, bound_ms))
    for kname, rows in block_t.items():
        for label, (d, c), (pd, pc), bound, by in rows:
            print(f"phase 4: {label}: kernel {d * 1e3:.2f} us device / "
                  f"{c * 1e3:.2f} us per call; plain {pd * 1e3:.1f} us device / "
                  f"{pc * 1e3:.1f} us per call; bound {bound * 1e3:.3f} us "
                  f"({by}); library: none (no single call) | {card}")

    # the opt-in paths' kernels, every call held against its plain version
    # on its own inputs, timed once per shape
    entry_rows = []
    for b in (1, 4):
        xb = images[:b].to(dev)
        (args, kw), = capture_calls(stages, "fused_stem_chain", lambda: pred_a[b](xb))
        xh, w, bias, blocks = args
        # the split pair as the unmerged predictor runs it: the stem, then
        # fused_chain
        fn = lambda a=args, k=kw: kernels.fused_stem_chain(*a, **k)
        plain = lambda a=args, k=kw: kernels.fused_stem_chain_reference(*a, **k)
        split = lambda a=args, k=kw: kernels.fused_chain(
            kernels.fused_stem(a[0], a[1], a[2]), a[3], **k)
        plan = kernels.model.fused_stem_chain_plan(xh, kernels.StemDesc(w, bias))
        print(f"phase 4: path A batch {b} fused_stem_chain's stem phase: items of "
              f"{plan['rows']} pooled row(s) x 7 columns, {plan['items']} items on a "
              f"cooperative grid of {plan['blocks']} blocks ({plan['blocks_per_sm']} an SM)")
        got, ref, two = fn(), plain(), split()
        torch.cuda.synchronize()
        if not torch.equal(got, two):
            raise AssertionError(f"path A batch {b}: fused_stem_chain differs from "
                                 "fused_chain(fused_stem(x))")
        e = (got.float() - ref.float()).abs()
        entry_err = max(entry_err, e.max().item())
        print(f"phase 4: path A batch {b} fused_stem_chain {tuple(xh.shape)}: "
              f"bit-identical to the split pair; against its plain version max "
              f"|err| {e.max().item():.3g}, {int((e > 0).sum())} of {e.numel()} "
              "values differ")
        t = timed_row({"kernel": fn, "plain": plain, "split": split})
        entry_rows.append((f"fused_stem_chain {tuple(xh.shape)} bf16 (path A, batch {b})",
                           1, t, stem_chain_bound(xh, w, bias, blocks, got.numel(),
                                                  got.element_size())))
        print(f"phase 4: path A batch {b}: the split pair (fused_stem, then "
              f"fused_chain) on the same inputs {t['split'][0] * 1e3:.2f} us device "
              f"/ {t['split'][1] * 1e3:.2f} us per call | {card}")
    entry_t = [print_rows("fused_stem_chain", [r], card, None) for r in entry_rows]

    conv_rows, errs = {}, []
    conv_calls = capture_calls(deploy, "binary_conv2d_s1",
                               lambda: served_b(images[:BATCH]))
    for a, k in conv_calls:
        x, w = a[0], a[1]
        n, h, wd, c = x.shape
        kk, o = w.shape[0], w.shape[-1]
        label = f"binary_conv2d_s1 {tuple(x.shape)} {str(x.dtype)[6:]} -> {o} k={kk}"
        errs.append(check_exact(
            "path B " + label, kernels.binary_conv2d_s1(*a, **k),
            kernels.binary_conv2d_s1_reference(*a, **k), False, phase=4,
            verbose=False))
        key = (tuple(x.shape), x.dtype, o)
        if key in conv_rows:
            conv_rows[key][1] += 1
            continue
        xs = torch.where(x >= 0, 1.0, -1.0).to(torch.bfloat16).permute(0, 3, 1, 2).contiguous()
        wl = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous()
        fn = lambda a=a, k=k: kernels.binary_conv2d_s1(*a, **k)
        t = timed_row({
            "plain": lambda a=a, k=k: kernels.binary_conv2d_s1_reference(*a, **k),
            "library": lambda xs=xs, wl=wl, kk=kk: torch.nn.functional.conv2d(
                xs, wl, padding=kk // 2)})
        # the kernel alone; the wrapper also copies the weights into the
        # kernel's operand and casts bf16 epilogue rows to f32
        own, rest = own_ms(fn, "binary_conv2d_s1_kernel")
        t["kernel"] = (own, cuda_ms(fn))
        plan = kernels.conv.conv_plan(
            n, h, wd, c, kk, o, x.element_size(), x.data_ptr(),
            torch.cuda.get_device_properties(dev).multi_processor_count)
        # the other tiles and splits of the same loader, each held first
        want, alts = fn(), []
        for alt in conv_instances(kernels.conv, x, kk):
            if alt[1] != plan[1] or alt == plan:
                continue
            run_alt = lambda a=a, k=k, alt=alt: kernels.conv.binary_conv2d_s1_planned(
                *a, plan=alt, **k)
            errs.append(check_exact(f"path B {label} {alt}", run_alt(), want, False,
                                    phase=4, verbose=False))
            alts.append(f"{alt[0]}x{alt[0]} split {alt[2]} "
                        f"{own_ms(run_alt, 'binary_conv2d_s1_kernel')[0] * 1e3:.2f} us")
        blocks = -(-n * h * wd // plan[0]) * -(-o // plan[0])
        params = [v for v in a[2:] if isinstance(v, torch.Tensor)]
        conv_rows[key] = [
            f"{label} (host plan: {plan[0]}x{plan[0]}, {blocks} blocks, {plan[1]} "
            f"loader, split {plan[2]}; {'; '.join(alts)}; the wrapper's weight copy "
            f"and casts {rest * 1e3:.2f} us)",
            1, t, bound_ms(nbytes(x, w, *params) + n * h * wd * o * 4,
                           2 * n * h * wd * o * c * kk * kk, torch.int8)]
    conv_err = max([conv_err] + errs)
    print(f"phase 4: path B batch {BATCH}: {len(conv_calls)} binary_conv2d_s1 calls "
          f"held against the plain version on their own inputs: bit-identical "
          f"(max |err| {max(errs):.3g})")
    conv_t = print_rows("binary_conv2d_s1 (path B, batch 8)",
                        list(conv_rows.values()), card, "F.conv2d bf16")

    def popcount_table(b):
        """Every popcount_gemm call of a path-C forward at batch ``b`` held
        against its plain version on its own inputs, then timed per
        distinct shape: the kernel alone beside the other tiles and splits
        of its loader, the whole call (the wrapper casts bf16 epilogue rows
        to f32), the plain version and torch._int_mm on the +/-1 product."""
        rows, errs = {}, []
        calls = capture_calls(deploy, "popcount_gemm",
                              lambda: pred_c[b](images[:b]))
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for a, k in calls:
            xp, wp, kk = a[0], a[1], a[2]
            m, n = xp.shape[0], wp.shape[1]
            label = f"popcount_gemm M={m} K={kk} N={n}"
            fn = lambda a=a, k=k: kernels.popcount_gemm(*a, **k)
            errs.append(check_exact(f"path C batch {b} {label}", fn(),
                                    kernels.popcount_gemm_reference(*a, **k), False,
                                    phase=4, verbose=False))
            key = (m, kk, n)
            if key in rows:
                rows[key][1] += 1
                continue
            a8 = kernels.unpack_bits(xp, kk, axis=-1, dtype=torch.int8)[:, :kk].contiguous()
            w8 = kernels.unpack_bits(wp, kk, axis=-2, dtype=torch.int8)[:kk].t().contiguous()
            t = timed_row({
                "plain": lambda a=a, k=k: kernels.popcount_gemm_reference(*a, **k),
                "library": lambda a8=a8, w8=w8: torch._int_mm(a8, w8.t())})
            own, rest = own_ms(fn, "popcount_gemm_kernel")
            t["kernel"] = (own, cuda_ms(fn))
            plan = kernels.gemm.popcount_plan(m, xp.shape[1], n, xp.data_ptr(),
                                              wp.data_ptr(), sms)
            want, alts = fn(), []
            for alt in popcount_instances(kernels.gemm, xp, wp):
                if alt[1] != plan[1] or alt == plan:
                    continue
                run_alt = lambda a=a, k=k, alt=alt: kernels.gemm.popcount_gemm_planned(
                    *a, plan=alt, **k)
                errs.append(check_exact(f"path C batch {b} {label} {alt}", run_alt(),
                                        want, False, phase=4, verbose=False))
                alts.append(f"{alt[0]}x{alt[0]} split {alt[2]} "
                            f"{own_ms(run_alt, 'popcount_gemm_kernel')[0] * 1e3:.2f} us")
            blocks = -(-m // plan[0]) * -(-n // plan[0])
            params = [v for v in a[3:] if isinstance(v, torch.Tensor)]
            rows[key] = [
                f"{label} (host plan: {plan[0]}x{plan[0]}, {blocks} blocks, "
                f"{plan[1]} loader, split {plan[2]}; {'; '.join(alts)}; the "
                f"wrapper's casts {rest * 1e3:.2f} us)",
                1, t, bound_ms(nbytes(xp, wp, *params) + m * n * 4, 2 * m * kk * n,
                               torch.int8)]
        print(f"phase 4: path C batch {b}: {len(calls)} popcount_gemm calls held "
              f"against the plain version on their own inputs: bit-identical "
              f"(max |err| {max(errs):.3g})")
        return max(errs), print_rows(f"popcount_gemm (path C, batch {b})",
                                     list(rows.values()), card, "torch._int_mm")

    err8, pop_t = popcount_table(BATCH)
    err1, _ = popcount_table(1)
    pop_err = max(pop_err, err8, err1)

    # every binary_conv2d call of the serving paths (their deployed convs in
    # mode conv) on its own inputs, through the host plan and every
    # instance; then per distinct shape of ResNet-18's and ResNet-50's
    # batch-8 calls, the kernel alone beside its plain version (the unfold
    # + torch._int_mm chain) and its bound
    conv2d_runs = {f"ResNet-18 batch {BATCH}": lambda: pred(images[:BATCH].to(dev)),
                   **{f"ResNet-50 batch {b}": lambda b=b: pred50[b](images[:b].to(dev))
                      for b in (1, 4, BATCH)},
                   f"path B batch {BATCH}": lambda: served_b(images[:BATCH]),
                   **{f"path C batch {b}": lambda b=b: pred_c[b](images[:b])
                      for b in (BATCH, 1)}}
    conv2d_calls = {}
    for path, run in conv2d_runs.items():
        calls = capture_calls(deploy, "binary_conv2d", run)
        held = sum(hold_conv2d(kernels, f"{path} call {i} {tuple(a[0].shape)}", a, k, 4)
                   for i, (a, k) in enumerate(calls))
        conv2d_calls[path] = calls
        print(f"phase 4: {path}: {len(calls)} binary_conv2d calls held against the plain "
              f"version on their own inputs, through the host plan and {held} instance "
              "runs: bit-identical")
    conv2d_t = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for path in (f"ResNet-18 batch {BATCH}", f"ResNet-50 batch {BATCH}"):
        rows = {}
        for a, k in conv2d_calls[path]:
            x, w = a[0], a[1]
            out = kernels.binary_conv2d(*a, **k)
            key = (tuple(x.shape), tuple(w.shape), tuple(k["stride"]))
            if key in rows:
                rows[key][1] += 1
                continue
            n, h, wd, c = x.shape
            o, _, kh, kw = w.shape
            m = out.shape[0] * out.shape[1] * out.shape[2]
            tile, loader = kernels.conv.conv2d_plan(m, o, c, kh * kw, x.element_size(),
                                                    x.data_ptr(), sms)
            fn = lambda a=a, k=k: kernels.binary_conv2d(*a, **k)
            t = timed_row({"plain": lambda a=a, k=k: kernels.conv.binary_conv2d_cpu(
                a[0], a[1], k["threshold"], a[2], a[3], k["stride"], k["padding"],
                k["zero_to_one"])})
            own, rest = own_ms(fn, "binary_conv2d_kernel")
            t["kernel"] = (own, cuda_ms(fn))
            params = [v for v in (w, a[2], a[3], k["threshold"]) if v is not None]
            rows[key] = [
                f"binary_conv2d {tuple(x.shape)} {str(x.dtype)[6:]} -> {o} k={kh} stride "
                f"{k['stride'][0]} (host plan: {tile[0]}x{tile[1]}, "
                f"{-(-m // tile[0]) * -(-o // tile[1])} blocks, {loader} loader; the "
                f"wrapper's other kernels {rest * 1e3:.2f} us)",
                1, t, bound_ms(nbytes(x, *params, out), 2 * m * o * c * kh * kw,
                               torch.int8)]
        conv2d_t[path] = print_rows(f"binary_conv2d ({path}, {len(conv2d_calls[path])} "
                                    "calls)", list(rows.values()), card, None)

    def summed(kname):
        rows = block_t[kname]
        by = "bytes" if sum(r[3] for r in rows if r[4] == "bytes") >= \
            sum(r[3] for r in rows if r[4] == "operations") else "operations"
        return (sum(r[1][0] for r in rows), sum(r[2][0] for r in rows),
                sum(r[3] for r in rows), by)

    forward_times(pred, images[:BATCH].to(dev), card,
                  f"ResNet-18 Predictor(batch_size={BATCH}) bf16 {SIZE}x{SIZE}")
    for b in (1, 4):
        forward_times(small[b], images[:b].to(dev), card,
                      f"ResNet-18 Predictor(batch_size={b}) bf16 {SIZE}x{SIZE}")
    unfused = Predictor(copy.deepcopy(qat), batch_size=1, fuse=False)
    forward_times(unfused, images[:1].to(dev), card,
                  "context: ResNet-18 Predictor(batch_size=1, fuse=False) bf16, "
                  "the deployed convs without stage or block kernels")
    forward_times(pred34, x1, card, f"ResNet-34 Predictor(batch_size=1) bf16 {SIZE}x{SIZE}")
    for b in (1, 4, 8):
        forward_times(pred50[b], images[:b].to(dev), card,
                      f"ResNet-50 Predictor(batch_size={b}) bf16 {SIZE}x{SIZE}")
    for b in (1, 4):
        forward_times(pred_a[b], images[:b].to(dev), card,
                      f"path A: ResNet-18 Predictor(batch_size={b}) + fuse_entry bf16")
    # the entry split (FusedStem, then FusedStage) and merged (FusedEntry):
    # host time per call issued back to back, then the forward, in turns
    # split, merged, merged, split
    xe = x1.to(torch.bfloat16)
    split_m, merged_m = small[1].model, pred_a[1].model
    with torch.no_grad():
        host = {"split": [], "merged": []}
        for order in (("split", "merged"), ("merged", "split")) * 2:
            for name in order:
                host[name].append(1e3 * host_ms(
                    (lambda: split_m.layer1(split_m.conv1(xe))) if name == "split"
                    else (lambda: merged_m.conv1(xe))))
    ab_entry = {"split": [], "merged": []}
    for order in (("split", "merged"), ("merged", "split")) * 2:
        for name in order:
            ab_entry[name].append(fwd_ms(small[1] if name == "split" else pred_a[1], x1))
    print(f"phase 4: ResNet-18 batch 1 entry host time per call, in turns: split "
          f"(FusedStem, FusedStage) {[round(v, 2) for v in host['split']]} us, "
          f"FusedEntry {[round(v, 2) for v in host['merged']]} us | {card}")
    print(f"phase 4: ResNet-18 Predictor(batch_size=1) bf16 forward, in turns: "
          f"split {[round(v, 3) for v in ab_entry['split']]} ms, fuse_entry "
          f"{[round(v, 3) for v in ab_entry['merged']]} ms | {card}")
    forward_times(served_b, images[:BATCH].to(dev), card,
                  f"path B: Z1-PReLU ResNet-18 pallas-conv batch {BATCH} bf16")
    for b in (BATCH, 1):
        forward_times(pred_c[b], images[:b].to(dev), card,
                      f"path C: Z1-PReLU ResNet-50 Predictor(batch_size={b}, "
                      "binary_gemm_impl='popcount') bf16")

    chain = summed("fused_chain@1")
    chain4 = summed("fused_chain@4")
    print(f"phase 4: fused_chain, ResNet-18's four stages: batch 1 {chain[0] * 1e3:.2f} "
          f"us device (bound {chain[2] * 1e3:.3f} us, {chain[3]}); batch 4 "
          f"{chain4[0] * 1e3:.2f} us device (bound {chain4[2] * 1e3:.3f} us, "
          f"{chain4[3]}) | {card}")
    basic = summed("fused_basic_block")
    down = summed("fused_downsample_block")
    bneck = summed("fused_bottleneck@1")
    bneck4 = summed("fused_bottleneck@4")
    print(f"phase 4: fused_bottleneck, ResNet-50's 13 calls: batch 1 {bneck[0] * 1e3:.2f} "
          f"us device (bound {bneck[2] * 1e3:.3f} us, {bneck[3]}); batch 4 "
          f"{bneck4[0] * 1e3:.2f} us device (bound {bneck4[2] * 1e3:.3f} us, "
          f"{bneck4[3]}) | {card}")

    # phase 5: QAT training of the flagship on the card, then its weights
    # served; the serving runs' launches join phase 3's
    launches, trained, opt = train_phase(kernels, Predictor, dev, card)
    add(launches)
    # phase 6: serving as examples/serve.py runs it, from a checkpoint of
    # phase 5's trained weights; its counted launches join the others
    add(serve_phase(kernels, Predictor, dev, card, trained, opt, images))
    del trained, opt
    # phase 7: every serving path frozen into a bundle and loaded in a fresh
    # process; its launches are counted there, not in the kernels line's
    r18 = {"fused_stem": 1, "fused_chain": 4}
    r18_8 = R18_8
    bundle_phase(kernels, {
        "r18_b1": (small[1], r18),
        "r18_b8": (pred, r18_8),
        "r34_b1": (pred34, {"fused_stem": 1, "fused_chain": 3,
                            "fused_downsample_block": 1, "fused_basic_block": 2}),
        "r50_b1": (pred50[1], R50_SMALL),
        "entry_b1": (pred_a[1], {"fused_stem_chain": 1, "fused_chain": 3}),
        "pallas_conv_b8": (served_b, PATH_B),
        "popcount_b8": (pred_c[BATCH], PATH_C),
        "int8_head_b1": (Predictor(copy.deepcopy(qat), batch_size=1,
                                   quantize_float_bits=8), r18),
        "int8_head_b8": (Predictor(copy.deepcopy(qat), batch_size=BATCH,
                                   quantize_float_bits=8), r18_8),
    }, images, dev, card)
    # phase 8: the recipes, paths D and E, HBlock and attention
    zoo_errs = {"fused_chain": block_errs["fused_chain"],
                "fused_basic_block": block_errs["fused_basic_block"],
                "binary_gemm": gemm_err}
    zoo_phase(kernels, Predictor, dev, card, zoo_errs, totals)
    block_errs["fused_chain"] = zoo_errs["fused_chain"]
    block_errs["fused_basic_block"] = zoo_errs["fused_basic_block"]
    gemm_err = zoo_errs["binary_gemm"]
    # phase 9: the host pipeline and the training utilities; its trainers
    # launch none of the kernels, (c) times binary_gemm outside the counts
    trainer_phase(kernels, dev, card)
    # phase 10: the parallel paths, in processes of their own; their
    # launches (the mesh predictors', per rank) join the totals
    add(parallel_phase(card))
    # phase 11: the serve CLI and the ImageNet trainer over torch.distributed;
    # the launches of the loaded mesh bundles (each rank's) join the totals
    add(cli_phase(card))
    # phase 12: the plain serving paths beside the kernels; the default
    # predictors' launches join the totals
    add(plain_phase(kernels, Predictor, dev, card))
    print("phase 13: fused_chain's numbers are the sums over the four stages of "
          "one ResNet-18 forward at batch 1; fused_basic_block's over ResNet-34 "
          "layer4's two; fused_bottleneck's over the 13 calls of one ResNet-50 "
          "forward at batch 1; fused_stem_chain's are path A's at batch 1; "
          "binary_conv2d_s1's and popcount_gemm's the sums over the 13 and 36 "
          "calls of one batch-8 forward of paths B and C; binary_conv2d's the sums "
          "over the 25 calls of one ResNet-50 forward at batch 8 (it replaces no "
          "TPU kernel: the JAX package leaves that conv to XLA's int8 lax.conv); "
          "launches are totals "
          "over phase 3's serving runs, phase 5's serving of the trained "
          "weights, phase 6's counted serving runs and streams, phase 8's "
          "serving runs (paths D and E), phase 10's mesh predictors, phase "
          "11's loaded mesh bundles (each rank's) and phase 12's default "
          "predictors; max_abs_err is the largest over every "
          "check, phase 8's included")
    r50_8 = f"ResNet-50 batch {BATCH}"
    print(json.dumps({"kernels": [
        {"name": "binary_gemm", "route": "cuda",
         "source": "bnn_tpu_torch/csrc/binary_gemm.cu",
         "replaces": "bnn_tpu/kernels/gemm.py:96",
         "launches": totals["binary_gemm"], "max_abs_err": gemm_err,
         "ms": gemm_t["gemm"][0], "plain_ms": gemm_t["gemm_plain"][0],
         "bound_ms": gemm_bound, "bound_by": gemm_by,
         "library_ms": gemm_t["gemm_lib"][0]},
        {"name": "fused_stem", "route": "cuda",
         "source": "bnn_tpu_torch/csrc/fused_stem.cu",
         "replaces": "bnn_tpu/kernels/stem.py:510",
         "launches": totals["fused_stem"], "max_abs_err": stem_err,
         "ms": stem_t["stem"][0], "plain_ms": stem_t["stem_plain"][0],
         "bound_ms": stem_bound, "bound_by": stem_by, "library_ms": None},
        {"name": "fused_chain", "route": "cuda",
         "source": "bnn_tpu_torch/csrc/fused_chain.cu",
         "replaces": "bnn_tpu/kernels/model.py:265",
         "launches": totals["fused_chain"], "max_abs_err": block_errs["fused_chain"],
         "ms": chain[0], "plain_ms": chain[1], "bound_ms": chain[2],
         "bound_by": chain[3], "library_ms": None},
        {"name": "fused_basic_block", "route": "cuda",
         "source": "bnn_tpu_torch/csrc/fused_basic_block.cu",
         "replaces": "bnn_tpu/kernels/block.py:173",
         "launches": totals["fused_basic_block"],
         "max_abs_err": block_errs["fused_basic_block"],
         "ms": basic[0], "plain_ms": basic[1], "bound_ms": basic[2],
         "bound_by": basic[3], "library_ms": None},
        {"name": "fused_downsample_block", "route": "cuda",
         "source": "bnn_tpu_torch/csrc/fused_downsample_block.cu",
         "replaces": "bnn_tpu/kernels/strided_block.py:168",
         "launches": totals["fused_downsample_block"],
         "max_abs_err": block_errs["fused_downsample_block"],
         "ms": down[0], "plain_ms": down[1], "bound_ms": down[2],
         "bound_by": down[3], "library_ms": None},
        {"name": "fused_bottleneck", "route": "cuda",
         "source": "bnn_tpu_torch/csrc/fused_bottleneck.cu",
         "replaces": "bnn_tpu/kernels/bottleneck.py:127",
         "launches": totals["fused_bottleneck"],
         "max_abs_err": block_errs["fused_bottleneck"],
         "ms": bneck[0], "plain_ms": bneck[1], "bound_ms": bneck[2],
         "bound_by": bneck[3], "library_ms": None},
        {"name": "fused_stem_chain", "route": "cuda",
         "source": "bnn_tpu_torch/csrc/fused_stem_chain.cu",
         "replaces": "bnn_tpu/kernels/model.py:360",
         "launches": totals["fused_stem_chain"], "max_abs_err": entry_err,
         "ms": entry_t[0]["ms"], "plain_ms": entry_t[0]["plain"],
         "bound_ms": entry_t[0]["bound"], "bound_by": entry_t[0]["by"],
         "library_ms": None},
        {"name": "binary_conv2d_s1", "route": "cuda",
         "source": "bnn_tpu_torch/csrc/binary_conv2d_s1.cu",
         "replaces": "bnn_tpu/kernels/conv.py:68",
         "launches": totals["binary_conv2d_s1"], "max_abs_err": conv_err,
         "ms": conv_t["ms"], "plain_ms": conv_t["plain"], "bound_ms": conv_t["bound"],
         "bound_by": conv_t["by"], "library_ms": conv_t["library"]},
        {"name": "popcount_gemm", "route": "cuda",
         "source": "bnn_tpu_torch/csrc/popcount_gemm.cu",
         "replaces": "bnn_tpu/kernels/gemm.py:223",
         "launches": totals["popcount_gemm"], "max_abs_err": pop_err,
         "ms": pop_t["ms"], "plain_ms": pop_t["plain"], "bound_ms": pop_t["bound"],
         "bound_by": pop_t["by"], "library_ms": pop_t["library"]},
        {"name": "binary_conv2d", "route": "cuda",
         "source": "bnn_tpu_torch/csrc/binary_conv2d.cu",
         "replaces": None,
         "launches": totals["binary_conv2d"], "max_abs_err": conv2d_err,
         "ms": conv2d_t[r50_8]["ms"], "plain_ms": conv2d_t[r50_8]["plain"],
         "bound_ms": conv2d_t[r50_8]["bound"], "bound_by": conv2d_t[r50_8]["by"],
         "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
