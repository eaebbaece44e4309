"""Fused binary convolution, stride 1 (counterpart of
``bnn_tpu/kernels/conv.py``).

:func:`binary_conv2d_s1` computes ``conv(x >= 0 ? +1 : -1, w) * scale + add``
over an odd square kernel with "same" zero padding, in NHWC, as an
operator: the hand-written Hopper kernel
``bnn_tpu_torch/csrc/binary_conv2d_s1.cu`` for CUDA tensors, its plain
version :func:`binary_conv2d_s1_reference` only for CPU tensors. The sign is taken inside with sign(0) = +1, whatever the
layer's ``zero_to_one`` (as the TPU kernel does); the padding is added after
the sign, so padded taps contribute exactly 0. The output is always f32.

Bound on an H100 at (8, 56, 56, 64) with 64 output channels: 3.2 MB of bf16
x in and 6.4 MB of f32 out, 2.9 us at 3.35 TB/s, against 1.85 G int8
operations (0.9 us), so bytes bound it. The kernel is an implicit GEMM on the
int8 tensor cores (``mma.sync`` s8 tiles over a ``cp.async`` ring, K in
chunks of one kernel row and 64 channels, each a band of raw x pixels that
the row's taps read shifted);
:func:`conv_plan` is its host plan: the output tile (64 or 32 a side, the
larger whose grid fills half a wave of the card's SMs), the loader (16-byte
copies of x where C and the pointer allow them, else element by element) and
the K split (2 or 4 warp groups of a block sharing out the chunks of K,
where K is long and the split's shared memory still lets the grid fit on the
card at once). :func:`conv_weight_operand` lays the weights out as the
kernel reads them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ._build import load
from .gemm import H100_SMS, _epilogue_operand, _sm_count

__all__ = ["supports", "binary_conv2d_s1", "binary_conv2d_s1_planned",
           "binary_conv2d_s1_reference", "conv_plan", "conv_weight_operand"]

_X_DTYPES = (torch.float32, torch.bfloat16)
# binary_conv2d_s1.cu's instances: output tile sides (largest first) and
# warp groups sharing K (most first); its channels per chunk of K and ring
# stages; the fewest chunks a warp group of a split is left to walk
CONV_TILES = (64, 32)
CONV_SPLITS = (4, 2, 1)
CONV_KC = 64
CONV_STAGES = 2
MIN_CHUNKS = 3
SMEM_PER_BLOCK = 232448  # H100: dynamic shared memory one block can use
SMEM_PER_SM = 233472     # ... one SM holds, 1 KB of it kept per resident block


def supports(kernel_size, stride, padding, dilation, groups) -> bool:
    """Whether the kernel computes a conv of this geometry: stride 1, an odd
    square kernel, dilation 1, groups 1 and the symmetric "same" padding."""
    if len(tuple(kernel_size)) != 2 or isinstance(padding, str):
        return False
    kh, kw = kernel_size
    return (kh == kw and kh % 2 == 1
            and tuple(stride) == (1, 1)
            and tuple(dilation) == (1, 1)
            and groups == 1
            and tuple(padding) == (kh // 2, kh // 2))


def _check(x: torch.Tensor, w: torch.Tensor, scale, add) -> None:
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"expected NHWC x and (k, k, C, O) w, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    kh, kw, c, o = w.shape
    if kh != kw or kh % 2 == 0 or c != x.shape[-1]:
        raise ValueError(f"binary_conv2d_s1 needs an odd square (k, k, "
                         f"{x.shape[-1]}, O) kernel, got {tuple(w.shape)}")
    for v in (scale, add):
        if v is not None and tuple(v.shape) != (o,):
            raise ValueError(f"epilogue operands must have shape ({o},), got "
                             f"{tuple(v.shape)}")


def conv_smem_bytes(tile: int, split: int, x_itemsize: int, k: int) -> int:
    """Dynamic shared memory of a block of the instance: per warp group a
    ring of x bands (``tile + k - 1`` pixels of 64 raw channels) and weight
    rows (``k`` taps of 64 bytes per output channel), each padded against
    bank conflicts: ``group_bytes`` of ``binary_conv2d_s1.cu``, times the
    split."""
    x_row = (CONV_KC + (32 if x_itemsize == 2 else 4)) * x_itemsize
    w_row = k * CONV_KC + 32
    return CONV_STAGES * split * ((tile + k - 1) * x_row + tile * w_row)


def conv_plan(n: int, h: int, w: int, c: int, k: int, o: int, x_itemsize: int,
              x_ptr: int, sms: int = H100_SMS) -> Tuple[int, str, int]:
    """``(tile, loader, split)`` of a :func:`binary_conv2d_s1` launch on
    ``(n, h, w, c)`` x and ``(k, k, c, o)`` weights.

    ``tile``: the largest of :data:`CONV_TILES` whose grid of ``tile x tile``
    output blocks (``n*h*w`` pixels by ``o`` channels) has at least half a
    wave (``sms / 2`` blocks) and fits shared memory, else the smallest: the
    rule ``gemm_plan`` measured for ``binary_gemm``. ``loader``:
    ``"vector"`` (16-byte copies) when every pixel's channels start on 16
    bytes (``c * x_itemsize`` a multiple of 16, x aligned), else
    ``"scalar"``. ``split``: the most warp groups of :data:`CONV_SPLITS`
    that leave each at least :data:`MIN_CHUNKS` chunks of K (``k *
    ceil(c/64)`` chunks in all, one kernel row of 64 channels each) and
    whose shared memory still lets the whole grid be resident at once; else
    1.
    """
    m = n * h * w

    def blocks(t):
        return -(-m // t) * -(-o // t)

    tile = next((t for t in CONV_TILES if 2 * blocks(t) >= sms
                 and conv_smem_bytes(t, 1, x_itemsize, k) <= SMEM_PER_BLOCK),
                CONV_TILES[-1])
    chunks = k * -(-c // CONV_KC)

    def fits(split):
        smem = conv_smem_bytes(tile, split, x_itemsize, k)
        resident = SMEM_PER_SM // (smem + 1024)
        return smem <= SMEM_PER_BLOCK and blocks(tile) <= resident * sms

    split = next(s for s in CONV_SPLITS
                 if s == 1 or (chunks >= MIN_CHUNKS * s and fits(s)))
    return tile, "vector" if _vector_ok(c, x_itemsize, x_ptr) else "scalar", split


def _vector_ok(c: int, x_itemsize: int, x_ptr: int) -> bool:
    """Whether every pixel's channels of x start on 16 bytes."""
    return c * x_itemsize % 16 == 0 and x_ptr % 16 == 0


def conv_weight_operand(w_int8: torch.Tensor) -> torch.Tensor:
    """The kernel's weight operand: ``(O, k*k*Cp)`` int8, each output
    channel's ``(k, k, C)`` weights K-contiguous in (dy, dx, c) order, every
    tap's channels zero-padded to ``Cp``, a multiple of :data:`CONV_KC`. One
    copy of ``w_int8``, which may be any strided view of ``(k, k, C, O)``."""
    k, _, c, o = w_int8.shape
    cp = -(-c // CONV_KC) * CONV_KC
    wt = w_int8.permute(3, 0, 1, 2)  # (O, k, k, C), a view
    if cp != c:
        wt = F.pad(wt, (0, cp - c))
    # row-major (O, K); reshape alone can return a strided view
    op = wt.reshape(o, k * k * cp).contiguous()
    return op if op.data_ptr() % 16 == 0 else op.clone()


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of ``csrc/binary_conv2d_s1.cu``, built at first use."""
    fn = load("binary_conv2d_s1").bnn_binary_conv2d_s1
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    return fn


def binary_conv2d_s1(x: torch.Tensor, w_int8: torch.Tensor,
                     scale: Optional[torch.Tensor] = None,
                     add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``conv(sign(x), w_int8) * scale + add`` for a stride-1 odd kernel:
    the ``bnn_tpu_torch::binary_conv2d_s1`` operator (``kernels/ops.py``),
    whose CUDA implementation is :func:`binary_conv2d_s1_planned` with the
    host's plan and whose CPU implementation is
    :func:`binary_conv2d_s1_reference`.

    Args:
        x: ``(N, H, W, C)`` raw activations, f32 or bf16 (signed inside,
            ``sign(0) == +1``).
        w_int8: ``(k, k, C, O)`` int8 +/-1 weights, contiguous or a view.
        scale, add: ``(O,)`` per-out-channel epilogue (default 1 and 0).
    Returns:
        ``(N, H, W, O)`` f32.
    """
    _check(x, w_int8, scale, add)
    return torch.ops.bnn_tpu_torch.binary_conv2d_s1(x, w_int8, scale, add)


def _check_plan(plan, x: torch.Tensor, k: int) -> None:
    """A ValueError unless ``plan`` names an instance that takes ``x`` and a
    ``k x k`` kernel."""
    tile, loader, split = plan
    itemsize = x.element_size()
    if (tile not in CONV_TILES or split not in CONV_SPLITS
            or loader not in ("vector", "scalar")
            or (loader == "vector"
                and not _vector_ok(x.shape[-1], itemsize, x.data_ptr()))
            or conv_smem_bytes(tile, split, itemsize, k) > SMEM_PER_BLOCK):
        raise ValueError(f"binary_conv2d_s1 has no launch plan {plan!r} for "
                         f"{x.dtype} x {tuple(x.shape)}")


def binary_conv2d_s1_planned(x: torch.Tensor, w_int8: torch.Tensor,
                             scale: Optional[torch.Tensor] = None,
                             add: Optional[torch.Tensor] = None, *,
                             plan: Optional[Tuple[int, str, int]] = None
                             ) -> torch.Tensor:
    """:func:`binary_conv2d_s1`'s kernel on CUDA tensors, launched with
    ``plan`` (``(tile, loader, split)``) in place of :func:`conv_plan`'s, so
    that each instance can be held against the plain version. A plan is
    refused where the vector loader cannot take x or the block's shared
    memory would not fit."""
    _check(x, w_int8, scale, add)
    if plan is not None:
        _check_plan(plan, x, w_int8.shape[0])
    if x.device.type != "cuda" or w_int8.device != x.device:
        raise ValueError(f"binary_conv2d_s1 needs x and w on one CUDA device, "
                         f"got {x.device} and {w_int8.device}")
    if x.dtype not in _X_DTYPES or w_int8.dtype != torch.int8:
        raise TypeError(f"binary_conv2d_s1 takes f32/bf16 x and int8 w, got "
                        f"{x.dtype} and {w_int8.dtype}")
    if not x.is_contiguous():
        raise ValueError("binary_conv2d_s1 needs a contiguous NHWC x")
    n, h, wd, c = x.shape
    k, o = w_int8.shape[0], w_int8.shape[-1]
    tile, loader, split = plan or conv_plan(
        n, h, wd, c, k, o, x.element_size(), x.data_ptr(), _sm_count(x.device))
    scale = _epilogue_operand(scale, o, 1.0, x.device)
    add = _epilogue_operand(add, o, 0.0, x.device)
    out = torch.empty((n, h, wd, o), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    wt = conv_weight_operand(w_int8)
    err = _kernel()(
        x.data_ptr(), int(x.dtype == torch.bfloat16), wt.data_ptr(),
        scale.data_ptr(), add.data_ptr(), out.data_ptr(), n, h, wd, c, k, o,
        tile, int(loader == "vector"), split,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"binary_conv2d_s1 kernel launch failed: CUDA error {err}")
    binary_conv2d_s1.launches += 1
    return out


binary_conv2d_s1.launches = 0


def binary_conv2d_s1_reference(x: torch.Tensor, w_int8: torch.Tensor,
                               scale: Optional[torch.Tensor] = None,
                               add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`binary_conv2d_s1`: the integer conv in
    float64 (exact for these sums, rounded in case a device algorithm is
    not), then the f32 epilogue, multiply and add rounded apart."""
    _check(x, w_int8, scale, add)
    k, o = w_int8.shape[0], w_int8.shape[-1]
    xs = torch.where(x >= 0, 1.0, -1.0).to(torch.float64).permute(0, 3, 1, 2)
    acc = F.conv2d(xs, w_int8.to(torch.float64).permute(3, 2, 0, 1),
                   padding=k // 2)
    acc = acc.round().to(torch.float32).permute(0, 2, 3, 1)
    scale = _epilogue_operand(scale, o, 1.0, x.device)
    add = _epilogue_operand(add, o, 0.0, x.device)
    return (acc * scale + add).contiguous()
