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

:func:`binary_conv2d` is a deployed conv's mode ``conv`` (no counterpart
kernel: the JAX package leaves that conv to XLA's int8 ``lax.conv``):
``conv(s(x), w) * scale + add`` for groups 1 and dilation 1 at any stride
and static padding, with the layer's own sign (ternary or ``zero_to_one``,
against an optional per-in-channel threshold) and its epilogue rounded in
the scale's dtype, as one launch of ``bnn_tpu_torch/csrc/binary_conv2d.cu``
(an implicit GEMM on the int8 tensor cores, no patch matrix) for CUDA
tensors. Its plain version :func:`binary_conv2d_reference` is the sign,
``F.unfold`` patches, int8 ``torch._int_mm`` and epilogue the deployed conv
computed before the kernel; it takes grouped, dilated, 1-D and per-call
``'same'`` convs too. Kernel and plain version agree bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ._blocks import KEPT
from ._build import load
from .gemm import H100_SMS, _epilogue_operand, _sm_count
from .packing import unpack_bits

__all__ = ["supports", "binary_conv2d_s1", "binary_conv2d_s1_planned",
           "binary_conv2d_s1_reference", "conv_plan", "conv_weight_operand",
           "binary_conv2d", "binary_conv2d_planned", "binary_conv2d_reference",
           "conv2d_plan", "conv2d_weight_operand", "sign_values", "patches"]

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
    return conv2d_weight_operand(w_int8.permute(3, 2, 0, 1), w_int8.shape[2])


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


# -- binary_conv2d: a deployed conv's mode "conv" ------------------------------

_OUT_DTYPES = (torch.float32, torch.bfloat16)
# binary_conv2d.cu's block tiles, (output pixels, output channels), most work
# a block first
CONV2D_TILES = ((128, 128), (128, 64), (64, 128), (64, 64))


def sign_values(x: torch.Tensor, thr, zero_to_one: bool, dtype) -> torch.Tensor:
    """``sign(x - thr)`` with a layer's sign(0) convention, as ``dtype``:
    {-1, +1} with ``zero_to_one``, else ternary {-1, 0, +1}."""
    if zero_to_one:
        return torch.where(x >= thr, 1, -1).to(dtype)
    return (x > thr).to(dtype) - (x < thr).to(dtype)


def _per_channel(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A ``(C,)`` vector shaped to broadcast over an ``(N, C, ...)`` tensor."""
    return v.reshape((1, -1) + (1,) * (ndim - 2))


def _int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact ``a @ w.T`` for int8 ``a`` (M, K) and ``w`` (N, K), int32 out.
    Zero rows and columns pad the operands to what ``torch._int_mm`` takes
    on CUDA (M > 16, K and N multiples of 8); zeros add nothing."""
    m, k = a.shape
    n = w.shape[0]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w = F.pad(w, (0, kp - k, 0, np_ - n))
    return torch._int_mm(a.contiguous(), w.contiguous().t())[:m, :n]


def _as_2d(x: torch.Tensor, kernel_size, stride, padding, dilation):
    """View a 1-D conv as a 2-D one with unit height."""
    if len(kernel_size) == 2:
        return x, kernel_size, stride, padding, dilation
    return (x.unsqueeze(2), (1,) + tuple(kernel_size), (1,) + tuple(stride),
            (0,) + tuple(padding), (1,) + tuple(dilation))


def patches(xs: torch.Tensor, kernel_size: Sequence[int], stride: Sequence[int],
            padding, dilation: Sequence[int]):
    """``(N * L, K)`` patches of the signed ``(N, C, *spatial)`` ``xs`` in
    channel-major K order (``F.unfold``'s), plus the output spatial shape.
    ``padding='same'`` pads the signed values here, per call, so that padded
    taps add 0, not sign(0)."""
    if padding == "same":
        from ..utils.padding import pad_same

        xs = pad_same(xs, kernel_size, stride, dilation)
        padding = (0,) * len(kernel_size)
    x4, ks, st, pd, dl = _as_2d(xs, kernel_size, stride, padding, dilation)
    n, _, h, w = x4.shape
    oh = (h + 2 * pd[0] - dl[0] * (ks[0] - 1) - 1) // st[0] + 1
    ow = (w + 2 * pd[1] - dl[1] * (ks[1] - 1) - 1) // st[1] + 1
    cols = F.unfold(x4, ks, dilation=dl, padding=pd, stride=st)
    out_sp = (oh, ow) if len(kernel_size) == 2 else (ow,)
    return cols.transpose(1, 2).reshape(n * oh * ow, -1), out_sp


def binary_conv2d_reference(x: torch.Tensor, w_int8: torch.Tensor,
                            scale: torch.Tensor, add: torch.Tensor, *,
                            stride: Sequence[int], padding,
                            dilation: Optional[Sequence[int]] = None,
                            groups: int = 1,
                            threshold: Optional[torch.Tensor] = None,
                            zero_to_one: bool = False) -> torch.Tensor:
    """Plain version of :func:`binary_conv2d`, and a deployed conv's mode
    ``conv`` wherever the kernel does not run: the signed input's patches
    (``F.unfold``) times the weights as an exact int8 x int8 -> int32 product
    (``torch._int_mm``, per group), then ``acc.to(scale.dtype) * scale +
    add`` in the scale's dtype.

    Args:
        x: ``(N, C, H, W)`` or ``(N, C, L)`` raw activations, any layout.
        w_int8: ``(O, C / groups, *k)`` int8 +/-1 weights.
        scale, add: ``(O,)`` per-out-channel epilogue, one dtype.
        stride, dilation: per spatial dim (dilation 1 by default).
        padding: per-dim symmetric zero pads, or ``'same'`` (padded per call).
        threshold: ``(C,)`` per-in-channel sign threshold, or None for 0.
        zero_to_one: sign(0) = +1 ({-1, +1}) rather than 0 (ternary).
    Returns:
        ``(N, O, *out)`` in the scale's dtype, channels-last in memory.
    """
    kernel_size = tuple(w_int8.shape[2:])
    dilation = (1,) * len(kernel_size) if dilation is None else tuple(dilation)
    thr = 0.0 if threshold is None else _per_channel(threshold, x.ndim)
    # signed before patch extraction so the conv's zero padding adds 0;
    # bf16 holds {-1, 0, +1} exactly and F.unfold takes no int8
    cols, out_sp = patches(sign_values(x, thr, zero_to_one, torch.bfloat16),
                           kernel_size, stride, padding, dilation)
    a = cols.to(torch.int8)
    w = w_int8.reshape(w_int8.shape[0], -1)
    kg, og = a.shape[1] // groups, w.shape[0] // groups
    acc = torch.cat([_int_mm(a[:, i * kg:(i + 1) * kg], w[i * og:(i + 1) * og])
                     for i in range(groups)], dim=1) if groups > 1 else _int_mm(a, w)
    acc = acc.reshape((x.shape[0],) + tuple(out_sp) + (-1,))
    acc = acc.permute((0, acc.ndim - 1) + tuple(range(1, acc.ndim - 1)))
    return (acc.to(scale.dtype) * _per_channel(scale, x.ndim)
            + _per_channel(add, x.ndim))


def conv2d_weight_operand(w: torch.Tensor, c: int) -> torch.Tensor:
    """:func:`binary_conv2d`'s weight operand: ``(O, kh*kw*Cp)`` int8, each
    output channel's weights K-contiguous in (dy, dx, c) order, every tap's
    channels zero-padded to ``Cp``, a multiple of :data:`CONV_KC`, from
    ``(O, C, kh, kw)`` int8 +/-1 weights or their words packed over the
    in-channels, ``(O, ceil(C/32), kh, kw)`` int32."""
    if w.dtype != torch.int8:
        w = unpack_bits(w, c, axis=1, dtype=torch.int8)[:, :c]
    o, _, kh, kw = w.shape
    cp = -(-c // CONV_KC) * CONV_KC
    wt = w.permute(0, 2, 3, 1)  # (O, kh, kw, C), a view
    if cp != c:
        wt = F.pad(wt, (0, cp - c))
    # row-major (O, K); reshape alone can return a strided view
    op = wt.reshape(o, kh * kw * cp).contiguous()
    return op if op.data_ptr() % 16 == 0 else op.clone()


def conv2d_plan(m: int, o: int, c: int, k: int, x_itemsize: int, x_ptr: int,
                sms: int = H100_SMS) -> Tuple[Tuple[int, int], str]:
    """``((rows, channels), loader)`` of a :func:`binary_conv2d` launch with
    ``m`` output pixels, ``o`` output channels, ``c`` input channels and
    ``k`` taps.

    The tile (from ``gemm_shapes.py --conv2d``'s times of every tile at the
    flagships' batch-64 layers on an H100): a conv of one or two chunks of K
    (a pointwise conv of up to 128 channels) is bound by each block's fixed
    costs and takes the widest 128-row tile no wider than ``o`` (64 at
    least); a longer K takes 64 rows, by 128 channels where ``o`` exceeds
    64 and the grid still covers the SMs twice, else by 64. The loader:
    ``"vector"`` (16-byte loads) where every pixel's channels start on 16
    bytes, else ``"scalar"``.
    """
    def blocks(t):
        return -(-m // t[0]) * -(-o // t[1])

    if k * -(-c // CONV_KC) <= 2:
        tile = (128, 128) if o > 64 else (128, 64)
    else:
        tile = (64, 128) if o > 64 and blocks((64, 128)) >= 2 * sms else (64, 64)
        if o <= 64 and blocks((128, 64)) >= sms:
            tile = (128, 64)
    return tile, "vector" if _vector_ok(c, x_itemsize, x_ptr) else "scalar"


def _conv2d_out(x: torch.Tensor, w: torch.Tensor, stride, padding) -> Tuple[int, int]:
    kh, kw = w.shape[2:]
    return ((x.shape[1] + 2 * padding[0] - kh) // stride[0] + 1,
            (x.shape[2] + 2 * padding[1] - kw) // stride[1] + 1)


def _check_conv2d(x, w, threshold, scale, add, stride, padding) -> None:
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"expected NHWC x and (O, C, kh, kw) w, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    o, c = w.shape[0], x.shape[-1]
    if w.shape[1] != (c if w.dtype == torch.int8 else -(-c // 32)):
        raise ValueError(f"w {tuple(w.shape)} {w.dtype} does not take {c} "
                         "input channels")
    if len(stride) != 2 or len(padding) != 2 or min(stride) < 1 or min(padding) < 0:
        raise ValueError(f"binary_conv2d takes 2-D strides and static pads, got "
                         f"stride={tuple(stride)} padding={tuple(padding)}")
    if min(_conv2d_out(x, w, stride, padding)) < 1:
        raise ValueError(f"no output position for x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)}")
    for v in (scale, add):
        if tuple(v.shape) != (o,):
            raise ValueError(f"epilogue operands must have shape ({o},), got "
                             f"{tuple(v.shape)}")
    if threshold is not None and tuple(threshold.shape) != (c,):
        raise ValueError(f"threshold must have shape ({c},), got "
                         f"{tuple(threshold.shape)}")


def binary_conv2d(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                  add: torch.Tensor, *, stride: Sequence[int] = (1, 1),
                  padding: Sequence[int] = (0, 0),
                  threshold: Optional[torch.Tensor] = None,
                  zero_to_one: bool = False) -> torch.Tensor:
    """``conv(s(x), w) * scale + add``, groups 1 and dilation 1, as one
    kernel: the ``bnn_tpu_torch::binary_conv2d`` operator
    (``kernels/ops.py``), whose CUDA implementation is
    :func:`binary_conv2d_planned` with the host's plan and whose CPU
    implementation is :func:`binary_conv2d_reference`.

    Args:
        x: ``(N, H, W, C)`` raw activations, f32 or bf16, contiguous.
        w: ``(O, C, kh, kw)`` int8 +/-1 weights, or their words packed over
            the in-channels, ``(O, ceil(C/32), kh, kw)`` int32.
        scale, add: ``(O,)`` per-out-channel epilogue, both f32 or both bf16.
        stride, padding: per spatial dim; symmetric zero pads.
        threshold: ``(C,)`` per-in-channel sign threshold (f32 or bf16), or
            None for 0.
        zero_to_one: sign(0) = +1 ({-1, +1}) rather than 0 (ternary).
    Returns:
        ``(N, OH, OW, O)`` in the scale's dtype, bit-identical to the plain
        version.
    """
    _check_conv2d(x, w, threshold, scale, add, stride, padding)
    return torch.ops.bnn_tpu_torch.binary_conv2d(
        x, w, threshold, scale, add, list(stride), list(padding), zero_to_one)


@functools.lru_cache(maxsize=None)
def _conv2d_kernel():
    """The C entry point of ``csrc/binary_conv2d.cu``, built at first use."""
    fn = load("binary_conv2d").bnn_binary_conv2d
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 16 + [ctypes.c_void_p])
    return fn


def binary_conv2d_planned(x: torch.Tensor, w: torch.Tensor,
                          threshold: Optional[torch.Tensor],
                          scale: torch.Tensor, add: torch.Tensor,
                          stride: Sequence[int], padding: Sequence[int],
                          zero_to_one: bool, *,
                          plan: Optional[Tuple[Tuple[int, int], str]] = None
                          ) -> torch.Tensor:
    """:func:`binary_conv2d`'s kernel on CUDA tensors, launched with
    ``plan`` (``((rows, channels), loader)``) in place of
    :func:`conv2d_plan`'s, so that each instance can be held against the
    plain version. The weight operand (:func:`conv2d_weight_operand`) is
    made once per weights and kept while they live unchanged
    (``_blocks.KEPT``); the epilogue rows and the threshold are read as they
    are."""
    _check_conv2d(x, w, threshold, scale, add, stride, padding)
    tensors = [t for t in (w, threshold, scale, add) if t is not None]
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"binary_conv2d needs every tensor on one CUDA device, "
                         f"got x on {x.device}")
    if (x.dtype not in _X_DTYPES or scale.dtype not in _OUT_DTYPES
            or add.dtype != scale.dtype or w.dtype not in (torch.int8, torch.int32)
            or (threshold is not None and threshold.dtype not in _X_DTYPES)):
        raise TypeError(f"binary_conv2d takes f32/bf16 x, int8 or int32 w, one "
                        f"f32/bf16 dtype for scale and add and an f32/bf16 "
                        f"threshold; got {x.dtype}, {w.dtype}, {scale.dtype}, "
                        f"{add.dtype}")
    if not all(t.is_contiguous() for t in (x, scale, add)) or (
            threshold is not None and not threshold.is_contiguous()):
        raise ValueError("binary_conv2d needs a contiguous NHWC x and "
                         "contiguous epilogue rows and threshold")
    n, h, wd, c = x.shape
    o, _, kh, kw = w.shape
    oh, ow = _conv2d_out(x, w, stride, padding)
    if plan is not None:
        tile, loader = plan
        if tile not in CONV2D_TILES or loader not in ("vector", "scalar") or (
                loader == "vector" and not _vector_ok(c, x.element_size(), x.data_ptr())):
            raise ValueError(f"binary_conv2d has no launch plan {plan!r} for "
                             f"{x.dtype} x {tuple(x.shape)}")
    else:
        tile, loader = conv2d_plan(n * oh * ow, o, c, kh * kw, x.element_size(),
                                   x.data_ptr(), _sm_count(x.device))
    out = torch.empty((n, oh, ow, o), dtype=scale.dtype, device=x.device)
    wt = KEPT.get((w,), ("binary_conv2d", c), lambda: conv2d_weight_operand(w, c))
    err = _conv2d_kernel()(
        x.data_ptr(), int(x.dtype == torch.bfloat16), wt.data_ptr(),
        None if threshold is None else threshold.data_ptr(),
        int(threshold is not None and threshold.dtype == torch.bfloat16),
        scale.data_ptr(), add.data_ptr(), out.data_ptr(),
        int(scale.dtype == torch.bfloat16), n, h, wd, c, o, kh, kw,
        stride[0], stride[1], padding[0], padding[1], int(zero_to_one),
        tile[0], tile[1], int(loader == "vector"),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"binary_conv2d kernel launch failed: CUDA error {err}")
    binary_conv2d.launches += 1
    return out


binary_conv2d.launches = 0


def binary_conv2d_cpu(x, w, threshold, scale, add, stride, padding, zero_to_one):
    """The operator's CPU implementation: :func:`binary_conv2d_reference` on
    its arguments, NHWC in and out."""
    c = x.shape[-1]
    w8 = w if w.dtype == torch.int8 else unpack_bits(w, c, axis=1, dtype=torch.int8)[:, :c]
    y = binary_conv2d_reference(x.permute(0, 3, 1, 2), w8, scale, add,
                                stride=stride, padding=padding,
                                threshold=threshold, zero_to_one=zero_to_one)
    return y.permute(0, 2, 3, 1).contiguous()


def binary_conv2d_fake(x, w, threshold, scale, add, stride, padding, zero_to_one):
    """The operator's output shape and dtype (tracing)."""
    oh, ow = _conv2d_out(x, w, stride, padding)
    return x.new_empty((x.shape[0], oh, ow, w.shape[0]), dtype=scale.dtype)
