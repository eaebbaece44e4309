"""Stride-1 binary Bottleneck in one kernel (counterpart of
``bnn_tpu/kernels/bottleneck.py``), ResNet-50's block:

    y1  = act1(conv1x1(sign(x - threshold1), w1) * scale1 + add1)
    y2  = act2(conv3x3(sign(y1 - threshold2), w2) * scale2 + add2)
    y3  = conv1x1(sign(y2 - threshold3), w3) * scale3 + add3
    r   = x, or conv1x1(sign(x - thresholdd), wd) * scaled + addd
    out = act3(y3 + r)

:func:`fused_bottleneck` calls the ``bnn_tpu_torch::fused_bottleneck``
operator (``kernels/ops.py``), which launches the hand-written Hopper kernel
``bnn_tpu_torch/csrc/fused_bottleneck.cu`` for CUDA tensors
(:func:`fused_bottleneck_cuda`) and takes :func:`fused_bottleneck_reference`,
its plain version, only for CPU tensors.
Both compute the same f32 values bit for bit: the convolutions are exact
integer sums, the 3x3's zero padding is added after the sign, and every f32
multiply and add rounds on its own.

Bound on an H100 at batch 1: 69.6 KB of int8 weights per layer1 block and
4.46 MB per layer4 block; with the bf16 activations, bytes bound each call
to 0.6-1.5 us. The kernel is one cooperative launch whose phases are
split by grid barriers; its four GEMMs run ``bnn_common.cuh``'s int8
tensor-core tile over K-major weight copies (:meth:`BottleneckDesc.kmajor`),
made once per weights and kept (``_blocks.KEPT``), and
:meth:`BottleneckDesc.plan` reports how the kernel splits them on the card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import _blocks as B
from ._build import load

__all__ = ["BottleneckDesc", "KeptBottleneck", "desc_key", "fused_bottleneck",
           "fused_bottleneck_cuda", "fused_bottleneck_reference", "kept_args"]

_NAME = "fused_bottleneck"
# epilogue rows in csrc/fused_bottleneck.cu's order; the kernel gives a
# missing row its default (scales 1, slopes 0.25, others 0)
ROWS = ("scale1", "add1", "prelu1", "threshold2", "scale2", "add2", "prelu2",
        "threshold3", "scale3", "add3", "prelu3", "scaled", "addd",
        "threshold1", "thresholdd")
_MID_ROWS = ROWS[:8]                      # per conv1 / conv2 output channel
_IN_ROWS = ("threshold1", "thresholdd")   # per input channel; the rest per C_out
GEMMS = ("conv1", "projection", "conv2", "conv3")  # in the kernel's plan


def split_act3(act):
    """``(act1, act2, act3)`` from one kind or a triple, checked."""
    acts = (act,) * 3 if isinstance(act, str) else tuple(act)
    if len(acts) != 3 or any(a not in B.ACTS for a in acts):
        raise ValueError(f"act must be one of {B.ACTS} or a triple of them, "
                         f"got {act!r}")
    return acts


def _weights(c: int, w1, w2, w3, wd):
    """``(width, C_out, w1 (C, width), w2 (3, 3, width, width),
    w3 (width, C_out), wd (C, C_out) or None)``, checked."""
    w1 = w1.reshape(c, -1)
    width = w1.shape[1]
    if tuple(w2.shape) != (3, 3, width, width):
        raise ValueError(f"{_NAME} needs a (3, 3, {width}, {width}) w2, got "
                         f"{tuple(w2.shape)}")
    w3 = w3.reshape(width, -1)
    cout = w3.shape[1]
    if wd is not None:
        wd = wd.reshape(c, cout)
    elif cout != c:
        raise ValueError(f"an identity shortcut needs C_out == C, got {c} -> "
                         f"{cout}; pass wd for a projection")
    return width, cout, w1, w2, w3, wd


def desc_key(w1, w2, w3, wd=None, rows=None) -> tuple:
    """What a :class:`BottleneckDesc` of these arguments is built from
    (:func:`_blocks.tensor_key`)."""
    rows = rows or {}
    return B.tensor_key((w1, w2, w3, wd, *(rows.get(r) for r in ROWS)))


class BottleneckDesc:
    """One Bottleneck as the kernel takes it: int8 weights ``w1 (C, width)``,
    ``w2 (9 * width, width)``, ``w3 (width, C_out)``, ``wd (C, C_out)`` or
    None, and the epilogue rows ``{name: None, a number or a tensor}`` (see
    :data:`ROWS`). Calling it runs the block through the
    ``fused_bottleneck`` operator: the kernel on CUDA tensors, the plain
    version on CPU tensors. The operator's CUDA implementation builds one at
    the first launch on given weights and rows and keeps what the launch
    reads (:meth:`kept`: the K-major weight copies among them) while they
    live unchanged (``_blocks.KEPT``). Its ``key`` is :func:`desc_key` of
    the tensors it was built from."""

    def __init__(self, c: int, w1, w2, w3, wd=None, rows=None):
        rows = dict(rows or {})
        unknown = set(rows) - set(ROWS)
        if unknown:
            raise ValueError(f"{_NAME} takes the rows {ROWS}, got {sorted(unknown)}")
        self.rows = [rows.get(r) for r in ROWS]
        self.key = desc_key(w1, w2, w3, wd, rows)
        self.c = c
        self.width, self.cout, w1, w2, w3, wd = _weights(c, w1, w2, w3, wd)
        self.w1, self.w3, self.wd = w1, w3, wd
        self.w2 = w2.reshape(9 * self.width, self.width)
        self._flat = {}
        self._kmajor = {}

    def __call__(self, x: torch.Tensor, act="relu", zero_to_one: bool = True,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The block on ``x`` through the ``fused_bottleneck`` operator: the
        kernel on CUDA tensors, the plain version on CPU tensors."""
        if x.ndim != 4:
            raise ValueError(f"expected NHWC x, got {tuple(x.shape)}")
        return torch.ops.bnn_tpu_torch.fused_bottleneck(
            x, self.w1, self.w2.reshape(3, 3, self.width, self.width), self.w3,
            self.wd, [B.as_tensor_row(v, x.device) for v in self.rows],
            *split_act3(act), zero_to_one, out_dtype)

    def reference(self, x: torch.Tensor, act="relu", zero_to_one: bool = True,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """:func:`fused_bottleneck_reference` on these weights and rows."""
        return fused_bottleneck_reference(
            x, self.w1, self.w2.reshape(3, 3, self.width, self.width), self.w3,
            wd=self.wd, act=act, zero_to_one=zero_to_one, out_dtype=out_dtype,
            **dict(zip(ROWS, self.rows)))

    def kmajor(self, device) -> tuple:
        """``(w1t, w2t, w3t, wdt)``: K-major ``(N, K)`` int8 copies of the
        weights on ``device``, the GEMMs' B operands as the tensor-core tile
        reads them: ``w1t (width, C)``, ``w2t (width, 9 * width)`` with K in
        the (dy, dx, c) tap order, ``w3t (C_out, width)``, ``wdt (C_out, C)``
        or None. Made once per device and kept."""
        device = torch.device(device)
        if device not in self._kmajor:
            self._kmajor[device] = tuple(
                None if w is None else
                w.to(device=device, dtype=torch.int8).t().contiguous()
                for w in (self.w1, self.w2, self.w3, self.wd))
        return self._kmajor[device]

    def _row_width(self, r: str) -> int:
        if r in _IN_ROWS:
            return self.c
        return self.width if r in _MID_ROWS else self.cout

    def _flat_args(self, dtype, device):
        """``(pointers, row lengths, converted copies)`` of the weights and
        rows, the rows in ``dtype``; the copies must live until the launch."""
        key = (dtype, device)
        if key in self._flat:
            return self._flat[key]
        weights = [self.w1, self.w2, self.w3, self.wd]
        B._check_device(_NAME, device, weights + self.rows)
        if self.c % 4 or self.width % 4 or self.cout % 4:
            raise ValueError(f"{_NAME} needs channel counts divisible by 4, got "
                             f"{self.c} -> {self.width} -> {self.cout}")
        B._check_cuda(_NAME, device)
        flat = B.flat_args(_NAME, weights + list(self.kmajor(device)),
                           zip(ROWS, self.rows),
                           [self._row_width(r) for r in ROWS], dtype, device)
        if not flat[2]:  # converted copies serve one launch only
            self._flat[key] = flat
        return flat

    def kept(self, dtype, device) -> "KeptBottleneck":
        """What a launch reads besides x, its output and scratch: the flat
        arrays of the weights and rows (the rows in ``dtype``) and the
        tensors derived here that they point into (K-major and converted
        copies), never the weights and rows themselves, so that
        ``_blocks.KEPT`` can keep it."""
        ptrs, lens, copies = self._flat_args(dtype, device)
        derived = list(copies) + [t for t in self.kmajor(device) if t is not None]
        return KeptBottleneck(tuple(ptrs), tuple(lens), derived, dtype, self.c,
                              self.width, self.cout, self.wd is not None)

    def _ints(self, shape) -> list:
        """The first ints of the flat array for an ``(N, H, W, C)`` input:
        n, h, w, c, width, cout, projection; checked."""
        return _ints(shape, self.c, self.width, self.cout, self.wd is not None)

    def _args(self, x: torch.Tensor, out: torch.Tensor, acts, zero_to_one: bool):
        """``(pointers, ints, tensors to keep until the launch)``: the
        kernel's flat arrays (x, out, the four weights, their K-major copies,
        the rows, seven scratch buffers; 14 ints, then the row lengths);
        raises on what the kernel does not take."""
        return _launch_args(x, out, acts, zero_to_one,
                            self.kept(_prm_dtype(self.rows), x.device))

    def plan(self, x: torch.Tensor) -> dict:
        """How the kernel splits this block's GEMMs for ``x`` (NHWC, on a
        CUDA device): ``{"blocks": resident blocks of the launch, "conv1":
        (tiles, K slices), "projection": ... or None, "conv2": ..., "conv3":
        ...}``. A GEMM of one slice stores its sums (no zero pass, no
        atomics); a one-slice conv3 also finishes the block in its tiles."""
        B._check_cuda(_NAME, x.device)
        out = (ctypes.c_int * 9)()
        ints = self._ints(x.shape)
        with torch.cuda.device(x.device):
            err = _entry("bnn_fused_bottleneck_plan")((ctypes.c_int * len(ints))(*ints),
                                                      out)
        if err:
            raise RuntimeError(f"{_NAME} plan failed: CUDA error {err}")
        plan = {"blocks": out[0]}
        for j, name in enumerate(GEMMS):
            plan[name] = (out[1 + 2 * j], out[2 + 2 * j])
        if self.wd is None:
            plan["projection"] = None
        return plan


class KeptBottleneck(NamedTuple):
    """:meth:`BottleneckDesc.kept`: the weights' and rows' pointers and row
    lengths, the derived tensors they point into, the rows' dtype and the
    block's widths."""
    ptrs: tuple
    lens: tuple
    derived: list
    dtype: torch.dtype
    c: int
    width: int
    cout: int
    projection: bool


def _prm_dtype(rows) -> torch.dtype:
    """The rows' dtype in the kernel: bf16 where every row tensor is bf16."""
    floats = {v.dtype for v in rows if isinstance(v, torch.Tensor)}
    return torch.bfloat16 if floats == {torch.bfloat16} else torch.float32


def _ints(shape, c, width, cout, projection) -> list:
    n, h, w, cx = shape
    if cx != c:
        raise ValueError(f"{_NAME}: x has {cx} channels, the weights take {c}")
    if n * h * w * max(c, width, cout) >= 2 ** 31:
        raise ValueError(f"{_NAME} indexes its maps in 32 bits: {n * h * w} "
                         f"pixels of up to {max(c, width, cout)} channels are "
                         "too many")
    return [n, h, w, c, width, cout, int(projection)]


def _launch_args(x: torch.Tensor, out: torch.Tensor, acts, zero_to_one: bool,
                 kept: KeptBottleneck):
    """:meth:`BottleneckDesc._args` from a :class:`KeptBottleneck`."""
    dev = x.device
    B._check_device(_NAME, dev, [out])
    if x.dtype not in B._FLOATS or out.dtype not in B._FLOATS:
        raise TypeError(f"{_NAME} takes f32/bf16 x and output, got {x.dtype} "
                        f"and {out.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{_NAME} needs a contiguous NHWC x")
    ints = _ints(x.shape, kept.c, kept.width, kept.cout, kept.projection)
    m = x.shape[0] * x.shape[1] * x.shape[2]
    c, width, cout, proj = kept.c, kept.width, kept.cout, kept.projection
    # xs, ds, hs1, hs2 (int8), then the int32 sums of conv1/conv2, conv3
    # and the projection
    scratch = B._carve(dev, [
        m * c, m * c if proj else 0, m * width, m * width,
        4 * m * width, 4 * m * cout, 4 * m * cout if proj else 0])
    ptrs = [x.data_ptr(), out.data_ptr()] + list(kept.ptrs) + scratch[1:]
    ints += [B.ACTS.index(a) for a in acts]
    ints += [int(zero_to_one), int(x.dtype == torch.bfloat16),
             int(out.dtype == torch.bfloat16),
             int(kept.dtype == torch.bfloat16)] + list(kept.lens)
    return ptrs, ints, [kept, scratch[0]]


def kept_args(w1, w2, w3, wd, rows, device) -> KeptBottleneck:
    """The block's :class:`KeptBottleneck` on ``device`` (``rows`` in
    :data:`ROWS` order), made once per weights and rows and kept while they
    live unchanged (``_blocks.KEPT``)."""
    return B.KEPT.get(
        [w1, w2, w3, wd, *rows], ("bottleneck", device),
        lambda: BottleneckDesc(w1.shape[-2], w1, w2, w3, wd,
                               dict(zip(ROWS, rows))).kept(_prm_dtype(rows), device))


def fused_bottleneck_cuda(x, w1, w2, w3, wd, rows, act1, act2, act3,
                          zero_to_one, out_dtype) -> torch.Tensor:
    """The ``fused_bottleneck`` operator's CUDA implementation: one launch,
    with the block's :class:`KeptBottleneck` kept per weights and rows
    (``_blocks.KEPT``)."""
    if x.ndim != 4:
        raise ValueError(f"expected NHWC x, got {tuple(x.shape)}")
    kept = kept_args(w1, w2, w3, wd, rows, x.device)
    out = torch.empty(x.shape[:3] + (kept.cout,),
                      dtype=x.dtype if out_dtype is None else out_dtype,
                      device=x.device)
    ptrs, ints, keep = _launch_args(x, out, (act1, act2, act3), zero_to_one, kept)
    err = _entry("bnn_fused_bottleneck")(
        (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(ints))(*ints),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{_NAME} kernel launch failed: CUDA error {err}")
    fused_bottleneck.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _entry(symbol: str):
    fn = getattr(load(_NAME), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * (3 if symbol == "bnn_fused_bottleneck" else 2)
    return fn


def fused_bottleneck(
    x: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    w3: torch.Tensor,
    scale1, add1, scale2, add2, scale3, add3,
    *,
    wd: Optional[torch.Tensor] = None,
    scaled=None,
    addd=None,
    act="relu",
    prelu1=None,
    prelu2=None,
    prelu3=None,
    threshold1=None,
    threshold2=None,
    threshold3=None,
    thresholdd=None,
    zero_to_one: bool = True,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """One stride-1 binary Bottleneck (see the module docstring).

    Args:
        x: ``(N, H, W, C)`` raw block input, f32 or bf16 (the identity
            shortcut adds these values).
        w1: ``(C, width)`` or ``(1, 1, C, width)`` +/-1 int8.
        w2: ``(3, 3, width, width)`` +/-1 int8 (HWIO).
        w3: ``(width, C_out)`` or ``(1, 1, width, C_out)`` +/-1 int8.
        scale*/add*: folded per-channel epilogues (None: 1 and 0).
        wd: optional ``(C, C_out)`` 1x1 projection shortcut, with its
            ``scaled``/``addd`` epilogue and ``thresholdd`` sign threshold;
            without it the shortcut is the identity and ``C_out == C``.
        act: ``'relu' | 'prelu' | 'identity'`` or an ``(act1, act2, act3)``
            triple; prelu1..3 are the slopes (default 0.25).
        threshold1..3: optional per-channel thresholds of the three convs'
            input signs.
        zero_to_one: sign(0) convention of every sign (False: sign(0) = 0).
        out_dtype: default x's dtype.
    """
    named = dict(scale1=scale1, add1=add1, prelu1=prelu1, scale2=scale2,
                 add2=add2, prelu2=prelu2, scale3=scale3, add3=add3,
                 prelu3=prelu3, scaled=scaled, addd=addd,
                 threshold1=threshold1, threshold2=threshold2,
                 threshold3=threshold3, thresholdd=thresholdd)
    if x.ndim != 4:
        raise ValueError(f"expected NHWC x, got {tuple(x.shape)}")
    _weights(x.shape[-1], w1, w2, w3, wd)
    return torch.ops.bnn_tpu_torch.fused_bottleneck(
        x, w1, w2, w3, wd, [B.as_tensor_row(named[r], x.device) for r in ROWS],
        *split_act3(act), zero_to_one, out_dtype)


fused_bottleneck.launches = 0


def fused_bottleneck_reference(
    x, w1, w2, w3, scale1, add1, scale2, add2, scale3, add3, *, wd=None,
    scaled=None, addd=None, act="relu", prelu1=None, prelu2=None,
    prelu3=None, threshold1=None, threshold2=None, threshold3=None,
    thresholdd=None, zero_to_one=True, out_dtype=None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_bottleneck` (f32 arithmetic,
    cast to ``out_dtype`` at the end)."""
    c = x.shape[-1]
    width, cout, w1, w2, w3, wd = _weights(c, w1, w2, w3, wd)
    act1, act2, act3 = split_act3(act)
    dev = x.device

    def r(v, default, wide):
        return B.row(v, default, wide, dev)

    def unit(s, w, scale, add, wide):
        return B.epilogue(B.pointwise(s, w) if w.ndim == 2 else B.conv3x3(s, w, 1),
                          r(scale, 1.0, wide), r(add, 0.0, wide))

    xf = x.to(torch.float32)
    y1 = B.apply_act(unit(B.sign(xf, r(threshold1, 0.0, c), zero_to_one), w1,
                          scale1, add1, width), act1, r(prelu1, 0.25, width))
    y2 = B.apply_act(unit(B.sign(y1, r(threshold2, 0.0, width), zero_to_one), w2,
                          scale2, add2, width), act2, r(prelu2, 0.25, width))
    y3 = unit(B.sign(y2, r(threshold3, 0.0, width), zero_to_one), w3, scale3,
              add3, cout)
    if wd is None:
        identity = xf
    else:
        identity = unit(B.sign(xf, r(thresholdd, 0.0, c), zero_to_one), wd,
                        scaled, addd, cout)
    out = B.apply_act(y3 + identity, act3, r(prelu3, 0.25, cout))
    return out.to(x.dtype if out_dtype is None else out_dtype)
