"""Fused ResNet stem (counterpart of ``bnn_tpu/kernels/stem.py``):
``maxpool3x3/s2/p1(relu(conv7x7/s2/p3(x, w) + bias))`` in one kernel.

:func:`fused_stem` calls the ``bnn_tpu_torch::fused_stem`` operator
(``kernels/ops.py``), which launches the hand-written Hopper kernel
``bnn_tpu_torch/csrc/fused_stem.cu`` for CUDA tensors
(:func:`fused_stem_cuda`) and takes :func:`fused_stem_reference`, its plain
version, only for CPU tensors. The
JAX package has three TPU kernels for this one function (``fused_stem``,
``fused_stem_v2``, ``fused_stem_v3``), each tuned to a geometry; the CUDA
kernel accepts every geometry the widest of them (v1: H % 8, W % 4) does,
so it serves all three: :func:`fused_stem_v2` and :func:`fused_stem_v3`
check their JAX kernel's scope and call the same operator, and their
launches count on ``fused_stem.launches``. Every entry point takes
``out_dtype`` (bf16 or f32 on the card, default x's dtype), which the kernel
stores in: an f32 output of bf16 x keeps the f32 sums.

The kernel runs the conv on the bf16 tensor cores (``csrc/stem_common.cuh``),
as the TPU kernels run it on the MXU: bf16 x times bf16 w, summed in f32,
in one pass. An f32 operand is split exactly into three bf16 pieces
(:func:`split_pieces`) and the products of the pieces run as 3 or 6 passes
(:func:`stem_passes`), so f32 inputs keep f32-grade sums. :class:`StemDesc`
holds the weights as the kernel reads them (:class:`StemWeights`: K-major
bf16 pieces and the f32 bias); the operator's CUDA implementation keeps them
per weights (:func:`kept_stem`), so a forward does not build them again.

Bound on an H100 at (8, 224, 224, 3) bf16: 5.6 MB moved (1.7 us) against
1.9 GFLOP (1.9 us at the bf16 tensor-core rate), so the bound is the
arithmetic; the 112x112x64 conv map stays in registers, so device traffic
stays at one read of the input (and its tiles' overlap) and one write of the
pooled output.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ._blocks import KEPT, tensor_key
from ._build import load

__all__ = ["fused_stem", "fused_stem_v2", "fused_stem_v3",
           "fused_stem_reference", "StemDesc", "StemWeights",
           "kept_stem", "split_pieces", "stem_passes", "stem_key",
           "stem_weights", "k_tap_channel"]

_X_DTYPES = (torch.float32, torch.bfloat16)
TAPS = 49          # 7 x 7
K_TAPS = 52        # taps of a weight row: 49, and 3 of zeros (13 k-steps of 4)
KP = 4 * K_TAPS    # 208: K of a weight row, channels padded to 4
OCB = 64           # output channels of a kernel work item: o_pad's multiple
# (x piece, w piece) of each pass in summation order: csrc/stem_common.cuh's
# STEM_PASSES
PASSES = ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0))


def _check_geometry(x: torch.Tensor, w: torch.Tensor, name: str = "fused_stem",
                    h_mult: int = 8, w_mult: int = 4) -> None:
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"expected NHWC x and HWIO w, got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    _, h, ws, c = x.shape
    if not (c <= 4 and h % h_mult == 0 and ws % w_mult == 0):
        raise ValueError(f"{name} needs C <= 4, H % {h_mult} == 0 and "
                         f"W % {w_mult} == 0; got x {tuple(x.shape)}")
    if tuple(w.shape[:3]) != (7, 7, c):
        raise ValueError(f"fused_stem needs a (7, 7, {c}, O) kernel, got "
                         f"{tuple(w.shape)}")


def k_tap_channel(k: int) -> tuple:
    """``(tap, channel)`` at K index ``k`` of a weight row: k-step ``k // 16``
    holds taps ``4s .. 4s + 3``, channels 0-1 of each in its first half and
    2-3 in its second (``k = 16s + 8h + 2u + e`` is tap ``4s + u``, channel
    ``2h + e``), the tensor-core fragments' order in ``csrc/stem_common.cuh``.
    Taps 49-51 are padding."""
    s, r = divmod(k, 16)
    h, r = divmod(r, 8)
    u, e = divmod(r, 2)
    return 4 * s + u, 2 * h + e


def pieces(dtype: torch.dtype) -> int:
    """Exact bf16 pieces of an operand of ``dtype``: 1 for bf16, else 3."""
    return 1 if dtype == torch.bfloat16 else 3


def split_pieces(v: torch.Tensor) -> torch.Tensor:
    """``(3, *v.shape)`` bf16: ``hi = bf16(v)``, ``mid = bf16(v - hi)``,
    ``lo = bf16(v - hi - mid)``, the differences in f32; their sum is ``v``
    (as f32) exactly over f32's normal range. The kernel splits its f32
    inputs the same way."""
    v = v.to(torch.float32)
    hi = v.to(torch.bfloat16)
    r1 = v - hi.to(torch.float32)
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.to(torch.float32)).to(torch.bfloat16)
    return torch.stack([hi, mid, lo])


def stem_passes(x_dtype: torch.dtype, w_dtype: torch.dtype) -> tuple:
    """The (x piece, w piece) products the kernel sums, in order: 1 pass for
    bf16 x and w, 3 where one is f32, 6 where both are."""
    nx, nw = pieces(x_dtype), pieces(w_dtype)
    return tuple(p for p in PASSES if p[0] < nx and p[1] < nw)


def stem_key(w: torch.Tensor, bias: Optional[torch.Tensor]) -> tuple:
    """What a :class:`StemDesc` was built from (:func:`_blocks.tensor_key`)."""
    return tensor_key((w, bias))


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of ``csrc/fused_stem.cu``, built at first use."""
    fn = load("fused_stem").bnn_fused_stem
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _plan_fn():
    fn = load("fused_stem").bnn_fused_stem_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_int)]
    return fn


class StemWeights(NamedTuple):
    """The stem's weights as the kernels read them: ``wk``, the K-major bf16
    pieces ``(P, O_pad, 208)`` (P = 1 for bf16 weights, else the 3 exact
    pieces of :func:`split_pieces`), element ``(o, k)`` holding piece p of
    ``w[ky, kx, c, o]`` where :func:`k_tap_channel` of ``k`` is
    ``(7 * ky + kx, c)``, zero in the padded channels (c >= C), taps
    (49-51) and output channels (o >= O); ``bias_f32``: ``(O_pad,)`` f32,
    zero past O."""
    wk: torch.Tensor
    bias_f32: torch.Tensor
    o: int
    o_pad: int

    @property
    def w_pieces(self) -> int:
        return self.wk.shape[0]


def _check_weights(w: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    if w.ndim != 4 or tuple(w.shape[:2]) != (7, 7) or w.shape[2] > 4:
        raise ValueError(f"fused_stem needs a (7, 7, C <= 4, O) kernel, got "
                         f"{tuple(w.shape)}")
    if bias is not None and bias.numel() != w.shape[3]:
        raise ValueError(f"bias must have {w.shape[3]} values, got "
                         f"{tuple(bias.shape)}")


def stem_weights(w: torch.Tensor, bias: Optional[torch.Tensor] = None) -> StemWeights:
    """:class:`StemWeights` of ``(7, 7, C, O)`` HWIO ``w`` (BN folded, any
    float dtype) and ``(O,)`` ``bias`` or None, on ``w``'s device."""
    _check_weights(w, bias)
    c, o = w.shape[2], w.shape[3]
    o_pad = -(-o // OCB) * OCB
    with torch.no_grad():
        p = pieces(w.dtype)
        split = split_pieces(w.detach())[:p].reshape(p, TAPS, c, o)
        wk = torch.zeros((p, o_pad, K_TAPS, 4), dtype=torch.bfloat16,
                         device=w.device)
        wk[:, :o, :TAPS, :c] = split.permute(0, 3, 1, 2)
        # (tap 4s + u, channel 2h + e) -> K index 16s + 8h + 2u + e
        wk = (wk.reshape(p, o_pad, K_TAPS // 4, 4, 2, 2)
              .permute(0, 1, 2, 4, 3, 5).reshape(p, o_pad, KP).contiguous())
        bias_f32 = torch.zeros(o_pad, dtype=torch.float32, device=w.device)
        if bias is not None:
            bias_f32[:o] = bias.detach().reshape(-1).to(
                device=w.device, dtype=torch.float32)
    return StemWeights(wk, bias_f32, o, o_pad)


def kept_stem(w: torch.Tensor, bias: Optional[torch.Tensor]) -> StemWeights:
    """:func:`stem_weights` of ``w`` and ``bias``, made once and kept while
    they live unchanged (``_blocks.KEPT``): what the kernels' CUDA
    implementations read."""
    return KEPT.get([w, bias], ("stem",), lambda: stem_weights(w, bias))


def check_x(x: torch.Tensor, w: torch.Tensor, name: str) -> None:
    """Raise unless ``x`` is a contiguous f32/bf16 tensor on ``w``'s CUDA
    device."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"{name} needs x and w on one CUDA device, got "
                         f"{x.device} and {w.device}")
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"{name} takes f32/bf16 x, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous NHWC x")


def _out_dtype(x: torch.Tensor, out_dtype: Optional[torch.dtype]) -> torch.dtype:
    """The kernel's output dtype: ``out_dtype``, else x's; bf16 or f32."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if out_dtype not in _X_DTYPES:
        raise TypeError(f"fused_stem stores f32 or bf16, got out_dtype {out_dtype}")
    return out_dtype


def fused_stem_cuda(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor],
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The ``fused_stem`` operator's CUDA implementation: one launch of the
    kernel, with the kept :class:`StemWeights` of ``w`` and ``bias``,
    storing ``out_dtype`` (default x's dtype)."""
    _check_geometry(x, w)
    check_x(x, w, "fused_stem")
    out_dtype = _out_dtype(x, out_dtype)
    sw = kept_stem(w, bias)
    n, h, ws, c = x.shape
    out = torch.empty((n, h // 4, ws // 4, sw.o), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    err = _kernel()(
        x.data_ptr(), int(x.dtype == torch.bfloat16), sw.wk.data_ptr(),
        sw.w_pieces, sw.bias_f32.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.bfloat16), n, h, ws, c, sw.o, sw.o_pad,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_stem kernel launch failed: CUDA error {err}")
    fused_stem.launches += 1
    return out


class StemDesc:
    """The stem's weights as the kernels take them.

    ``w``: ``(7, 7, C, O)`` HWIO (BN folded), any float dtype; ``bias``:
    ``(O,)`` or None; ``wk`` and ``bias_f32``: their :class:`StemWeights`.
    ``key`` is :func:`stem_key` of the tensors it was built from
    (``fused_stem_chain``'s ``stem=`` refuses a descriptor of other
    tensors). Calling it runs the stem through :func:`fused_stem`: the
    kernel on CUDA tensors (whose operator keeps its own
    :func:`kept_stem`), the plain version on CPU tensors."""

    def __init__(self, w: torch.Tensor, bias: Optional[torch.Tensor] = None):
        _check_weights(w, bias)
        self.key = stem_key(w, bias)
        self.w, self.bias = w, bias
        self.c = w.shape[2]
        sw = stem_weights(w, bias)
        self.wk, self.bias_f32, self.o, self.o_pad = sw

    @property
    def w_pieces(self) -> int:
        return self.wk.shape[0]

    def __call__(self, x: torch.Tensor,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return fused_stem(x, self.w, self.bias, out_dtype=out_dtype)

    def plan(self, x: torch.Tensor,
             out_dtype: Optional[torch.dtype] = None) -> dict:
        """The launch the kernel makes for ``x`` and ``out_dtype``: pooled
        rows per work item, items, blocks and blocks per SM."""
        n, h, ws, c = x.shape
        out = (ctypes.c_int * 4)()
        err = _plan_fn()(int(x.dtype == torch.bfloat16), self.w_pieces,
                         int(_out_dtype(x, out_dtype) == torch.bfloat16), n, h,
                         ws, c, self.o, self.o_pad, out)
        if err:
            raise RuntimeError(f"fused_stem plan failed: CUDA error {err}")
        return dict(zip(("rows", "items", "blocks", "blocks_per_sm"), out))


def fused_stem(x: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor] = None, *,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``maxpool3x3/s2/p1(relu(conv7x7/s2/p3(x, w) + bias))``, as the
    ``bnn_tpu_torch::fused_stem`` operator (``kernels/ops.py``): the kernel
    on CUDA tensors, :func:`fused_stem_reference` on CPU tensors.

    Args:
        x: ``(N, H, W, C)`` NHWC input, f32 or bf16, C <= 4, H % 8 == 0,
            W % 4 == 0.
        w: ``(7, 7, C, O)`` HWIO kernel (BN already folded).
        bias: ``(O,)`` folded bias, or None.
        out_dtype: the output's dtype (bf16 or f32 on the card), default
            x's; the kernel stores in it.
    Returns:
        ``(N, H/4, W/4, O)`` in ``out_dtype``.
    """
    _check_geometry(x, w)
    return torch.ops.bnn_tpu_torch.fused_stem(x, w, bias, out_dtype)


fused_stem.launches = 0


def fused_stem_v2(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, *,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:func:`fused_stem` in the scope of the JAX package's batch-1 kernel
    of this name: N == 1, C <= 4, H % 16 == 0, W % 4 == 0 (ValueError
    otherwise). The same operator and kernel; its launches count on
    ``fused_stem.launches``."""
    _check_geometry(x, w, "fused_stem_v2", 16, 4)
    if x.shape[0] != 1:
        raise ValueError(f"fused_stem_v2 takes batch 1 (fused_stem serves "
                         f"larger ones), got x {tuple(x.shape)}")
    return torch.ops.bnn_tpu_torch.fused_stem(x, w, bias, out_dtype)


def fused_stem_v3(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, *,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:func:`fused_stem` in the scope of the JAX package's kernel of this
    name: any batch, C <= 4, H % 16 == 0, W % 8 == 0 (ValueError otherwise).
    The same operator and kernel; its launches count on
    ``fused_stem.launches``."""
    _check_geometry(x, w, "fused_stem_v3", 16, 8)
    return torch.ops.bnn_tpu_torch.fused_stem(x, w, bias, out_dtype)


def fused_stem_reference(x: torch.Tensor, w: torch.Tensor,
                         bias: Optional[torch.Tensor] = None, *,
                         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_stem`, computed in f32 and cast
    once to ``out_dtype`` (default x's dtype) at the end."""
    y = F.conv2d(x.permute(0, 3, 1, 2).to(torch.float32),
                 w.permute(3, 2, 0, 1).to(torch.float32), stride=2, padding=3)
    if bias is not None:
        y = y + bias.to(torch.float32).reshape(1, -1, 1, 1)
    y = F.max_pool2d(torch.relu(y), 3, 2, 1)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    return y.permute(0, 2, 3, 1).to(out_dtype).contiguous()
