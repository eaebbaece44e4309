"""Functional ops (counterpart of ``bnn_tpu/functional.py``): convolution,
dense, pooling and flatten under the JAX package's names and defaults, and
max pooling with a choice of gradient routing among tied maxima.

Layouts are torch's: channels-first activations (``(N, C, L)``,
``(N, C, H, W)``), ``(O, I, *k)`` conv weights and ``(out, in)`` dense
weights, where the JAX package takes channels last, ``(*k, I, O)`` and
``(in, out)``. The forward of every max-pool mode is ``F.max_pool2d``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch.nn.modules.utils import _pair

from .utils.padding import conv_nd

__all__ = ["conv", "linear", "set_pool_grad_mode", "max_pool", "avg_pool",
           "adaptive_avg_pool", "flatten"]

Size = Union[int, Sequence[int]]


def conv(x: torch.Tensor, kernel: torch.Tensor, stride: Size = 1,
         padding: Union[str, Size] = 0, dilation: Size = 1, groups: int = 1,
         preferred_element_type: Optional[torch.dtype] = None) -> torch.Tensor:
    """1-D or 2-D convolution (by ``x``'s rank, 3 or 4) of channels-first
    ``x`` with an ``(O, I / groups, *k)`` kernel; ``padding`` an int, a
    tuple, ``'valid'`` or ``'same'`` (as ``lax`` resolves it, at any stride).
    ``preferred_element_type``: the dtype both operands are widened to and
    the result has (JAX's accumulation type)."""
    if preferred_element_type is not None:
        x, kernel = x.to(preferred_element_type), kernel.to(preferred_element_type)
    if isinstance(padding, str):
        padding = padding.lower()
    return conv_nd(x, kernel, None, stride, padding, dilation, groups)


def linear(x: torch.Tensor, kernel: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ kernel.T (+ bias)`` with an ``(out, in)`` kernel."""
    return F.linear(x, kernel, bias)


# How max_pool's backward routes the gradient of a window with tied maxima:
# 'exact' and 'index' give it to the first maximum in the window's row-major
# order (torch's own backward, the first-argmax rule of JAX's
# select_and_scatter); 'all_ties' gives every tied maximum the full window
# gradient. JAX's 'exact' differs from torch's backward only where
# (H + 2p - k) % s != 0 leaves trailing real input rows outside every window:
# JAX scatters gradient into them, torch gives them 0, as JAX's 'index' does.
# The port's 'exact' is torch's there (ROADMAP.md queue 3, Decided).
_MODES = ("exact", "index", "all_ties")
_POOL_GRAD_MODE = "exact"


def set_pool_grad_mode(mode: str) -> str:
    """Set max_pool's gradient tie routing; returns the previous mode.

    The mode is read at each ``max_pool`` call, so it holds for the forwards
    run after it is set. ``'all_ties'`` applies to 4-D floating inputs; other
    inputs always take torch's backward."""
    global _POOL_GRAD_MODE
    if mode not in _MODES:
        raise ValueError(f"unknown pool grad mode {mode!r}; "
                         "expected 'exact', 'index' or 'all_ties'")
    prev, _POOL_GRAD_MODE = _POOL_GRAD_MODE, mode
    return prev


class _MaxPoolAllTies(torch.autograd.Function):
    """``F.max_pool2d`` whose backward hands every tied maximum of a window
    the window's whole gradient (JAX's ``_mp_at_bwd``): one strided slice of
    the input per window slot, compared with the pooled output, and
    scatter-added in the same slot order."""

    @staticmethod
    def forward(ctx, x, kernel, stride, padding, dilation, ceil_mode):
        out = F.max_pool2d(x, kernel, stride, padding, dilation, ceil_mode)
        ctx.save_for_backward(x, out)
        ctx.geometry = (kernel, stride, padding, dilation)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        (kh, kw), (sh, sw), (ph, pw), (dh, dw) = ctx.geometry
        H, W = x.shape[-2:]
        oH, oW = out.shape[-2:]
        grad = torch.zeros_like(x)
        for ki in range(kh):
            for kj in range(kw):
                # window w covers input row w*s + k*d - pad; keep valid w
                oi, oj = ki * dh - ph, kj * dw - pw
                wi0, wj0 = max(0, -(oi // sh)), max(0, -(oj // sw))
                wi1 = min(oH, (H - 1 - oi) // sh + 1)
                wj1 = min(oW, (W - 1 - oj) // sw + 1)
                if wi1 <= wi0 or wj1 <= wj0:
                    continue
                rows = slice(wi0 * sh + oi, (wi1 - 1) * sh + oi + 1, sh)
                cols = slice(wj0 * sw + oj, (wj1 - 1) * sw + oj + 1, sw)
                win = (..., slice(wi0, wi1), slice(wj0, wj1))
                hit = x[..., rows, cols] == out[win]
                grad[..., rows, cols] += torch.where(hit, g[win], 0).to(grad.dtype)
        return grad, None, None, None, None, None


def max_pool(x: torch.Tensor, kernel_size: Size, stride: Size = None,
             padding: Size = 0, ceil_mode: bool = False,
             dilation: Size = 1) -> torch.Tensor:
    """Max pooling of an ``(N, C, H, W)`` or ``(N, C, L)`` input with torch's
    ``nn.MaxPool1d/2d`` semantics; the backward follows the mode set by
    :func:`set_pool_grad_mode`."""
    stride = kernel_size if stride is None else stride
    if x.ndim == 3:
        return F.max_pool1d(x, kernel_size, stride, padding, dilation, ceil_mode)
    if _POOL_GRAD_MODE == "all_ties" and x.ndim == 4 and x.is_floating_point():
        return _MaxPoolAllTies.apply(x, _pair(kernel_size), _pair(stride),
                                     _pair(padding), _pair(dilation), ceil_mode)
    return F.max_pool2d(x, kernel_size, stride, padding, dilation, ceil_mode)


def avg_pool(x: torch.Tensor, kernel_size: Size, stride: Size = None,
             padding: Size = 0, ceil_mode: bool = False,
             count_include_pad: bool = True) -> torch.Tensor:
    """Average pooling of an ``(N, C, L)`` or ``(N, C, H, W)`` input with
    torch's ``ceil_mode`` and ``count_include_pad`` semantics (the JAX
    package's own): a window's divisor counts its real elements, and its
    explicit padding where ``count_include_pad``, never the ``ceil_mode``
    extension."""
    stride = kernel_size if stride is None else stride
    pool = F.avg_pool1d if x.ndim == 3 else F.avg_pool2d
    return pool(x, kernel_size, stride, padding, ceil_mode, count_include_pad)


def adaptive_avg_pool(x: torch.Tensor, output_size: Size = 1) -> torch.Tensor:
    """Adaptive average pooling: output bin ``i`` of a dim of size S
    averages ``[floor(i * S / o), ceil((i + 1) * S / o))``."""
    if x.ndim == 3:
        return F.adaptive_avg_pool1d(x, output_size)
    return F.adaptive_avg_pool2d(x, output_size)


def flatten(x: torch.Tensor, start_axis: int = 1) -> torch.Tensor:
    """``x`` with every axis from ``start_axis`` on merged into one."""
    return x.reshape(tuple(x.shape[:start_axis]) + (-1,))
