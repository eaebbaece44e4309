"""``padding='same'`` as ``lax`` resolves it, at any stride (counterpart of
``bnn_tpu/functional.py:to_lax_padding``, which hands ``'SAME'`` to ``lax``).

torch takes ``'same'`` at stride 1 only. ``lax`` pads each spatial dim of
size H by a total of ``max((ceil(H / s) - 1) * s + (k - 1) * d + 1 - H, 0)``,
``total // 2`` before and the rest after, so the output has ``ceil(H / s)``
positions; at stride 1 that is torch's own ``'same'``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["same_pads", "static_same_pads", "pad_same", "conv_nd"]


def same_pads(size: int, k: int, stride: int, dilation: int) -> Tuple[int, int]:
    """``(low, high)`` zero padding of one spatial dim of ``size`` under
    ``'same'``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def static_same_pads(kernel_size: Sequence[int], stride: Sequence[int],
                     dilation: Sequence[int]) -> Optional[Tuple[int, ...]]:
    """The symmetric per-dim pads of ``'same'`` where they hold for every
    input size (stride 1 and an even ``(k - 1) * d``, or a 1-wide kernel);
    None where ``'same'`` must be resolved per input."""
    pads = []
    for k, s, d in zip(kernel_size, stride, dilation):
        total = (k - 1) * d
        if k == 1:
            pads.append(0)
        elif s == 1 and total % 2 == 0:
            pads.append(total // 2)
        else:
            return None
    return tuple(pads)


def pad_same(x: torch.Tensor, kernel_size: Sequence[int], stride: Sequence[int],
             dilation: Sequence[int]) -> torch.Tensor:
    """``x`` (channels first: its last ``len(kernel_size)`` dims spatial)
    zero-padded as ``'same'`` pads it, low and high apart."""
    pads = []
    for i in reversed(range(len(kernel_size))):  # F.pad takes the last dim first
        pads += same_pads(x.shape[x.ndim - len(kernel_size) + i], kernel_size[i],
                          stride[i], dilation[i])
    return F.pad(x, pads) if any(pads) else x


def conv_nd(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
            stride, padding, dilation, groups: int = 1) -> torch.Tensor:
    """``F.conv1d`` / ``F.conv2d`` (by ``w``'s rank) with ``padding`` an int,
    a tuple, ``'valid'`` or ``'same'`` at any stride."""
    nd = w.ndim - 2
    conv = F.conv1d if nd == 1 else F.conv2d
    stride = (stride,) * nd if isinstance(stride, int) else tuple(stride)
    dilation = (dilation,) * nd if isinstance(dilation, int) else tuple(dilation)
    if padding == "same" and any(s != 1 for s in stride):
        x = pad_same(x, w.shape[2:], stride, dilation)
        padding = 0
    return conv(x, w, bias, stride, padding, dilation, groups)
