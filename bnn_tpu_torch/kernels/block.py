"""Stride-1 binary BasicBlock in one kernel (counterpart of
``bnn_tpu/kernels/block.py``):

    xs  = sign(x - threshold)
    y1  = act1(conv3x3(xs, w1) * scale1 + add1)
    y2  = conv3x3(sign(y1 - threshold2), w2) * scale2 + add2
    out = act2(y2 + x)            (pre=True: act2(y2) + x)

:func:`fused_basic_block` launches the hand-written Hopper kernel
``bnn_tpu_torch/csrc/fused_basic_block.cu`` for CUDA tensors and takes
:func:`fused_basic_block_reference`, its plain version, only for CPU
tensors. Both compute the same f32 values bit for bit: the convolutions are
exact integer sums, and the zero padding is added after the sign, so padded
taps contribute exactly 0.

Bound on an H100 at ResNet-34 layer4.1's shape (1, 7, 7, 512): 4.7 MB of
int8 weights against 0.46 G int8 operations, so bytes bound it (1.4 us);
the kernel keeps both signed maps in L2-resident int8 scratch and runs the
block as one cooperative launch over the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _blocks as B

__all__ = ["fused_basic_block", "fused_basic_block_reference"]


def _check(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> int:
    if x.ndim != 4:
        raise ValueError(f"expected NHWC x, got {tuple(x.shape)}")
    c = x.shape[-1]
    if tuple(w1.shape) != (3, 3, c, c) or tuple(w2.shape) != (3, 3, c, c):
        raise ValueError(f"fused_basic_block needs (3, 3, {c}, {c}) kernels, "
                         f"got {tuple(w1.shape)} and {tuple(w2.shape)}")
    return c


def fused_basic_block(
    x: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    scale1, add1, scale2, add2,
    *,
    act="relu",
    prelu1=None,
    prelu2=None,
    threshold=None,
    threshold2=None,
    pre: bool = False,
    zero_to_one: bool = True,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """One binary BasicBlock (see the module docstring).

    Args:
        x: ``(N, H, W, C)`` raw block input, f32 or bf16 (the residual add
            uses these values).
        w1, w2: ``(3, 3, C, C)`` +/-1 int8 kernels (HWIO).
        scale1/add1, scale2/add2: ``(C,)`` folded epilogues.
        act: ``'relu' | 'prelu' | 'identity'`` or an ``(act1, act2)`` pair.
        prelu1/prelu2: ``(C,)`` or scalar slopes (default 0.25).
        threshold, threshold2: optional ``(C,)`` sign thresholds of conv1's
            and conv2's inputs.
        pre: pre-activation order, ``act2(y2) + x``.
        zero_to_one: sign(0) convention of both signs (False: sign(0) = 0).
        out_dtype: default x's dtype.
    """
    c = _check(x, w1, w2)
    acts = B.split_act(act)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type == "cpu":
        return fused_basic_block_reference(
            x, w1, w2, scale1, add1, scale2, add2, act=acts, prelu1=prelu1,
            prelu2=prelu2, threshold=threshold, threshold2=threshold2, pre=pre,
            zero_to_one=zero_to_one, out_dtype=out_dtype)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    desc = B.Desc(False, c, c, w1.reshape(9 * c, c), w2.reshape(9 * c, c),
                  None, [scale1, add1, prelu1, scale2, add2, prelu2,
                         None, None, threshold2, threshold, None])
    B.launch("fused_basic_block", x, [desc], out, acts=acts, pre=pre,
             zero_to_one=zero_to_one)
    fused_basic_block.launches += 1
    return out


fused_basic_block.launches = 0


def fused_basic_block_reference(
    x, w1, w2, scale1, add1, scale2, add2, *, act="relu", prelu1=None,
    prelu2=None, threshold=None, threshold2=None, pre=False,
    zero_to_one=True, out_dtype=None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_basic_block` (f32 arithmetic,
    cast to ``out_dtype`` at the end)."""
    c = _check(x, w1, w2)
    act1, act2 = B.split_act(act)
    dev = x.device

    def r(v, default):
        return B.row(v, default, c, dev)

    xf = x.to(torch.float32)
    y1 = B.apply_act(B.epilogue(B.conv3x3(B.sign(xf, r(threshold, 0.0), zero_to_one),
                                          w1, 1), r(scale1, 1.0), r(add1, 0.0)),
                     act1, r(prelu1, 0.25))
    hs = B.sign(y1, r(threshold2, 0.0), zero_to_one)
    y2 = B.epilogue(B.conv3x3(hs, w2, 1), r(scale2, 1.0), r(add2, 0.0))
    p2 = r(prelu2, 0.25)
    out = (B.apply_act(y2, act2, p2) + xf) if pre else B.apply_act(y2 + xf, act2, p2)
    return out.to(x.dtype if out_dtype is None else out_dtype)
