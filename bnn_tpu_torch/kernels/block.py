"""Stride-1 binary BasicBlock in one kernel (counterpart of
``bnn_tpu/kernels/block.py``):

    xs  = sign(x - threshold)
    y1  = act1(conv3x3(xs, w1) * scale1 + add1)
    y2  = conv3x3(sign(y1 - threshold2), w2) * scale2 + add2
    out = act2(y2 + x)            (pre=True: act2(y2) + x)

:func:`fused_basic_block` calls the ``bnn_tpu_torch::fused_basic_block``
operator (``kernels/ops.py``), which launches the hand-written Hopper kernel
``bnn_tpu_torch/csrc/fused_basic_block.cu`` for CUDA tensors
(:func:`fused_basic_block_cuda`) and takes
:func:`fused_basic_block_reference`, its plain version, only for CPU
tensors. Both compute the same f32 values bit for bit: the convolutions are
exact integer sums, and the zero padding is added after the sign, so padded
taps contribute exactly 0.

Bound on an H100 at ResNet-34 layer4.1's shape (1, 7, 7, 512): 4.7 MB of
int8 weights against 0.46 G int8 operations, so bytes bound it (1.4 us).
The kernel keeps both signed maps in L2-resident int8 scratch and runs the
block as one cooperative launch whose convs run on the int8 tensor cores
over K-major weight copies, made once per weights and kept
(``_blocks.KEPT``); :func:`basic_block_desc` makes a descriptor of one
block, and :func:`fused_basic_block_plan` reports the launch.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _blocks as B

__all__ = ["basic_block_desc", "desc_key", "fused_basic_block",
           "fused_basic_block_cuda", "fused_basic_block_plan", "kept_args",
           "fused_basic_block_reference"]


def _check(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> int:
    if x.ndim != 4:
        raise ValueError(f"expected NHWC x, got {tuple(x.shape)}")
    c = x.shape[-1]
    if tuple(w1.shape) != (3, 3, c, c) or tuple(w2.shape) != (3, 3, c, c):
        raise ValueError(f"fused_basic_block needs (3, 3, {c}, {c}) kernels, "
                         f"got {tuple(w1.shape)} and {tuple(w2.shape)}")
    return c


def _rows(scale1, add1, scale2, add2, prelu1, prelu2, threshold, threshold2):
    """The epilogue rows in the descriptor's order (``_blocks.ROWS``)."""
    return [scale1, add1, prelu1, scale2, add2, prelu2, None, None, threshold2,
            threshold, None]


def desc_key(w1, w2, scale1, add1, scale2, add2, *, prelu1=None,
             prelu2=None, threshold=None, threshold2=None) -> tuple:
    """What :func:`basic_block_desc` of these arguments is built from
    (:func:`_blocks.tensor_key`)."""
    return B.tensor_key((w1, w2, *_rows(scale1, add1, scale2, add2, prelu1,
                                        prelu2, threshold, threshold2)))


def basic_block_desc(w1, w2, scale1, add1, scale2, add2, *, prelu1=None,
                     prelu2=None, threshold=None, threshold2=None) -> B.Desc:
    """The kernel's descriptor of one block (the one the operator's CUDA
    implementation builds, with its K-major weight copies and flat arrays),
    for :func:`fused_basic_block`'s ``desc``. Its ``key`` is :func:`desc_key`
    of the tensors it was built from: a call whose weights or rows differ,
    or were changed in place since, refuses it."""
    c = w1.shape[-1]
    rows = dict(prelu1=prelu1, prelu2=prelu2, threshold=threshold,
                threshold2=threshold2)
    desc = B.Desc(False, c, c, w1.reshape(9 * c, c), w2.reshape(9 * c, c),
                  None, _rows(scale1, add1, scale2, add2, **rows))
    desc.key = desc_key(w1, w2, scale1, add1, scale2, add2, **rows)
    return desc


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
    desc: Optional[B.Desc] = None,
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
        desc: :func:`basic_block_desc` of these weights and rows, checked:
            a descriptor of other tensors, or of tensors changed in place
            since, is refused. The operator keeps its own kernel arguments
            per weights and rows (:func:`fused_basic_block_cuda`).
    """
    _check(x, w1, w2)
    act1, act2 = B.split_act(act)
    if desc is not None and desc.key != desc_key(
            w1, w2, scale1, add1, scale2, add2, prelu1=prelu1, prelu2=prelu2,
            threshold=threshold, threshold2=threshold2):
        raise ValueError("fused_basic_block's descriptor was built from other "
                         "weights or rows than the call's, or from these "
                         "before an in-place change")
    rows = [B.as_tensor_row(v, x.device) for v in (
        scale1, add1, scale2, add2, prelu1, prelu2, threshold, threshold2)]
    return torch.ops.bnn_tpu_torch.fused_basic_block(
        x, w1, w2, *rows, act1, act2, pre, zero_to_one, out_dtype)


def kept_args(w1, w2, scale1, add1, scale2, add2, prelu1, prelu2, threshold,
              threshold2, device) -> B.KeptBlocks:
    """The block's kernel arguments on ``device`` (``_blocks.kept_blocks``:
    K-major copies, flat arrays), made once per weights and rows and kept
    while they live unchanged."""
    c = w1.shape[-1]
    rows = _rows(scale1, add1, scale2, add2, prelu1, prelu2, threshold, threshold2)
    return B.kept_blocks(
        "fused_basic_block", [w1, w2, *rows], device,
        lambda: [B.Desc(False, c, c, w1.reshape(9 * c, c), w2.reshape(9 * c, c),
                        None, rows)])


def fused_basic_block_cuda(x, w1, w2, scale1, add1, scale2, add2, prelu1,
                           prelu2, threshold, threshold2, act1, act2, pre,
                           zero_to_one, out_dtype) -> torch.Tensor:
    """The ``fused_basic_block`` operator's CUDA implementation: one launch,
    with the kernel arguments kept per weights and rows (``_blocks.KEPT``)."""
    _check(x, w1, w2)
    out = torch.empty(x.shape, dtype=x.dtype if out_dtype is None else out_dtype,
                      device=x.device)
    blocks = kept_args(w1, w2, scale1, add1, scale2, add2, prelu1, prelu2,
                       threshold, threshold2, x.device)
    B.launch("fused_basic_block", x, blocks, out, acts=(act1, act2), pre=pre,
             zero_to_one=zero_to_one)
    fused_basic_block.launches += 1
    return out


fused_basic_block.launches = 0


def fused_basic_block_plan(x: torch.Tensor) -> dict:
    """The launch of :func:`fused_basic_block` on ``x`` (NHWC, on the
    current CUDA device), one block per output tile of a conv, 2 to 4 an
    SM: its blocks, the blocks that can be resident an SM, a conv's output
    tiles and its K slices (:func:`_blocks.launch_plan`)."""
    n, h, w, c = x.shape
    return B.launch_plan("fused_basic_block", (n * h * w, c), ("conv",))


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
