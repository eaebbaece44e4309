"""Stride-2 (downsample) binary BasicBlock in one kernel (counterpart of
``bnn_tpu/kernels/strided_block.py``):

    y1  = act1(conv3x3_s2(sign(x - threshold1), w1) * scale1 + add1)
    y2  = conv3x3(sign(y1 - threshold2), w2) * scale2 + add2
    ds  = conv1x1(sign(avgpool2x2(x) - thresholdd), wd) * scaled + addd
    out = act2(y2 + ds)           (pre=True: act2(y2) + ds)

:func:`fused_downsample_block` calls the
``bnn_tpu_torch::fused_downsample_block`` operator (``kernels/ops.py``),
which launches the hand-written Hopper kernel
``bnn_tpu_torch/csrc/fused_downsample_block.cu`` for CUDA tensors
(:func:`fused_downsample_block_cuda`) and takes
:func:`fused_downsample_block_reference`, its plain version, only for CPU
tensors; both compute the same f32 values bit for bit. Both take conv1's
weights as taps or in the JAX kernel's 2x2 space-to-depth form
(:func:`_transform_w1`), and the 2x2 mean as
``0.25 * (((p00 + p01) + p10) + p11)``, in that order in both versions.

Bound on an H100 at ResNet-34 layer4.0's serving shape (1, 14, 14, 256) ->
512 in bf16: 3.8 MB of weights and activations (conv1's as its 9*Ci*Co
int8 taps; the s2d form's other 7*Ci*Co bytes are zeros) against 0.36 G
int8 operations, so bytes bound it (1.14 us). The design is
fused_basic_block's: the convs run on the int8 tensor cores over K-major
weight copies, conv1 as its 9*Ci taps, made once per weights and kept
(``_blocks.KEPT``); :func:`downsample_block_desc` makes a descriptor of one
block, and :func:`fused_downsample_block_plan` reports the launch.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _blocks as B

__all__ = ["desc_key", "downsample_block_desc", "fused_downsample_block",
           "fused_downsample_block_cuda", "fused_downsample_block_plan",
           "kept_args",
           "fused_downsample_block_reference"]


def _transform_w1(w1: torch.Tensor) -> torch.Tensor:
    """(3, 3, C_in, C_out) stride-2 kernel -> (16*C_in, C_out) s2d form,
    rows in (ki, kj, di, dj, c) order."""
    ci, co = w1.shape[2], w1.shape[3]
    w4 = F.pad(w1, (0, 0, 0, 0, 1, 0, 1, 0))         # (4, 4, ci, co)
    t = w4.reshape(2, 2, 2, 2, ci, co)                # (ki, di, kj, dj, c, o)
    return t.permute(0, 2, 1, 3, 4, 5).reshape(16 * ci, co).contiguous()


_untransform_w1 = B.untransform_w1  # inverse of _transform_w1


def _check(x, w1, w2, wd):
    if x.ndim != 4:
        raise ValueError(f"expected NHWC x, got {tuple(x.shape)}")
    n, h, w, ci = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"fused_downsample_block needs even H and W, got {h}x{w}")
    co = w2.shape[-1]
    if tuple(w1.shape) not in ((3, 3, ci, co), (16 * ci, co)):
        raise ValueError(f"w1 must be (3, 3, {ci}, {co}) or its s2d form "
                         f"({16 * ci}, {co}), got {tuple(w1.shape)}")
    if tuple(w2.shape) != (3, 3, co, co) or wd.numel() != ci * co:
        raise ValueError(f"w2 must be (3, 3, {co}, {co}) and wd ({ci}, {co}), "
                         f"got {tuple(w2.shape)} and {tuple(wd.shape)}")
    return ci, co


def _rows(scale1, add1, scale2, add2, scaled, addd, prelu1, prelu2,
          threshold1, threshold2, thresholdd):
    """The epilogue rows in the descriptor's order (``_blocks.ROWS``)."""
    return [scale1, add1, prelu1, scale2, add2, prelu2, scaled, addd,
            threshold2, threshold1, thresholdd]


def desc_key(w1, w2, wd, scale1, add1, scale2, add2, scaled, addd, *,
             prelu1=None, prelu2=None, threshold1=None, threshold2=None,
             thresholdd=None) -> tuple:
    """What :func:`downsample_block_desc` of these arguments is built from
    (:func:`_blocks.tensor_key`)."""
    return B.tensor_key((w1, w2, wd, *_rows(
        scale1, add1, scale2, add2, scaled, addd, prelu1, prelu2, threshold1,
        threshold2, thresholdd)))


def downsample_block_desc(w1, w2, wd, scale1, add1, scale2, add2, scaled,
                          addd, *, prelu1=None, prelu2=None, threshold1=None,
                          threshold2=None, thresholdd=None) -> B.Desc:
    """The kernel's descriptor of one block (the one the operator's CUDA
    implementation builds, with its K-major weight copies and flat arrays),
    for :func:`fused_downsample_block`'s ``desc``. Its ``key`` is
    :func:`desc_key` of the tensors it was built from: a call whose weights
    or rows differ, or were changed in place since, refuses it."""
    co = w2.shape[-1]
    ci = wd.numel() // co
    rows = dict(prelu1=prelu1, prelu2=prelu2, threshold1=threshold1,
                threshold2=threshold2, thresholdd=thresholdd)
    ws = _transform_w1(w1.to(torch.int8)) if w1.ndim == 4 else w1
    desc = B.Desc(True, ci, co, ws, w2.reshape(9 * co, co), wd.reshape(ci, co),
                  _rows(scale1, add1, scale2, add2, scaled, addd, **rows))
    desc.key = desc_key(w1, w2, wd, scale1, add1, scale2, add2, scaled, addd,
                        **rows)
    return desc


def fused_downsample_block(
    x: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    wd: torch.Tensor,
    scale1, add1, scale2, add2, scaled, addd,
    *,
    act="relu",
    prelu1=None,
    prelu2=None,
    threshold1=None,
    threshold2=None,
    thresholdd=None,
    pre: bool = False,
    zero_to_one: bool = True,
    out_dtype: Optional[torch.dtype] = None,
    desc: Optional[B.Desc] = None,
) -> torch.Tensor:
    """One stride-2 binary BasicBlock (see the module docstring).

    Args:
        x: ``(N, H, W, C_in)`` raw block input, f32 or bf16, H and W even.
        w1: ``(3, 3, C_in, C_out)`` +/-1 int8 stride-2 kernel, or its
            ``(16*C_in, C_out)`` form from :func:`_transform_w1`.
        w2: ``(3, 3, C_out, C_out)``; wd: ``(C_in, C_out)`` or
            ``(1, 1, C_in, C_out)``.
        scale*/add*: ``(C_out,)`` epilogues of conv1, conv2 and the shortcut.
        threshold1, thresholdd: optional ``(C_in,)`` thresholds of conv1's
            input sign and of the pooled shortcut's sign; threshold2:
            ``(C_out,)`` of conv2's input sign.
        desc: :func:`downsample_block_desc` of these weights and rows,
            checked: a descriptor of other tensors, or of tensors changed in
            place since, is refused. The operator keeps its own kernel
            arguments per weights and rows
            (:func:`fused_downsample_block_cuda`).
    Returns:
        ``(N, H/2, W/2, C_out)`` in ``out_dtype`` (default x's dtype).
    """
    _check(x, w1, w2, wd)
    act1, act2 = B.split_act(act)
    rows = dict(prelu1=prelu1, prelu2=prelu2, threshold1=threshold1,
                threshold2=threshold2, thresholdd=thresholdd)
    if desc is not None and desc.key != desc_key(
            w1, w2, wd, scale1, add1, scale2, add2, scaled, addd, **rows):
        raise ValueError("fused_downsample_block's descriptor was built from "
                         "other weights or rows than the call's, or from "
                         "these before an in-place change")
    rows = [B.as_tensor_row(v, x.device) for v in (
        scale1, add1, scale2, add2, scaled, addd, prelu1, prelu2, threshold1,
        threshold2, thresholdd)]
    return torch.ops.bnn_tpu_torch.fused_downsample_block(
        x, w1, w2, wd, *rows, act1, act2, pre, zero_to_one, out_dtype)


def kept_args(w1, w2, wd, scale1, add1, scale2, add2, scaled, addd, prelu1,
              prelu2, threshold1, threshold2, thresholdd, device) -> B.KeptBlocks:
    """The block's kernel arguments on ``device`` (``_blocks.kept_blocks``:
    K-major copies, flat arrays; where ``w1`` comes as taps, its s2d form),
    made once per weights and rows and kept while they live unchanged."""
    co = w2.shape[-1]
    ci = wd.numel() // co
    rows = _rows(scale1, add1, scale2, add2, scaled, addd, prelu1, prelu2,
                 threshold1, threshold2, thresholdd)

    def descs():
        ws = _transform_w1(w1.to(torch.int8)) if w1.ndim == 4 else w1
        return [B.Desc(True, ci, co, ws, w2.reshape(9 * co, co),
                       wd.reshape(ci, co), rows,
                       derived=[] if ws is w1 else [ws])]

    return B.kept_blocks("fused_downsample_block", [w1, w2, wd, *rows], device,
                         descs)


def fused_downsample_block_cuda(x, w1, w2, wd, scale1, add1, scale2, add2,
                                scaled, addd, prelu1, prelu2, threshold1,
                                threshold2, thresholdd, act1, act2, pre,
                                zero_to_one, out_dtype) -> torch.Tensor:
    """The ``fused_downsample_block`` operator's CUDA implementation: one
    launch, with the kernel arguments kept per weights and rows
    (``_blocks.KEPT``; where ``w1`` comes as taps, its s2d form is derived
    once with them)."""
    ci, co = _check(x, w1, w2, wd)
    n, h, w, _ = x.shape
    out = torch.empty((n, h // 2, w // 2, co),
                      dtype=x.dtype if out_dtype is None else out_dtype,
                      device=x.device)
    blocks = kept_args(w1, w2, wd, scale1, add1, scale2, add2, scaled, addd,
                       prelu1, prelu2, threshold1, threshold2, thresholdd,
                       x.device)
    B.launch("fused_downsample_block", x, blocks, out, acts=(act1, act2),
             pre=pre, zero_to_one=zero_to_one)
    fused_downsample_block.launches += 1
    return out


fused_downsample_block.launches = 0


def fused_downsample_block_plan(x: torch.Tensor, co: int) -> dict:
    """The launch of :func:`fused_downsample_block` on ``x`` (NHWC, on the
    current CUDA device) into ``co`` channels, one block per output tile of
    a conv, 2 to 4 an SM: its blocks, the blocks that can be resident an SM,
    a conv's output tiles, and the K slices of conv1, conv2 and the shortcut
    (:func:`_blocks.launch_plan`)."""
    n, h, w, ci = x.shape
    return B.launch_plan("fused_downsample_block", (n * (h // 2) * (w // 2), ci, co),
                         ("conv1", "conv2", "shortcut"))


def fused_downsample_block_reference(
    x, w1, w2, wd, scale1, add1, scale2, add2, scaled, addd, *, act="relu",
    prelu1=None, prelu2=None, threshold1=None, threshold2=None,
    thresholdd=None, pre=False, zero_to_one=True, out_dtype=None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_downsample_block` (f32
    arithmetic, cast to ``out_dtype`` at the end)."""
    ci, co = _check(x, w1, w2, wd)
    act1, act2 = B.split_act(act)
    if w1.ndim == 2:
        w1 = _untransform_w1(w1, ci)
    dev = x.device

    def r(v, default, width=co):
        return B.row(v, default, width, dev)

    xf = x.to(torch.float32)
    y1 = B.apply_act(
        B.epilogue(B.conv3x3(B.sign(xf, r(threshold1, 0.0, ci), zero_to_one), w1, 2),
                   r(scale1, 1.0), r(add1, 0.0)),
        act1, r(prelu1, 0.25))
    hs = B.sign(y1, r(threshold2, 0.0), zero_to_one)
    y2 = B.epilogue(B.conv3x3(hs, w2, 1), r(scale2, 1.0), r(add2, 0.0))
    dsig = B.sign(B.avgpool2x2(xf), r(thresholdd, 0.0, ci), zero_to_one)
    ds = B.epilogue(B.pointwise(dsig, wd.reshape(ci, co)), r(scaled, 1.0),
                    r(addd, 0.0))
    p2 = r(prelu2, 0.25)
    out = (B.apply_act(y2, act2, p2) + ds) if pre else B.apply_act(y2 + ds, act2, p2)
    return out.to(x.dtype if out_dtype is None else out_dtype)
