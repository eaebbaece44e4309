"""Whole-block fusion pass for small-batch serving (counterpart of
``bnn_tpu/inference/megablock.py``).

:func:`fuse_blocks` replaces eligible deployed blocks, in place:

- a post- or pre-activation stride-1 ``BasicBlock`` / ``PreBasicBlock``
  (identity shortcut) with :class:`FusedBlock`, which runs the whole block
  as one :func:`~bnn_tpu_torch.kernels.block.fused_basic_block` call;
- a stride-2 block with the BNN AvgPool -> 1x1 conv -> BN shortcut with
  :class:`FusedDownBlock` (:func:`~bnn_tpu_torch.kernels.strided_block.
  fused_downsample_block`);
- a stride-1 ``Bottleneck`` (identity or 1x1 projection shortcut) with
  :class:`FusedBottleneck` (:func:`~bnn_tpu_torch.kernels.bottleneck.
  fused_bottleneck`).

Each wrapper holds the original block and decides per call: the kernel runs
iff the batch is at most ``max_fused_batch`` (and, for FusedBlock,
``fuse_when(n, h, w, c)`` holds; for FusedDownBlock, H and W are even);
otherwise the original block runs. BNs still in a block are folded into the
convs' epilogues (post-activation) or sign thresholds (pre-activation) by
the eligibility checks, as in the JAX package.

Modules take NCHW; the kernels take NHWC, so the wrappers permute around
them. The int8 weights are made once, when a block is wrapped.
"""
from __future__ import annotations

import torch
from torch import nn

from ..binarize import set_module_by_name
from ..kernels.block import fused_basic_block
from ..kernels.bottleneck import fused_bottleneck
from ..kernels.packing import unpack_bits
from ..kernels.strided_block import _transform_w1, fused_downsample_block
from ..models.layers import BasicBlock, Bottleneck, PreBasicBlock
from .deploy import DeployedConv
from .optimize import fold_bn_after, fold_bn_before

__all__ = ["fuse_blocks", "FusedBlock", "FusedDownBlock", "FusedBottleneck",
           "default_fuse_predicate"]


def _conv_weight_int8(conv: DeployedConv) -> torch.Tensor:
    """The conv's +/-1 weights as int8 in the JAX kernels' layouts: HWIO for
    a ``conv``-mode layer, ``(K, O)`` (``(C_in, C_out)`` for a 1x1) for the
    GEMM modes."""
    if conv.mode == "conv":
        return conv._int8_weight().permute(2, 3, 1, 0).contiguous()
    return unpack_bits(conv.w_packed, conv.k, axis=0,
                       dtype=torch.int8)[: conv.k].contiguous()


def default_fuse_predicate(n: int, h: int, w: int, c: int) -> bool:
    """The JAX package's region where its block kernel beat the unfused ops
    in isolation on its TPU (C <= 64 or C >= 512). Not measured for the
    port; the default, ``fuse_when=None``, fuses every eligible block."""
    return c <= 64 or c >= 512


def _act_kind(m) -> tuple:
    """(kind, slope or None) of a block activation module."""
    if isinstance(m, nn.ReLU):
        return "relu", None
    if isinstance(m, nn.PReLU):
        return "prelu", m.weight
    if isinstance(m, nn.Identity):
        return "identity", None
    return None, None


def _conv_shape_is(conv, stride: int) -> bool:
    return (isinstance(conv, DeployedConv) and conv.mode == "conv"
            and conv.groups == 1
            and tuple(conv.kernel_size) == (3, 3)
            and tuple(conv.stride) == (stride, stride)
            and tuple(conv.dilation) == (1, 1)
            and tuple(conv.padding) == (1, 1)
            and conv.spatial_post is None)


def _fusable_conv(conv) -> bool:
    return _conv_shape_is(conv, 1) and conv.in_channels == conv.out_channels


def _pointwise_deployed(conv) -> bool:
    # the kernels run 1x1 convs as bare products: a padded or dilated 1x1
    # would lose its padding when fused
    return (isinstance(conv, DeployedConv)
            and conv.mode in ("conv", "gemm", "im2col")
            and conv.groups == 1
            and tuple(conv.kernel_size) == (1, 1)
            and tuple(conv.stride) == (1, 1)
            and tuple(conv.padding) == (0, 0)
            and tuple(conv.dilation) == (1, 1)
            and conv.spatial_post is None)


def _z21(conv) -> bool:
    return bool(getattr(conv, "zero_to_one", False))


def _fold_after(block, pairs) -> bool:
    """Fold each ``conv -> bn`` pair's BN into the conv's epilogue."""
    for layer, bn, setter in pairs:
        if type(bn) is nn.Identity:
            continue
        if isinstance(bn, nn.BatchNorm2d) and fold_bn_after(layer, bn):
            setter()
            continue
        return False
    return True


def _fold_block_bns(block, pre: bool) -> bool:
    """Fold bn1/bn2 of a basic block (post: after the convs; pre: into the
    convs' sign thresholds)."""
    for ci, bi in (("conv1", "bn1"), ("conv2", "bn2")):
        bn, conv = getattr(block, bi), getattr(block, ci)
        if type(bn) is nn.Identity:
            continue
        ok = (isinstance(bn, nn.BatchNorm2d)
              and (fold_bn_before(bn, conv) if pre else fold_bn_after(conv, bn)))
        if not ok:
            return False
        setattr(block, bi, nn.Identity())
    return True


def _eligible_basic(block, cls) -> bool:
    if not isinstance(block, cls) or block.downsample is not None:
        return False
    if not (_fusable_conv(block.conv1) and _fusable_conv(block.conv2)):
        return False
    if _z21(block.conv1) != _z21(block.conv2):
        return False  # the kernel applies one sign(0) convention to both signs
    if _act_kind(block.act1)[0] is None or _act_kind(block.act2)[0] is None:
        return False
    return _fold_block_bns(block, pre=cls is PreBasicBlock)


def _eligible(block) -> bool:
    """A post-activation stride-1 BasicBlock the kernel can run."""
    return _eligible_basic(block, BasicBlock)


def _eligible_pre(block) -> bool:
    """A pre-activation stride-1 block: bn1/bn2 fold into the convs' sign
    thresholds, and the kernel runs it with ``pre=True``."""
    return _eligible_basic(block, PreBasicBlock)


def _downsample_parts(block):
    """(avgpool, conv1x1, bn) of an eligible BNN downsample, else None."""
    ds = block.downsample
    if type(ds) is not nn.Sequential or len(ds) != 3:
        return None
    ap, conv, bn = ds[0], ds[1], ds[2]
    if type(ap) is not nn.AvgPool2d:
        return None
    stride = ap.stride if ap.stride is not None else ap.kernel_size

    def pair(v):
        return tuple(v) if isinstance(v, (tuple, list)) else (v, v)

    if (pair(ap.kernel_size) != (2, 2) or pair(stride) != (2, 2)
            or pair(ap.padding) != (0, 0)):
        return None
    if not _pointwise_deployed(conv):
        return None
    return ap, conv, bn


def _eligible_down(block) -> bool:
    """A stride-2 block with the BNN AvgPool -> 1x1 -> BN shortcut."""
    pre = isinstance(block, PreBasicBlock)
    if not isinstance(block, (BasicBlock, PreBasicBlock)) or block.downsample is None:
        return False
    if not (_conv_shape_is(block.conv1, 2) and _conv_shape_is(block.conv2, 1)):
        return False
    parts = _downsample_parts(block)
    if parts is None:
        return False
    _, dconv, bn = parts
    z = _z21(block.conv1)
    if _z21(block.conv2) != z or _z21(dconv) != z:
        return False
    if _act_kind(block.act1)[0] is None or _act_kind(block.act2)[0] is None:
        return False
    if pre and not _fold_block_bns(block, pre=True):
        return False
    pairs = [(dconv, bn, lambda: block.downsample.__setitem__(2, nn.Identity()))]
    if not pre:
        pairs = [(block.conv1, block.bn1, lambda: setattr(block, "bn1", nn.Identity())),
                 (block.conv2, block.bn2, lambda: setattr(block, "bn2", nn.Identity()))
                 ] + pairs
    return _fold_after(block, pairs)


def _eligible_bottleneck(block) -> bool:
    """A stride-1 Bottleneck that ``fused_bottleneck`` would run."""
    if not isinstance(block, Bottleneck):
        return False
    dconv = dbn = None
    if block.downsample is not None:
        # stride-1 projection: AvgPool(k=s=1) (a no-op) -> 1x1 conv -> BN
        ds = block.downsample
        if type(ds) is not nn.Sequential or len(ds) != 3:
            return False
        ap, dconv, dbn = ds[0], ds[1], ds[2]
        ks = ap.kernel_size if type(ap) is nn.AvgPool2d else None
        stride = (ap.stride if getattr(ap, "stride", None) is not None else ks)
        if ks not in (1, (1, 1)) or stride not in (1, (1, 1)):
            return False
        if not _pointwise_deployed(dconv) or _z21(dconv) != _z21(block.conv1):
            return False
    if not (_pointwise_deployed(block.conv1) and _pointwise_deployed(block.conv3)):
        return False
    if not _fusable_conv(block.conv2):
        return False
    if block.downsample is None \
            and block.conv1.in_channels != block.conv3.out_channels:
        return False  # the identity residual needs matching widths
    z = _z21(block.conv1)
    if any(_z21(cv) != z for cv in (block.conv2, block.conv3)):
        return False
    if any(_act_kind(a)[0] is None for a in (block.act1, block.act2, block.act3)):
        return False
    pairs = [(getattr(block, c), getattr(block, b),
              lambda b=b: setattr(block, b, nn.Identity()))
             for c, b in (("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3"))]
    if dbn is not None:
        pairs.append((dconv, dbn,
                      lambda: block.downsample.__setitem__(2, nn.Identity())))
    return _fold_after(block, pairs)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class FusedBlock(nn.Module):
    """Kernel execution of a deployed stride-1 BasicBlock (``pre=True``: a
    PreBasicBlock). Holds the original block for larger batches, and its
    int8 weights as buffers; the operator keeps the kernel arguments derived
    from them (K-major copies) until ``.to()``, a cast or an in-place update
    (such as ``load_state_dict``) changes a tensor they were made from."""

    def __init__(self, block, *, max_fused_batch: int = 4, fuse_when=None,
                 pre: bool = False):
        super().__init__()
        self.block = block
        self.max_fused_batch = max_fused_batch
        self.fuse_when = fuse_when or (lambda n, h, w, c: True)
        self.pre = pre
        self.register_buffer("w1", _conv_weight_int8(block.conv1))
        self.register_buffer("w2", _conv_weight_int8(block.conv2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.block
        n, c, h, w = x.shape
        if n > self.max_fused_batch or not self.fuse_when(n, h, w, c):
            return b(x)
        a1, p1 = _act_kind(b.act1)
        a2, p2 = _act_kind(b.act2)
        y = fused_basic_block(
            _nhwc(x), self.w1, self.w2, b.conv1.scale, b.conv1.add,
            b.conv2.scale, b.conv2.add, act=(a1, a2), pre=self.pre,
            zero_to_one=_z21(b.conv1), out_dtype=x.dtype, prelu1=p1,
            prelu2=p2, threshold=b.conv1.threshold,
            threshold2=b.conv2.threshold)
        return y.permute(0, 3, 1, 2)


class FusedDownBlock(nn.Module):
    """Kernel execution of a deployed stride-2 block with the BNN
    AvgPool -> 1x1 shortcut. Holds the original block for larger batches and
    odd H or W, and its int8 weights as buffers; the operator keeps the
    kernel arguments derived from them (K-major copies) until ``.to()``, a
    cast or an in-place update (such as ``load_state_dict``) changes a
    tensor they were made from."""

    def __init__(self, block, *, max_fused_batch: int = 4, pre: bool = False):
        super().__init__()
        self.block = block
        self.max_fused_batch = max_fused_batch
        self.pre = pre
        ci = block.conv1.in_channels
        self.register_buffer("w1", _transform_w1(_conv_weight_int8(block.conv1)))
        self.register_buffer("w2", _conv_weight_int8(block.conv2))
        self.register_buffer("wd", _conv_weight_int8(block.downsample[1])
                             .reshape(ci, -1).contiguous())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.block
        n, _, h, w = x.shape
        if n > self.max_fused_batch or h % 2 or w % 2:
            return b(x)
        dconv = b.downsample[1]
        a1, p1 = _act_kind(b.act1)
        a2, p2 = _act_kind(b.act2)
        y = fused_downsample_block(
            _nhwc(x), self.w1, self.w2, self.wd, b.conv1.scale, b.conv1.add,
            b.conv2.scale, b.conv2.add, dconv.scale, dconv.add, act=(a1, a2),
            pre=self.pre, zero_to_one=_z21(b.conv1), out_dtype=x.dtype,
            prelu1=p1, prelu2=p2, threshold1=b.conv1.threshold,
            threshold2=b.conv2.threshold, thresholdd=dconv.threshold)
        return y.permute(0, 3, 1, 2)


class FusedBottleneck(nn.Module):
    """Kernel execution of a deployed stride-1 Bottleneck, with an identity
    or a stride-1 1x1 projection shortcut. Holds the original block for
    larger batches, and its int8 weights as buffers; the operator keeps the
    kernel arguments derived from them (a :class:`~bnn_tpu_torch.kernels.
    bottleneck.KeptBottleneck`) until ``.to()``, a cast or an in-place update
    (such as ``load_state_dict``) changes a tensor they were made from."""

    def __init__(self, block, *, max_fused_batch: int = 4):
        super().__init__()
        self.block = block
        self.max_fused_batch = max_fused_batch
        c = block.conv1.in_channels
        self.register_buffer("w1", _conv_weight_int8(block.conv1).reshape(c, -1))
        self.register_buffer("w2", _conv_weight_int8(block.conv2))
        self.register_buffer("w3", _conv_weight_int8(block.conv3)
                             .reshape(block.conv3.in_channels, -1))
        self.register_buffer("wd", None if block.downsample is None else
                             _conv_weight_int8(block.downsample[1]).reshape(c, -1))
        self._acts = tuple(_act_kind(a)[0] for a in (block.act1, block.act2,
                                                     block.act3))

    def _rows(self) -> dict:
        b = self.block
        rows = dict(scale1=b.conv1.scale, add1=b.conv1.add,
                    prelu1=_act_kind(b.act1)[1], threshold1=b.conv1.threshold,
                    scale2=b.conv2.scale, add2=b.conv2.add,
                    prelu2=_act_kind(b.act2)[1], threshold2=b.conv2.threshold,
                    scale3=b.conv3.scale, add3=b.conv3.add,
                    prelu3=_act_kind(b.act3)[1], threshold3=b.conv3.threshold)
        if self.wd is not None:
            dconv = b.downsample[1]
            rows.update(scaled=dconv.scale, addd=dconv.add,
                        thresholdd=dconv.threshold)
        return rows

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.block
        if x.shape[0] > self.max_fused_batch:
            return b(x)
        y = fused_bottleneck(_nhwc(x), self.w1, self.w2, self.w3, wd=self.wd,
                             act=self._acts, zero_to_one=_z21(b.conv1),
                             out_dtype=x.dtype, **self._rows())
        return y.permute(0, 3, 1, 2)


_WRAPPERS = (FusedBlock, FusedDownBlock, FusedBottleneck)


def fuse_blocks(model: nn.Module, *, max_fused_batch: int = 4, fuse_when=None,
                strided: bool = True) -> int:
    """Wrap eligible deployed blocks (in place); returns how many.

    Apply after :func:`~bnn_tpu_torch.inference.deploy` and, ideally,
    :func:`~bnn_tpu_torch.inference.optimize.optimize_deployed`. Descends
    into a :class:`~bnn_tpu_torch.inference.stages.FusedStage`'s fallback
    Sequential, so that batches above the stage's cap still run per-block
    kernels. ``strided`` also wraps post-activation stride-2 blocks
    (pre-activation ones are always wrapped).
    """
    fused = 0
    wrapped = []  # blocks held by a wrapper stay as they are
    for name, m in list(model.named_modules()):
        if isinstance(m, _WRAPPERS):
            wrapped.append(name + ".")
            continue
        if not name or any(name.startswith(p) for p in wrapped):
            continue
        if _eligible(m):
            new = FusedBlock(m, max_fused_batch=max_fused_batch,
                             fuse_when=fuse_when)
        elif _eligible_pre(m):
            new = FusedBlock(m, max_fused_batch=max_fused_batch,
                             fuse_when=fuse_when, pre=True)
        elif _eligible_bottleneck(m):
            new = FusedBottleneck(m, max_fused_batch=max_fused_batch)
        elif _eligible_down(m) and (strided or isinstance(m, PreBasicBlock)):
            new = FusedDownBlock(m, max_fused_batch=max_fused_batch,
                                 pre=isinstance(m, PreBasicBlock))
        else:
            continue
        set_module_by_name(model, name, new)
        wrapped.append(name + ".")
        fused += 1
    return fused
