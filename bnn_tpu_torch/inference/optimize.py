"""Deployment-time BatchNorm folds (counterpart of
``bnn_tpu/inference/optimize.py``).

1. **BN after** (``conv -> bn``): an eval-mode BatchNorm is a per-channel
   affine, so it folds into a deployed layer's ``(scale, add)`` epilogue, or
   into a float conv's weight and bias; the BN becomes ``Identity``.
2. **BN before** (``bn -> conv`` with a binarized input):
   ``sign(a * x + b)`` is ``flip_c * sign(x_c - tau_c)`` with
   ``tau = -b / a`` and ``flip = sign(a)``; the flip folds into the weight
   signs and ``tau`` becomes the deployed conv's sign threshold.

Patterns are matched structurally: adjacent pairs in ``nn.Sequential`` and
the conv/bn attribute pairs of the zoo's residual blocks.
"""
from __future__ import annotations

import torch
from torch import nn

from ..kernels.packing import pack_bits, unpack_bits
from ..models.layers import BasicBlock, Bottleneck, PreBasicBlock, PreBottleneck
from ..models.resnet import ResNet
from .deploy import DeployedConv, DeployedLinear

__all__ = ["optimize_deployed", "fold_bn_after", "fold_bn_before"]

_FLOAT_LAYERS = (nn.Conv1d, nn.Conv2d, nn.Linear)
# the JAX package's BatchNorm1d is its BatchNorm2d: both fold alike
_BATCH_NORMS = (nn.BatchNorm1d, nn.BatchNorm2d)


def _foldable(bn) -> bool:
    return (isinstance(bn, _BATCH_NORMS) and not bn.training
            and bn.running_mean is not None)


def _bn_affine(bn: nn.BatchNorm1d | nn.BatchNorm2d):
    """``(a, b)`` with eval-mode ``bn(x) == a * x + b`` per channel, in the
    JAX package's arithmetic order (``1 / sqrt(var + eps)``)."""
    mean = bn.running_mean.detach()
    inv = 1.0 / torch.sqrt(bn.running_var.detach() + bn.eps)
    gamma = bn.weight.detach() if bn.affine else torch.ones_like(mean)
    beta = bn.bias.detach() if bn.affine else torch.zeros_like(mean)
    return gamma * inv, beta - mean * gamma * inv


@torch.no_grad()
def fold_bn_after(layer, bn: nn.BatchNorm1d | nn.BatchNorm2d) -> bool:
    """Fold ``bn(layer(x))`` into ``layer``; returns True on success."""
    if not _foldable(bn):
        return False
    a, b = _bn_affine(bn)
    if isinstance(layer, (DeployedConv, DeployedLinear)):
        if layer.spatial_post is not None:
            return False  # XNORScale between conv and bn: not affine-safe
        if a.shape[0] != layer.scale.shape[-1]:
            return False  # container adjacency != data-flow adjacency
        layer.scale = layer.scale * a
        layer.add = layer.add * a + b
        return True
    if type(layer) in _FLOAT_LAYERS:
        if a.shape[0] != layer.weight.shape[0]:
            return False
        layer.weight.mul_(a.reshape((-1,) + (1,) * (layer.weight.ndim - 1)))
        if layer.bias is not None:
            layer.bias.copy_(layer.bias * a + b)
        else:
            layer.bias = nn.Parameter(b.clone())
        return True
    return False


def _in_channel_flip(flip: torch.Tensor, conv: DeployedConv, ndim: int):
    """The per-weight flip factor for ``(O, I/groups, *k)`` weights: out
    channel block g consumes in-channels ``[g*I/groups, (g+1)*I/groups)``."""
    o, g = conv.out_channels, conv.groups
    f = flip.reshape(g, -1).repeat_interleave(o // g, dim=0)  # (O, I/groups)
    return f.reshape(f.shape + (1,) * (ndim - 2))


@torch.no_grad()
def fold_bn_before(bn: nn.BatchNorm1d | nn.BatchNorm2d,
                   conv: DeployedConv) -> bool:
    """Fold ``conv(sign(bn(x)))`` into a thresholded sign + weight flips."""
    if not isinstance(conv, DeployedConv) or not _foldable(bn):
        return False
    if conv.threshold is not None:
        return False  # already folded
    if conv.spatial_post is not None:
        return False  # XNORScale reads the raw layer input
    a, b = _bn_affine(bn)
    if a.shape[0] != conv.in_channels:
        return False  # the BN does not feed the conv's whole input
    tau = -b / torch.where(a == 0, torch.full_like(a, 1e-12), a)
    flip = torch.where(a >= 0, 1, -1).to(torch.int8)
    # the conv and pallas-conv modes share the (O, I, *k) storage
    conv_layout = conv.mode in ("conv", "pallas-conv")
    if conv_layout and conv.weight_format == "int8":
        w = conv.w_packed
        conv.w_packed = w * _in_channel_flip(flip, conv, w.ndim)
    elif conv_layout:
        w = unpack_bits(conv.w_packed, conv.k, axis=1)[:, : conv.k]
        w = w * _in_channel_flip(flip, conv, w.ndim).to(w.dtype)
        conv.w_packed = pack_bits(w, axis=1)
    else:
        # GEMM layout (K, O), K channel-major: each channel's flip repeats
        # over its filter taps
        w = unpack_bits(conv.w_packed, conv.k, axis=0)[: conv.k]
        fk = flip.repeat_interleave(conv.k // flip.shape[0]).to(w.dtype)
        conv.w_packed = pack_bits(w * fk[:, None], axis=0)
    conv.threshold = tau.to(torch.float32)
    return True


def _fold_in_sequential(seq: nn.Sequential) -> int:
    folded = 0
    for i in range(len(seq) - 1):
        a, b = seq[i], seq[i + 1]
        if isinstance(b, _BATCH_NORMS) and fold_bn_after(a, b):
            seq[i + 1] = nn.Identity()
            folded += 1
        elif isinstance(a, _BATCH_NORMS) and isinstance(b, DeployedConv):
            if fold_bn_before(a, b):
                seq[i] = nn.Identity()
                folded += 1
    return folded


def _fold_block(block, pairs, after: bool) -> int:
    folded = 0
    for ci, bi in pairs:
        conv, bn = getattr(block, ci, None), getattr(block, bi, None)
        if conv is None or bn is None:
            continue
        if fold_bn_after(conv, bn) if after else fold_bn_before(bn, conv):
            setattr(block, bi, nn.Identity())
            folded += 1
    return folded


_BLOCK_PAIRS = (("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3"))


def optimize_deployed(model: nn.Module) -> int:
    """Apply all safe folds in place; returns the number of BNs removed."""
    folded = 0
    for m in list(model.modules()):
        if isinstance(m, nn.Sequential):
            folded += _fold_in_sequential(m)
        elif isinstance(m, (BasicBlock, Bottleneck)):
            folded += _fold_block(m, _BLOCK_PAIRS, after=True)
        elif isinstance(m, (PreBasicBlock, PreBottleneck)):
            # HBlock is not one of these: an activation sits between each of
            # its BNs and convs, which breaks the threshold identity
            folded += _fold_block(m, _BLOCK_PAIRS, after=False)
        elif isinstance(m, ResNet) and m.stem_type == "basic":
            if isinstance(m.bn1, nn.BatchNorm2d) and fold_bn_after(m.conv1, m.bn1):
                m.bn1 = nn.Identity()
                folded += 1
    return folded
