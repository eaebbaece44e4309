"""Stem rewrites for serving (counterpart of ``bnn_tpu/inference/stem.py``).

- :class:`SpaceToDepthConv` runs a stride-2 float conv as the exact
  stride-1 conv over the 2x2 space-to-depth input (``space_to_depth_stem``
  installs it for batches up to ``max_batch``).
- :class:`FusedStem` runs ``maxpool3x3/s2(relu(conv7x7/s2(x) + bias))`` as one
  :func:`~bnn_tpu_torch.kernels.stem.fused_stem` call (``fuse_stem``
  installs it). Batches above ``max_batch`` and inputs with H % 8 or W % 4
  fall back to conv -> ReLU -> maxpool through the held modules; every
  other geometry, which the JAX package splits over its v1/v2/v3 kernels,
  goes to the one CUDA kernel.

Both hold the original ``nn.Conv2d`` (its Parameters shared, not copied).
Eligibility checks take the exact float ``nn.Conv2d`` type, never a binary
subclass.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..binarize import set_module_by_name
from ..kernels.stem import fused_stem
from ..nn import MaxPool2d

__all__ = ["SpaceToDepthConv", "space_to_depth_stem", "FusedStem", "fuse_stem"]


def _transform_kernel(w: torch.Tensor, pad_h: int, pad_w: int):
    """Rearrange an OIHW stride-2 kernel for 2x2 space-to-depth input.

    Returns ``(w_s2d, pl_h, pl_w)``: the ``(O, 4*I, ceil, ceil)`` kernel,
    s2d channel order ``(di, dj, c)``, and the stride-1 conv's left pads.
    """
    cout, cin, kh, kw = w.shape
    fh, fw = pad_h % 2, pad_w % 2  # front fill so the extent starts even
    k8h, k8w = kh + fh, kw + fw
    k8h += k8h % 2
    k8w += k8w % 2
    w8 = F.pad(w, (fw, k8w - kw - fw, fh, k8h - kh - fh))
    t = w8.reshape(cout, cin, k8h // 2, 2, k8w // 2, 2)  # (o, c, ki, di, kj, dj)
    t = t.permute(0, 3, 5, 1, 2, 4).reshape(cout, 4 * cin, k8h // 2, k8w // 2)
    return t, (pad_h + fh) // 2, (pad_w + fw) // 2


def _s2d(x: torch.Tensor) -> torch.Tensor:
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // 2, 2, w // 2, 2)            # (n, c, i, di, j, dj)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(n, 4 * c, h // 2, w // 2)


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _is_stride2_plain(conv) -> bool:
    return (tuple(conv.stride) == (2, 2) and not isinstance(conv.padding, str)
            and tuple(conv.dilation) == (1, 1) and conv.groups == 1)


class SpaceToDepthConv(nn.Module):
    """Exact space-to-depth execution of a stride-2 float conv, for batches
    up to ``max_batch``; larger batches, odd H/W or under-size inputs run
    the wrapped conv."""

    def __init__(self, conv: nn.Conv2d, *, max_batch: int = 8):
        super().__init__()
        if not _is_stride2_plain(conv):
            raise ValueError(
                "SpaceToDepthConv requires stride-2, numeric padding, "
                "dilation 1, groups 1; got "
                f"stride={conv.stride} padding={conv.padding} "
                f"dilation={conv.dilation} groups={conv.groups}")
        self.conv = conv
        self.max_batch = max_batch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.conv
        n, _, h, w = x.shape
        kh, kw = conv.kernel_size
        ph, pw = conv.padding
        if (n > self.max_batch or h % 2 or w % 2
                or h + 2 * ph < kh or w + 2 * pw < kw):
            return conv(x)
        out_h = (h + 2 * ph - kh) // 2 + 1
        out_w = (w + 2 * pw - kw) // 2 + 1
        kern, pl_h, pl_w = _transform_kernel(conv.weight, ph, pw)
        pr_h = out_h - (h // 2) - pl_h + kern.shape[2] - 1
        pr_w = out_w - (w // 2) - pl_w + kern.shape[3] - 1
        y = F.conv2d(F.pad(_s2d(x), (pl_w, pr_w, pl_h, pr_h)),
                     kern.to(x.dtype))
        if conv.bias is not None:
            y = y + conv.bias.to(y.dtype).reshape(1, -1, 1, 1)
        return y


def space_to_depth_stem(model: nn.Module, *, max_in_channels: int = 16,
                        max_batch: int = 8) -> int:
    """Wrap eligible stride-2 small-C_in float convs in
    :class:`SpaceToDepthConv`, in place; returns the number rewritten."""
    done = 0
    wrapped = []  # don't re-wrap the conv held inside a SpaceToDepthConv
    for name, m in list(model.named_modules()):
        if isinstance(m, SpaceToDepthConv):
            wrapped.append(name + ".")
            continue
        if any(name.startswith(p) for p in wrapped):
            continue
        if (type(m) is nn.Conv2d and _is_stride2_plain(m)
                and m.in_channels <= min(16, max_in_channels)):
            set_module_by_name(model, name, SpaceToDepthConv(m, max_batch=max_batch))
            done += 1
    return done


def _inner(conv):
    return conv.conv if isinstance(conv, SpaceToDepthConv) else conv


def _is_basic_stem_conv(inner) -> bool:
    return (tuple(inner.kernel_size) == (7, 7)
            and _is_stride2_plain(inner)
            and tuple(inner.padding) == (3, 3)
            and inner.in_channels <= 4)


class FusedStem(nn.Module):
    """One-kernel execution of the basic ResNet stem. Holds the original
    conv (a :class:`SpaceToDepthConv` wrapper is accepted and kept for the
    fallback path) and calls :func:`~bnn_tpu_torch.kernels.stem.fused_stem`
    on its weight (as HWIO) and bias; the operator keeps the kernel's layout
    of them per weights, so this module keeps nothing but the conv."""

    def __init__(self, conv, *, max_batch: int = 8):
        super().__init__()
        inner = _inner(conv)
        if not _is_basic_stem_conv(inner):
            raise ValueError(
                "FusedStem requires a 7x7/s2/p3 conv with dilation 1, "
                "groups 1 and <=4 input channels; got "
                f"kernel_size={inner.kernel_size} stride={inner.stride} "
                f"padding={inner.padding} dilation={inner.dilation} "
                f"groups={inner.groups} in_channels={inner.in_channels}")
        self.conv = conv
        self.max_batch = max_batch

    def weights(self) -> tuple:
        """``(w, bias)``: the conv's weight as the kernel's ``(7, 7, C, O)``
        HWIO view, and its bias."""
        inner = _inner(self.conv)
        return inner.weight.permute(2, 3, 1, 0), inner.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, _, h, w = x.shape
        if n > self.max_batch or h % 8 or w % 4:
            return F.max_pool2d(torch.relu(self.conv(x)), 3, 2, 1)
        y = fused_stem(x.permute(0, 2, 3, 1).contiguous(), *self.weights())
        return y.permute(0, 3, 1, 2)


def fuse_stem(model: nn.Module, *, max_batch: int = 8) -> int:
    """Fuse eligible basic ResNet stems (conv1 + bn1 + relu + maxpool) in
    place, folding ``bn1`` first if it is still there; returns the number
    of stems fused."""
    from ..models.resnet import ResNet
    from .optimize import fold_bn_after

    fused = 0
    for m in list(model.modules()):
        if not isinstance(m, ResNet) or m.stem_type != "basic":
            continue
        if isinstance(m.conv1, FusedStem):
            continue
        inner = _inner(m.conv1)
        if type(inner) is not nn.Conv2d or not _is_basic_stem_conv(inner):
            continue
        if type(m.relu) is not nn.ReLU:
            continue
        mp = m.maxpool
        if not (type(mp) in (nn.MaxPool2d, MaxPool2d)
                and _pair(mp.kernel_size) == (3, 3)
                and _pair(mp.stride) == (2, 2)
                and _pair(mp.padding) == (1, 1)
                and _pair(mp.dilation) == (1, 1)
                and not mp.ceil_mode):
            continue
        if isinstance(m.bn1, nn.BatchNorm2d):
            if not fold_bn_after(inner, m.bn1):
                continue
            m.bn1 = nn.Identity()
        elif not isinstance(m.bn1, nn.Identity):
            continue
        m.conv1 = FusedStem(m.conv1, max_batch=max_batch)
        m.relu = nn.Identity()
        m.maxpool = nn.Identity()
        fused += 1
    return fused
