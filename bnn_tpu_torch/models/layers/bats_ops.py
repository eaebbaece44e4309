"""Candidate operations for BATS binary architecture search (counterpart of
``bnn_tpu/models/layers/bats_ops.py``).

Every conv candidate is one parameterised module (:class:`_BinConvOp`): a
chain of BN -> Conv -> PReLU stages (the binary-friendly order), then an
optional 4-group channel shuffle and an optional residual skip. The public
classes only declare their stage geometry. Layouts are NCHW.
"""
from __future__ import annotations

from collections import namedtuple
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ...nn import BatchNorm2d, MaxPool2d

__all__ = ["Genotype", "PRIMITIVES", "channel_shuffle", "drop_path",
           "FactorizedConv", "ReLUConvBN", "DilConv", "SepConv", "Zero",
           "FactorizedReduce", "OPS"]

Genotype = namedtuple("Genotype", "normal normal_concat reduce reduce_concat")

PRIMITIVES = [
    "none",
    "max_pool_3x3",
    "avg_pool_3x3",
    "skip_connect",
    "sep_conv_3x3",
    "sep_conv_5x5",
    "dil_conv_3x3",
    "dil_conv_5x5",
]

_SHUFFLE_GROUPS = 4


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Interleave channel groups: output channel ``j * groups + i`` is input
    channel ``i * (C / groups) + j``, the JAX package's order."""
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2).reshape(n, c, h, w)


def drop_path(x: torch.Tensor, drop_prob: float,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stochastic depth: zero the whole branch per sample with probability
    ``drop_prob`` and scale the kept ones by ``1 / (1 - drop_prob)``; the
    draws come from ``generator`` (on ``x``'s device)."""
    if drop_prob <= 0.0:
        return x
    keep = 1.0 - drop_prob
    gate = torch.rand((x.shape[0], 1, 1, 1), generator=generator,
                      device=x.device) < keep
    return x * gate.to(x.dtype) / keep


# one conv stage: (cin, cout, ksize, stride, padding, dilation, groups); ksize,
# stride and padding may be ints or (h, w) pairs
Stage = Tuple


class _BinConvOp(nn.Module):
    """BN -> Conv -> PReLU stage chain with optional shuffle and residual."""

    def __init__(self, stages: Sequence[Stage], affine: bool, skip: bool,
                 stride: int, shuffle: bool):
        super().__init__()
        chain = []
        for cin, cout, k, s, p, d, g in stages:
            chain += [
                BatchNorm2d(cin, affine=affine),
                nn.Conv2d(cin, cout, k, stride=s, padding=p, dilation=d,
                          groups=g, bias=False),
                nn.PReLU(num_parameters=cout),
            ]
        self.op = nn.Sequential(*chain)
        self._shuffle = shuffle
        # residual only where the shape holds end to end
        self._residual = skip and stride == 1 and stages[0][0] == stages[-1][1]
        self.skip = skip
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.op(x)
        if self._shuffle:
            h = channel_shuffle(h, _SHUFFLE_GROUPS)
        return x + h if self._residual else h


class FactorizedConv(_BinConvOp):
    """1xk then kx1 factorized conv."""

    def __init__(self, C: int, kernel_size: int, stride: int,
                 affine: bool = True, skip: bool = False):
        half = kernel_size // 2
        super().__init__(
            [(C, C, (1, kernel_size), (1, stride), (0, half), 1, 1),
             (C, C, (kernel_size, 1), (stride, 1), (half, 0), 1, 1)],
            affine, skip, stride, shuffle=True)


class ReLUConvBN(_BinConvOp):
    """BN -> Conv -> PReLU preprocessing op (the name is historical)."""

    def __init__(self, C_in: int, C_out: int, kernel_size: int, stride: int,
                 padding: int, affine: bool = True, skip: bool = False):
        super().__init__([(C_in, C_out, kernel_size, stride, padding, 1, 1)],
                         affine, skip, stride, shuffle=False)
        self.C_in = C_in
        self.C_out = C_out


class DilConv(_BinConvOp):
    """Grouped dilated conv op."""

    def __init__(self, C_in: int, C_out: int, kernel_size: int, stride: int,
                 padding: int, dilation: int, affine: bool = True,
                 skip: bool = False, groups: int = 12):
        super().__init__(
            [(C_in, C_in, kernel_size, stride, padding, dilation, groups)],
            affine, skip, stride, shuffle=True)


class SepConv(_BinConvOp):
    """Grouped separable conv op."""

    def __init__(self, C_in: int, C_out: int, kernel_size: int, stride: int,
                 padding: int, affine: bool = True, skip: bool = False,
                 groups: int = 12):
        super().__init__(
            [(C_in, C_in, kernel_size, stride, padding, 1, groups)],
            affine, skip, stride, shuffle=True)


class Zero(nn.Module):
    """The 'none' op: zeros, strided with ceil semantics (``x[..., ::s, ::s]``),
    so that odd maps match the other strided ops' shapes."""

    def __init__(self, stride: int):
        super().__init__()
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        s = self.stride
        return x.new_zeros((n, c, -(-h // s), -(-w // s)))


class FactorizedReduce(nn.Module):
    """Stride-2 reduction by two 1x1 convs, the second offset by one pixel."""

    def __init__(self, C_in: int, C_out: int, affine: bool = True):
        super().__init__()
        if C_out % 2:
            raise ValueError(f"FactorizedReduce needs an even C_out, got {C_out}")
        self.activation = nn.PReLU(num_parameters=C_out)
        self.conv_1 = nn.Conv2d(C_in, C_out // 2, 1, stride=2, padding=0, bias=False)
        self.conv_2 = nn.Conv2d(C_in, C_out // 2, 1, stride=2, padding=0, bias=False)
        self.bn = BatchNorm2d(C_in, affine=affine)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(x)
        even, odd = self.conv_1(x), self.conv_2(x[:, :, 1:, 1:])
        return self.activation(torch.cat([even, odd], dim=1))


def _pool(build):
    return lambda C, stride, affine, skip, groups: build(stride)


def _identity_or_reduce(C, stride, affine, skip, groups):
    if stride == 1:
        return nn.Identity()
    return FactorizedReduce(C, C, affine=affine)


def _sep(k):
    def build(C, stride, affine, skip, groups):
        return SepConv(C, C, k, stride, k // 2, affine=affine, skip=skip,
                       groups=groups)
    return build


def _dil(k):
    def build(C, stride, affine, skip, groups):
        return DilConv(C, C, k, stride, k - 1, 2, affine=affine, skip=skip,
                       groups=groups)
    return build


# name -> builder(C, stride, affine, skip, groups)
OPS: Dict[str, Callable] = {
    "none": lambda C, stride, affine, skip, groups: Zero(stride),
    "avg_pool_3x3": _pool(lambda s: nn.AvgPool2d(3, stride=s, padding=1,
                                                 count_include_pad=False)),
    "max_pool_3x3": _pool(lambda s: MaxPool2d(3, stride=s, padding=1)),
    "skip_connect": _identity_or_reduce,
    "sep_conv_3x3": _sep(3),
    "sep_conv_5x5": _sep(5),
    "sep_conv_7x7": _sep(7),
    "dil_conv_3x3": _dil(3),
    "dil_conv_5x5": _dil(5),
    "conv_7x1_1x7": lambda C, stride, affine, skip, groups:
        FactorizedConv(C, 7, stride, affine=affine, skip=skip),
}
