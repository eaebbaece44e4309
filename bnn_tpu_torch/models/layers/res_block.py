"""Residual blocks for BNN-adapted ResNets (counterpart of
``bnn_tpu/models/layers/res_block.py``).

One parameterised chain of conv units covers all four blocks:

- post-activation: ``conv -> BN -> act`` per unit, the last activation after
  the shortcut add;
- pre-activation: ``BN -> conv -> act`` per unit, nothing after the add; the
  norm sits on the unit's input, so its width is the unit's fan-in.

Attribute names (``conv1``/``bn1``/``act1``..., ``downsample``) match the
reference, so recipes, checkpoints and the deployment passes address them
identically.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from ...nn import BatchNorm2d
from ...utils.precision import promote_call
from .common import conv1x1, conv3x3, make_activation

# a unit is (fan_in, fan_out, ksize, stride, groups, dilation)
Unit = Tuple[int, int, int, int, int, int]


def _two_3x3(name: str, inplanes: int, planes: int, stride: int, groups: int,
             base_width: int, dilation: int) -> Sequence[Unit]:
    """Plan for the basic (two 3x3 convs) blocks."""
    if groups != 1 or base_width != 64:
        raise ValueError(f"{name} only supports groups=1 and base_width=64")
    if dilation > 1:
        raise NotImplementedError(f"Dilation > 1 not supported in {name}")
    return (
        (inplanes, planes, 3, stride, 1, 1),
        (planes, planes, 3, 1, 1, 1),
    )


def _squeeze_expand(name: str, inplanes: int, planes: int, stride: int,
                    groups: int, base_width: int, dilation: int
                    ) -> Sequence[Unit]:
    """Plan for the bottleneck (1x1 -> 3x3 -> 1x1) blocks; the stride lives on
    the middle 3x3 conv (ResNet V1.5)."""
    width = int(planes * (base_width / 64.0)) * groups
    return (
        (inplanes, width, 1, 1, 1, 1),
        (width, width, 3, stride, groups, dilation),
        (width, 4 * planes, 1, 1, 1, 1),
    )


class _UnitChain(nn.Module):
    preact: bool = False  # overridden per subclass
    _plan = staticmethod(_two_3x3)

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None, groups: int = 1,
                 base_width: int = 64, dilation: int = 1,
                 norm_layer: Optional[Callable] = None, activation=nn.ReLU):
        super().__init__()
        norm = BatchNorm2d if norm_layer is None else norm_layer
        units = self._plan(type(self).__name__, inplanes, planes, stride,
                           groups, base_width, dilation)
        self.n_units = len(units)
        for i, (cin, cout, k, s, g, d) in enumerate(units, start=1):
            conv = (conv3x3(cin, cout, s, g, d) if k == 3
                    else conv1x1(cin, cout, stride=s))
            setattr(self, f"conv{i}", conv)
            setattr(self, f"bn{i}", norm(cin if self.preact else cout))
            setattr(self, f"act{i}", make_activation(activation, cout))
        self.downsample = downsample
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.downsample is None else self.downsample(x)
        h = x
        for i in range(1, self.n_units + 1):
            conv = getattr(self, f"conv{i}")
            norm = getattr(self, f"bn{i}")
            act = getattr(self, f"act{i}")
            if self.preact:
                h = promote_call(act, conv(promote_call(norm, h)))
            else:
                h = promote_call(norm, conv(h))
                if i < self.n_units:
                    h = promote_call(act, h)
        h = h + shortcut
        return h if self.preact else promote_call(
            getattr(self, f"act{self.n_units}"), h)


class BasicBlock(_UnitChain):
    """Post-activation basic block."""
    expansion = 1
    preact = False
    _plan = staticmethod(_two_3x3)


class Bottleneck(_UnitChain):
    """Post-activation bottleneck."""
    expansion = 4
    preact = False
    _plan = staticmethod(_squeeze_expand)


class PreBasicBlock(_UnitChain):
    """Pre-activation basic block, BN -> Conv -> Act."""
    expansion = 1
    preact = True
    _plan = staticmethod(_two_3x3)


class PreBottleneck(_UnitChain):
    """Pre-activation bottleneck."""
    expansion = 4
    preact = True
    _plan = staticmethod(_squeeze_expand)
