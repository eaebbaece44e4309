"""Hierarchical binary block (Bulat & Tzimiropoulos; counterpart of
``bnn_tpu/models/layers/hierarchical_block.py``).

A cascade of BN -> Act -> conv3x3 stages whose widths taper as
``planes/2, planes/4, planes/4``; every stage's output is kept, and their
concatenation (``planes`` channels) is added to the input.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ...nn import BatchNorm2d
from ...utils.precision import promote_call
from .common import conv3x3, make_activation

# numerators over 4 of the per-stage output widths: planes/2, planes/4 x 2
_TAPER = (2, 1, 1)


class HBlock(nn.Module):
    # maps planes -> planes (the reference's block lacks the attribute)
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None, groups: int = 1,
                 base_width: int = 64, dilation: int = 1,
                 norm_layer: Optional[Callable] = None, activation=nn.ReLU):
        super().__init__()
        norm = BatchNorm2d if norm_layer is None else norm_layer
        for arg, what in ((dilation, "Dilation"), (stride, "Stride")):
            if arg > 1:
                raise NotImplementedError(f"{what} > 1 not supported in HBlock")
        fan_in = inplanes
        for i, quarters in enumerate(_TAPER, start=1):
            fan_out = planes * quarters // 4
            setattr(self, f"bn{i}", norm(fan_in))
            setattr(self, f"act{i}", make_activation(activation, fan_in))
            setattr(self, f"conv{i}", conv3x3(fan_in, fan_out, groups=groups))
            fan_in = fan_out
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.downsample is None else self.downsample(x)
        taps, h = [], x
        for i in range(1, len(_TAPER) + 1):
            h = promote_call(getattr(self, f"bn{i}"), h)
            h = promote_call(getattr(self, f"act{i}"), h)
            h = getattr(self, f"conv{i}")(h)
            taps.append(h)
        return torch.cat(taps, dim=1) + shortcut
