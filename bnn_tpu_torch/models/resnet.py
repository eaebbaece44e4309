"""BNN-adapted ResNet family (counterpart of ``bnn_tpu/models/resnet.py``).

BNN-specific deltas from a vanilla ResNet: a pluggable ``block_type`` and
``activation``, and an AvgPool -> 1x1 conv -> BN shortcut on strided stages.
Attribute names (``conv1``, ``layer1..4``, ``downsample.1`` ...) match the
reference, so recipes and checkpoints address layers by the same paths.
Only the basic stem is ported; the DaBNN stem is still to come.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Type

import torch
from torch import nn

from ..nn import BatchNorm2d, MaxPool2d
from ..utils.precision import promote_call
from .layers import BasicBlock, Bottleneck, conv1x1

_STAGE_WIDTHS = (64, 128, 256, 512)
_STEM_WIDTH = 64


def _avgpool_shortcut(cin: int, cout: int, stride: int,
                      norm: Callable) -> nn.Sequential:
    """The BNN projection shortcut: AvgPool -> conv1x1 -> BN."""
    return nn.Sequential(
        nn.AvgPool2d(kernel_size=stride, stride=stride, ceil_mode=True,
                     count_include_pad=False),
        conv1x1(cin, cout, stride=1),
        norm(cout),
    )


def _stage(block: Type, cin: int, planes: int, count: int, stride: int,
           dilation: int, dilate: bool, groups: int, base_width: int,
           norm: Callable, activation):
    """Build one ResNet stage; returns (Sequential, fan_out, new_dilation)."""
    entry_dilation = dilation
    if dilate:
        dilation *= stride
        stride = 1
    cout = planes * block.expansion
    shortcut = (None if stride == 1 and cin == cout
                else _avgpool_shortcut(cin, cout, stride, norm))
    blocks = [block(cin, planes, stride, shortcut, groups, base_width,
                    entry_dilation, norm, activation=activation)]
    blocks += [block(cout, planes, groups=groups, base_width=base_width,
                     dilation=dilation, norm_layer=norm, activation=activation)
               for _ in range(count - 1)]
    return nn.Sequential(*blocks), cout, dilation


class ResNet(nn.Module):
    def __init__(
        self,
        block: Type,
        layers: List[int],
        num_classes: int = 1000,
        zero_init_residual: bool = False,
        groups: int = 1,
        width_per_group: int = 64,
        replace_stride_with_dilation: Optional[List[bool]] = None,
        norm_layer: Optional[Callable] = None,
        activation: Optional[Callable] = None,
        stem_type: str = "basic",
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        norm = BatchNorm2d if norm_layer is None else norm_layer
        activation = nn.ReLU if activation is None else activation
        dilate = (list(replace_stride_with_dilation)
                  if replace_stride_with_dilation is not None
                  else [False, False, False])
        if len(dilate) != 3:
            raise ValueError(
                "replace_stride_with_dilation should be None or a 3-element "
                f"tuple, got {replace_stride_with_dilation}")
        if stem_type == "dabnn":
            raise NotImplementedError(
                "the DaBNN stem (bnn_tpu/models/resnet.py DaBNNStem) is not "
                "ported yet")
        if stem_type != "basic":
            raise ValueError(f"Unknown stem_type {stem_type!r}")
        self.stem_type = stem_type
        self.conv1 = nn.Conv2d(3, _STEM_WIDTH, kernel_size=7, stride=2,
                               padding=3, bias=False)
        self.bn1 = norm(_STEM_WIDTH)
        self.relu = nn.ReLU()
        self.maxpool = MaxPool2d(kernel_size=3, stride=2, padding=1)

        fan, dilation = _STEM_WIDTH, 1
        for idx, (planes, count) in enumerate(zip(_STAGE_WIDTHS, layers)):
            stage, fan, dilation = _stage(
                block, fan, planes, count,
                stride=1 if idx == 0 else 2,
                dilation=dilation,
                dilate=False if idx == 0 else dilate[idx - 1],
                groups=groups, base_width=width_per_group,
                norm=norm, activation=activation)
            setattr(self, f"layer{idx + 1}", stage)
        self.avgpool = nn.AdaptiveAvgPool2d((1, 1))
        self.fc = nn.Linear(fan, num_classes)
        self._init_weights(generator, zero_init_residual)

    @torch.no_grad()
    def _init_weights(self, generator: Optional[torch.Generator],
                      zero_init_residual: bool) -> None:
        """Kaiming-normal fan_out convs and torch-default linears, all drawn
        from ``generator``; ``zero_init_residual`` zeroes each block's last
        BN scale so blocks start as identities."""
        def draw(t: torch.Tensor, values: torch.Tensor) -> None:
            t.copy_(values.to(t.dtype))

        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                draw(m.weight, math.sqrt(2.0 / fan_out) * torch.randn(
                    m.weight.shape, generator=generator))
            elif isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                draw(m.weight, (2 * torch.rand(m.weight.shape,
                                               generator=generator) - 1) * bound)
                if m.bias is not None:
                    draw(m.bias, (2 * torch.rand(m.bias.shape,
                                                 generator=generator) - 1) * bound)
            elif zero_init_residual and isinstance(m, Bottleneck):
                m.bn3.weight.zero_()
            elif zero_init_residual and isinstance(m, BasicBlock):
                m.bn2.weight.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for i in (1, 2, 3, 4):
            x = getattr(self, f"layer{i}")(x)
        return promote_call(self.fc, torch.flatten(self.avgpool(x), 1))


_CONFIGS = {
    18: ([2, 2, 2, 2], BasicBlock),
    34: ([3, 4, 6, 3], BasicBlock),
    50: ([3, 4, 6, 3], Bottleneck),
}


def _build(depth: int, block_type: Optional[Type], kwargs) -> ResNet:
    counts, default_block = _CONFIGS[depth]
    return ResNet(default_block if block_type is None else block_type,
                  counts, **kwargs)


def resnet18(block_type: Optional[Type] = None, **kwargs) -> ResNet:
    """ResNet-18 with pluggable block type."""
    return _build(18, block_type, kwargs)


def resnet34(block_type: Optional[Type] = None, **kwargs) -> ResNet:
    """ResNet-34."""
    return _build(34, block_type, kwargs)


def resnet50(block_type: Optional[Type] = None, **kwargs) -> ResNet:
    """ResNet-50."""
    return _build(50, block_type, kwargs)
