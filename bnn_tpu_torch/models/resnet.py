"""BNN-adapted ResNet family (counterpart of ``bnn_tpu/models/resnet.py``).

BNN-specific deltas from a vanilla ResNet: a pluggable ``block_type`` and
``activation``, ``stem_type='basic' | 'dabnn'`` (the DaBNN stem), and an
AvgPool -> 1x1 conv -> BN shortcut on strided stages. Attribute names
(``conv1``, ``layer1..4``, ``downsample.1`` ...) match the reference, so
recipes and checkpoints address layers by the same paths.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Type

import torch
from torch import nn

from ..nn import BatchNorm2d, MaxPool2d
from ..utils.precision import promote_call
from .layers import BasicBlock, Bottleneck, conv1x1
from .layers.common import make_activation

_STAGE_WIDTHS = (64, 128, 256, 512)
_STEM_WIDTH = 64


def _cba(cin: int, cout: int, k: int, stride: int, norm: Callable,
         activation) -> nn.Sequential:
    """conv(k x k, no bias) -> norm -> activation."""
    return nn.Sequential(
        nn.Conv2d(cin, cout, kernel_size=k, stride=stride, padding=k // 2,
                  bias=False),
        norm(cout),
        make_activation(activation, cout),
    )


class DaBNNStem(nn.Module):
    """DaBNN efficient stem: a stride-2 3x3 trunk feeding a 1x1-squeeze /
    3x3-stride-2 conv branch and a maxpool branch, whose concatenation a
    1x1 conv mixes. It downsamples by 4, as conv7x7/s2 + maxpool does."""

    def __init__(self, planes: int, norm_layer: Optional[Callable] = None,
                 activation=nn.ReLU):
        super().__init__()
        norm = BatchNorm2d if norm_layer is None else norm_layer
        half, quarter = planes // 2, planes // 4
        self.conv1 = _cba(3, half, 3, 2, norm, activation)
        self.conv2_1 = _cba(half, quarter, 1, 1, norm, activation)
        self.conv2_2 = _cba(quarter, half, 3, 2, norm, activation)
        self.conv3 = _cba(planes, planes, 1, 1, norm, activation)
        self.maxpool = MaxPool2d(kernel_size=3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        trunk = self.conv1(x)
        conv_path = self.conv2_2(self.conv2_1(trunk))
        return self.conv3(torch.cat([conv_path, self.maxpool(trunk)], dim=1))


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
        self.stem_type = stem_type
        if stem_type == "basic":
            self.conv1 = nn.Conv2d(3, _STEM_WIDTH, kernel_size=7, stride=2,
                                   padding=3, bias=False)
            self.bn1 = norm(_STEM_WIDTH)
        elif stem_type == "dabnn":
            # the requested activation reaches the stem too, as in the JAX
            # package (the reference hard-codes ReLU there)
            self.conv1 = DaBNNStem(_STEM_WIDTH, norm_layer=norm,
                                   activation=activation)
        else:
            raise ValueError(f"Unknown stem_type {stem_type!r}")
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
        x = self.conv1(x)
        if self.stem_type == "basic":
            x = self.maxpool(self.relu(self.bn1(x)))
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
