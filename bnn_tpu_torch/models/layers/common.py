"""Shared builders for the model zoo (counterpart of
``bnn_tpu/models/layers/common.py``)."""
from __future__ import annotations

from torch import nn


def _square_conv(ksize: int):
    """Factory for the zoo's two bias-free square convs. The 3x3 variant
    pads by the dilation ('same' at stride 1); the 1x1 variant never pads."""

    def build(in_planes: int, out_planes: int, stride: int = 1,
              groups: int = 1, dilation: int = 1) -> nn.Conv2d:
        return nn.Conv2d(
            in_planes, out_planes,
            kernel_size=ksize,
            stride=stride,
            padding=dilation if ksize > 1 else 0,
            dilation=dilation if ksize > 1 else 1,
            groups=groups,
            bias=False,
        )

    build.__name__ = f"conv{ksize}x{ksize}"
    return build


conv3x3 = _square_conv(3)
conv1x1 = _square_conv(1)


def make_activation(activation, num_parameters: int) -> nn.Module:
    """ReLU takes no channel count; PReLU-likes get ``num_parameters``."""
    if activation is nn.ReLU or activation is None:
        return nn.ReLU()
    return activation(num_parameters=num_parameters)
