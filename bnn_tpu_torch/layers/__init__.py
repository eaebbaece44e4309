"""Binary (quantization-aware) layers (counterpart of ``bnn_tpu/layers``).

Binary ``Linear``/``Conv1d``/``Conv2d`` subclass the torch layers and hold a
:class:`~bnn_tpu_torch.bconfig.BConfig`; the forward contract is

    ``post(op(pre(x), weight_pre(W)) + bias, x)``

``from_module`` adopts the float module's ``weight``/``bias`` Parameters by
reference, so weights stay shared across progressive recipe steps.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..bconfig import BConfig
from ..utils.padding import conv_nd
from .helpers import copy_parameters

__all__ = ["Linear", "Conv1d", "Conv2d", "BinaryLinear", "BinaryConv1d",
           "BinaryConv2d"]


def _attach_binarizers(layer: nn.Module, bconfig: BConfig) -> None:
    if bconfig is None:
        raise ValueError("bconfig is required for a binarized module")
    layer.bconfig = bconfig
    layer.activation_pre_process = bconfig.activation_pre_process()
    layer.activation_post_process = bconfig.activation_post_process(layer)
    layer.weight_pre_process = bconfig.weight_pre_process()


def _adopt(mod: nn.Module, bconfig, update: bool, new: nn.Module):
    new.weight = mod.weight  # shared Parameter, not a copy
    new.bias = mod.bias
    if update:
        copy_parameters(mod, new, bconfig)
    return new


def _check_source(cls, mod: nn.Module, bconfig):
    if type(mod) not in (cls._FLOAT_MODULE, cls):
        raise TypeError(f"{cls.__name__}.from_module only works for "
                        f"{cls._FLOAT_MODULE.__name__} / {cls.__name__}, "
                        f"got {type(mod).__name__}")
    if bconfig is None:
        bconfig = getattr(mod, "bconfig", None)
        if bconfig is None:
            raise ValueError("The input module requires a predefined bconfig")
    return bconfig


class Linear(nn.Linear):
    """Binarized dense layer."""

    _FLOAT_MODULE = nn.Linear

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 *, bconfig: BConfig = None, device=None, dtype=None):
        super().__init__(in_features, out_features, bias, device=device,
                         dtype=dtype)
        _attach_binarizers(self, bconfig)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xq = self.activation_pre_process(x)
        w = self.weight_pre_process(self.weight)
        return self.activation_post_process(F.linear(xq, w, self.bias), x)

    @classmethod
    def from_module(cls, mod: nn.Module, bconfig: BConfig = None,
                    update: bool = False) -> "Linear":
        bconfig = _check_source(cls, mod, bconfig)
        new = cls(mod.in_features, mod.out_features, bias=mod.bias is not None,
                  bconfig=bconfig, device=mod.weight.device)
        return _adopt(mod, bconfig, update, new)


def _strided_same(padding, stride) -> bool:
    """``padding='same'`` at a stride torch's conv layers refuse it at."""
    st = (stride,) if isinstance(stride, int) else tuple(stride)
    return padding == "same" and any(s != 1 for s in st)


class _BinaryConvNd:
    """Mixin: the binary conv forward and ``from_module`` adoption.
    ``padding='same'`` is taken at any stride, as ``lax`` resolves it
    (:mod:`bnn_tpu_torch.utils.padding`)."""

    def _init_conv(self, base, *args, padding, stride, **kwargs):
        # torch refuses 'same' at stride > 1: build with 0 and keep 'same'
        strided = _strided_same(padding, stride)
        base.__init__(self, *args, stride=stride,
                      padding=0 if strided else padding, **kwargs)
        if strided:
            self.padding = "same"

    def _conv_forward(self, x, weight, bias):
        if _strided_same(self.padding, self.stride):
            return conv_nd(x, weight, bias, self.stride, "same", self.dilation,
                           self.groups)
        return super()._conv_forward(x, weight, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xq = self.activation_pre_process(x)
        w = self.weight_pre_process(self.weight)
        return self.activation_post_process(
            self._conv_forward(xq, w, self.bias), x)

    @classmethod
    def from_module(cls, mod: nn.Module, bconfig: BConfig = None,
                    update: bool = False):
        bconfig = _check_source(cls, mod, bconfig)
        new = cls(mod.in_channels, mod.out_channels, mod.kernel_size,
                  stride=mod.stride, padding=mod.padding,
                  dilation=mod.dilation, groups=mod.groups,
                  bias=mod.bias is not None, bconfig=bconfig,
                  device=mod.weight.device)
        return _adopt(mod, bconfig, update, new)


class Conv1d(_BinaryConvNd, nn.Conv1d):
    """Binarized 1-D convolution."""

    _FLOAT_MODULE = nn.Conv1d

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, bias=True, *,
                 bconfig: BConfig = None, device=None, dtype=None):
        self._init_conv(nn.Conv1d, in_channels, out_channels, kernel_size,
                        stride=stride, padding=padding, dilation=dilation,
                        groups=groups, bias=bias, device=device, dtype=dtype)
        _attach_binarizers(self, bconfig)


class Conv2d(_BinaryConvNd, nn.Conv2d):
    """Binarized 2-D convolution."""

    _FLOAT_MODULE = nn.Conv2d

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, bias=True, *,
                 bconfig: BConfig = None, device=None, dtype=None):
        self._init_conv(nn.Conv2d, in_channels, out_channels, kernel_size,
                        stride=stride, padding=padding, dilation=dilation,
                        groups=groups, bias=bias, device=device, dtype=dtype)
        _attach_binarizers(self, bconfig)


BinaryLinear = Linear
BinaryConv1d = Conv1d
BinaryConv2d = Conv2d
