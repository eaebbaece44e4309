"""Weight-only int8 / int4 storage for the float remainder of a deployed
model (counterpart of ``bnn_tpu/inference/compress.py``).

Deployment packs every binary layer to 1 bit a weight; what is left in float
is the first conv and the classifier head, and a binary ResNet-18's fc alone
is 1 MB in bf16. :func:`quantize_float_layers` stores such layers as int8
(per out-channel symmetric scales) or packed int4 (scales per group of
``group`` input rows) and dequantises to the input's dtype on every forward,
as the JAX package does in its graph: a few elementwise ops on a tensor that
is small beside the activations.

``w_q`` and ``w_scale`` are stored in the JAX package's layout, so a
quantized JAX model carries across by ``load_jax_state`` and the int4 groups
are JAX's: the weight is a ``(K, O)`` matrix with K in JAX's order
(``(kh, kw, ci)`` for a conv, ``ci`` for a linear layer); ``w_q`` is
``(K, O)`` reshaped to the JAX kernel's shape, or ``(K/g, g, O)`` with a
group (``(K/g, g/2, O)`` with int4 nibbles packed along ``g``), ``w_scale``
``(O,)`` or ``(K/g, O)``. Only the dequantised weight takes torch's layout.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..binarize import set_module_by_name
from ..utils.padding import conv_nd

__all__ = [
    "QuantizedConv",
    "QuantizedLinear",
    "quantize_float_layers",
    "state_bytes",
]

# the JAX kernel layout <-> torch's: (I, O) <-> (O, I); (kw, ci, co) <->
# (co, ci, kw); (kh, kw, ci, co) <-> (co, ci, kh, kw)
_TO_JAX = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}
_TO_TORCH = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}


def _quantize(w: torch.Tensor, bits: int, group: Optional[int]):
    """Symmetric quantization of ``w`` (JAX layout, out-channels last) over
    all but its last axis: ``(q, scale)`` with ``q`` int8 in ``[-qmax, qmax]``
    and ``w ~= q * scale``; ``scale`` is ``(O,)``, or ``(K/group, O)`` per
    block of ``group`` rows of the ``(K, O)`` matrix (zero-padded to a
    multiple of ``group``)."""
    qmax = float(2 ** (bits - 1) - 1)
    out_ch = w.shape[-1]
    w2d = w.reshape(-1, out_ch)
    if group is None:
        scale = torch.clamp(w2d.abs().amax(0) / qmax, min=1e-12)
        q = torch.clamp(torch.round(w2d / scale), -qmax, qmax).to(torch.int8)
        return q.reshape(w.shape), scale.float()
    pad = (-w2d.shape[0]) % group
    wg = F.pad(w2d, (0, 0, 0, pad)).reshape(-1, group, out_ch)
    scale = torch.clamp(wg.abs().amax(1) / qmax, min=1e-12)
    q = torch.clamp(torch.round(wg / scale[:, None, :]), -qmax, qmax)
    return q.to(torch.int8), scale.float()


def _pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values (int8 storage, range [-7, 7]) two to a byte along
    the second-to-last axis (which must be even): element ``2i`` in the low
    nibble, ``2i + 1`` in the high one."""
    lo = q[..., 0::2, :].to(torch.int16) & 0xF
    hi = q[..., 1::2, :].to(torch.int16) & 0xF
    byte = lo | (hi << 4)
    return torch.where(byte > 127, byte - 256, byte).to(torch.int8)


def _unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_pack_int4` (each nibble sign-extended)."""
    p = p.to(torch.int16)
    lo = ((p & 0xF) ^ 0x8) - 0x8
    hi = (((p >> 4) & 0xF) ^ 0x8) - 0x8
    out = torch.stack([lo, hi], dim=-2)  # (..., G/2, 2, O)
    shape = p.shape[:-2] + (2 * p.shape[-2],) + p.shape[-1:]
    return out.reshape(shape).to(torch.int8)


class _QuantizedBase(nn.Module):
    """Shared int8 / int4 weight storage and dequantisation."""

    def _store(self, layer: nn.Module, bits: int, group: Optional[int]) -> None:
        if bits not in (8, 4):
            raise ValueError(f"bits must be 8 or 4, got {bits}")
        if bits == 4 and group is None:
            group = 64
        if bits == 4 and group % 2:
            raise ValueError(
                f"int4 packing pairs values along the in-group axis; "
                f"group must be even, got {group}")
        self.bits = bits
        self.group = group
        with torch.no_grad():
            w = layer.weight.detach().permute(_TO_JAX[layer.weight.ndim])
            self.k_shape = tuple(w.shape)
            q, scale = _quantize(w, bits, group)
            if bits == 4:
                q = _pack_int4(q)  # (K/g, g, O): nibbles along g
            self.register_buffer("w_q", q.contiguous())
            self.register_buffer("w_scale", scale.contiguous())
            self.register_buffer("bias", None if layer.bias is None
                                 else layer.bias.detach().clone())

    def _dequant(self, dtype) -> torch.Tensor:
        """The weight in ``dtype`` and torch's layout."""
        q = _unpack_int4(self.w_q) if self.bits == 4 else self.w_q
        if self.group is not None:
            w = q.to(dtype) * self.w_scale[:, None, :].to(dtype)
            k = 1
            for d in self.k_shape[:-1]:
                k *= d
            w = w.reshape(-1, self.k_shape[-1])[:k]  # drop the group padding
        else:
            w = q.to(dtype) * self.w_scale.to(dtype)
        return w.reshape(self.k_shape).permute(_TO_TORCH[len(self.k_shape)])

    def _bias(self, dtype):
        return None if self.bias is None else self.bias.to(dtype)


class QuantizedLinear(_QuantizedBase):
    """Weight-only int8 / int4 dense layer, in place of a float ``nn.Linear``."""

    def __init__(self, layer: nn.Linear, *, bits: int = 8,
                 group: Optional[int] = None):
        super().__init__()
        self.in_features = layer.in_features
        self.out_features = layer.out_features
        self._store(layer, bits, group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self._dequant(x.dtype), self._bias(x.dtype))


class QuantizedConv(_QuantizedBase):
    """Weight-only int8 / int4 convolution, in place of a float
    ``nn.Conv1d`` / ``nn.Conv2d``."""

    def __init__(self, layer: nn.modules.conv._ConvNd, *, bits: int = 8,
                 group: Optional[int] = None):
        super().__init__()
        self.in_channels = layer.in_channels
        self.out_channels = layer.out_channels
        self.kernel_size = layer.kernel_size
        self.stride = layer.stride
        self.padding = layer.padding
        self.dilation = layer.dilation
        self.groups = layer.groups
        self._store(layer, bits, group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nd(x, self._dequant(x.dtype), self._bias(x.dtype),
                       self.stride, self.padding, self.dilation, self.groups)


def quantize_float_layers(model: nn.Module, *, bits: int = 8,
                          group: Optional[int] = None,
                          min_params: int = 2 ** 14,
                          skip: tuple = ()) -> nn.Module:
    """Replace the plain float ``nn.Linear`` / ``nn.Conv1d`` / ``nn.Conv2d``
    layers of ``model`` that hold at least ``min_params`` weight entries by
    their quantized versions, in place. The test is on the exact type: the
    binary layers, which subclass torch's, and the deployed ones stay as
    they are. The default keeps a ResNet stem (9,408 entries) in float, as
    its output feeds sign activations, and takes the fc (512,000). ``skip``
    leaves further layers by name. Returns the model, or the replacement
    when the model itself is one such layer."""
    replacements = {}
    for name, m in model.named_modules():
        if name in skip:
            continue
        if type(m) is nn.Linear and m.weight.numel() >= min_params:
            replacements[name] = QuantizedLinear(m, bits=bits, group=group)
        elif type(m) in (nn.Conv1d, nn.Conv2d) and m.weight.numel() >= min_params:
            replacements[name] = QuantizedConv(m, bits=bits, group=group)
    if "" in replacements:
        return replacements[""]
    for name, new in replacements.items():
        set_module_by_name(model, name, new)
    return model


def state_bytes(model: nn.Module) -> int:
    """Bytes of every tensor in the model's state (weights, scales, norm
    statistics): the whole-model number for compression reports."""
    return sum(t.numel() * t.element_size() for t in model.state_dict().values()
               if isinstance(t, torch.Tensor))
