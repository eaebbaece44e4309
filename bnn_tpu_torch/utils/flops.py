"""FLOPs / BOPs counting for (binarized) models (counterpart of
``bnn_tpu/utils/flops.py``).

Convs and linears whose inputs AND weights are binarized, and deployed
layers, count as BOPs (binary ops); every other conv and linear as FLOPs.
The XNOR-Net cost model prices a BOP at 1/64 of a FLOP; both raw counts and
the discounted total are reported.

Counting is shape-only: forward hooks on a deep copy of the model in eval
mode, run on the ``meta`` device, so nothing is computed and no class is
patched.
"""
from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch
from torch import nn

__all__ = ["count_ops", "OpCount"]


def _layer_types() -> tuple:
    """(conv types, linear types); the binary layers subclass torch's, so
    these cover both. Imported here: the package imports ``utils`` before
    its layers exist."""
    from ..inference.deploy import DeployedConv, DeployedLinear

    return (nn.Conv1d, nn.Conv2d, DeployedConv), (nn.Linear, DeployedLinear)


@dataclass
class OpCount:
    flops: int = 0
    bops: int = 0
    per_layer: Dict[str, Tuple[str, int]] = field(default_factory=dict)

    @property
    def effective_flops(self) -> float:
        """BOPs discounted 64x (the XNOR-Net convention)."""
        return self.flops + self.bops / 64.0

    def __repr__(self) -> str:
        return (f"OpCount(flops={self.flops:,}, bops={self.bops:,}, "
                f"effective={self.effective_flops:,.0f})")


def _is_binary(m: nn.Module) -> bool:
    from .. import layers as blayers
    from ..inference.deploy import DeployedConv, DeployedLinear
    from ..ops.binarizers import Identity

    if isinstance(m, (DeployedConv, DeployedLinear)):
        return True
    if isinstance(m, (blayers.Linear, blayers.Conv1d, blayers.Conv2d)):
        return (not isinstance(m.activation_pre_process, Identity)
                and not isinstance(m.weight_pre_process, Identity))
    return False


def _capture_shapes(model: nn.Module, input_shape) -> Dict[str, tuple]:
    """``{name: (input shape, output shape)}`` of every conv and linear, from
    one eval-mode forward of a meta-device copy."""
    clone = copy.deepcopy(model).eval().to("meta")
    captured: Dict[str, tuple] = {}
    hooks = []
    convs, linears = _layer_types()
    for name, m in clone.named_modules():
        if isinstance(m, convs + linears):
            hooks.append(m.register_forward_hook(
                lambda mod, args, out, name=name: captured.__setitem__(
                    name, (tuple(args[0].shape), tuple(out.shape)))))
    dtype = next((p.dtype for p in model.parameters()
                  if p.is_floating_point()), torch.float32)
    try:
        with torch.no_grad():
            clone(torch.empty(tuple(input_shape), device="meta", dtype=dtype))
    finally:
        for h in hooks:
            h.remove()
    return captured


def count_ops(model: nn.Module, input_shape: Tuple[int, ...]) -> OpCount:
    """Count the ops (2 * MACs) of one forward at ``input_shape`` (NCHW).
    Binary layers (sign inputs and sign weights, or deployed layers) are
    BOPs; everything else FLOPs. ``per_layer`` maps each layer's name to
    ``(kind, ops)``."""
    shapes = _capture_shapes(model, input_shape)
    convs, _ = _layer_types()
    counts = OpCount()
    for name, m in model.named_modules():
        if name not in shapes:
            continue
        in_shape, out_shape = shapes[name]
        if isinstance(m, convs):
            ksz = math.prod(m.kernel_size)
            in_ch = m.in_channels // m.groups
            macs = (out_shape[0] * math.prod(out_shape[2:]) * m.out_channels
                    * ksz * in_ch)
        else:
            macs = math.prod(in_shape[:-1]) * m.in_features * m.out_features
        ops = 2 * macs
        kind = "bops" if _is_binary(m) else "flops"
        counts.per_layer[name] = (kind, ops)
        if kind == "bops":
            counts.bops += ops
        else:
            counts.flops += ops
    return counts
