"""Tensor-parallel serving: packed weights split over the mesh's model axis
(counterpart of ``bnn_tpu/inference/tp.py``).

Each rank holds 1/P of every eligible deployed layer's packed weights (an
out-channel shard of ``w_packed`` with the matching ``scale`` / ``add``
slices), runs the layer on its shard and gathers the full output channels
over the ``model`` axis: dimension 1 of a conv's NCHW output, the last of a
dense layer's (JAX gathers its NHWC outputs on the last axis). Weights are
never whole on any rank. On the card the shard runs the layer's own kernel
(``binary_gemm`` at N / P in the GEMM modes).
"""
from __future__ import annotations

import logging
from typing import Dict, List

from torch import nn

from ..parallel.mesh import (Mesh, Spec, _assign, _leaves, _tag, out_channel_axis,
                             slice_tensor)
from .deploy import DeployedConv, DeployedLinear

__all__ = ["tag_tensor_parallel", "tp_state_specs", "shard_tp_state"]

logger = logging.getLogger(__name__)

# leaves holding a deployed layer's per-out-channel arrays
_TP_LEAVES = ("w_packed", "scale", "add")


def _tp_skip_reason(m, n: int) -> str:
    """'' when shardable over n ranks, else why the layer stays replicated."""
    if isinstance(m, DeployedLinear):
        return ("" if m.out_features % n == 0
                else f"out_features {m.out_features} % {n} != 0")
    if isinstance(m, DeployedConv):
        # grouped convs would need group-aligned shards of both operands
        if m.groups != 1:
            return f"grouped conv (groups={m.groups})"
        return ("" if m.out_channels % n == 0
                else f"out_channels {m.out_channels} % {n} != 0")
    return "not a deployed binary layer"


def tag_tensor_parallel(model: nn.Module, mesh: Mesh, axis: str = "model") -> List[str]:
    """Mark eligible deployed layers for sharded serving; returns their
    names. A tagged layer treats its ``w_packed`` / ``scale`` / ``add`` as
    its out-channel shard and gathers its output over ``axis``. Layers whose
    out-channels do not divide the axis, and grouped convs, stay replicated,
    each skip logged."""
    n = mesh.size(axis)
    tagged, skipped = [], []
    for name, m in model.named_modules():
        if not isinstance(m, (DeployedConv, DeployedLinear)):
            continue
        reason = _tp_skip_reason(m, n)
        if not reason:
            m.tp_axis, m.tp_mesh = axis, mesh
            tagged.append(name)
        else:
            skipped.append((name, reason))
            logger.warning("tensor-parallel serving: layer %r stays REPLICATED (%s)",
                           name, reason)
    logger.info("tensor-parallel serving: sharded %d/%d deployed layers over "
                "%d-way %r axis", len(tagged), len(tagged) + len(skipped), n, axis)
    return tagged


def tp_state_specs(model: nn.Module, axis: str = "model") -> Dict[str, Spec]:
    """``{state_dict name: Spec}`` after tagging: a tagged layer's
    ``w_packed`` / ``scale`` / ``add`` split their out-channel axis over
    ``axis`` (packed K words stay whole), everything else replicated."""
    return {name: (Spec(*([None] * out_channel_axis(m, t) + [axis]))
                   if getattr(m, "tp_axis", None) == axis and leaf in _TP_LEAVES
                   else Spec())
            for name, m, leaf, t in _leaves(model)}


def shard_tp_state(model: nn.Module, specs: Dict[str, Spec], mesh: Mesh) -> nn.Module:
    """Cut the model's tensors to this rank's shards per ``specs`` and move
    the model to the mesh's device, in place; each shard carries its spec."""
    model.to(mesh.device)
    state = dict(model.state_dict(keep_vars=True))
    sharded = {k: s for k, s in specs.items() if s.names()}
    _assign(model, {k: slice_tensor(state[k].detach(), s, mesh)
                    for k, s in sharded.items()})
    state = dict(model.state_dict(keep_vars=True))
    for k, s in sharded.items():
        _tag(state[k], mesh, s)
    return model
