"""Model precision casting (counterpart of ``bnn_tpu/utils/precision.py``)."""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["cast_floats", "promote_call"]


def cast_floats(obj: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Cast every floating-point parameter and buffer of ``obj`` to ``dtype``,
    in place. Integer state (packed and int8 weights) is untouched, which is
    what ``nn.Module.to(dtype)`` does."""
    return obj.to(dtype)


def promote_call(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``module(x)`` under ``jnp``'s type promotion: where x and the float
    state of ``module`` (a leaf layer: its own parameters decide) differ in
    type, as when an f32 activation reaches a layer cast to bf16, both are
    widened to the promoted type for the call, as the JAX package's layers
    compute. bf16 -> f32 is exact. ``F.prelu`` and ``F.linear`` refuse mixed
    types, so without this an f32 ``pallas-conv`` output would stop a bf16
    model. The common case, one type, costs a dictionary lookup. A module
    with buffers in training mode is called as it is: widened copies of its
    buffers would take a BatchNorm's running-statistics updates."""
    p = next(iter(module._parameters.values()), None)
    if (p is None or p.dtype == x.dtype or not p.is_floating_point()
            or not x.is_floating_point() or (module.training and module._buffers)):
        return module(x)
    dtype = torch.promote_types(p.dtype, x.dtype)
    state = {k: v.to(dtype) for k, v in module.state_dict(keep_vars=True).items()
             if v.is_floating_point()}
    return torch.func.functional_call(module, state, (x.to(dtype),))
