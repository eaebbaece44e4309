"""Model precision casting (counterpart of ``bnn_tpu/utils/precision.py``)."""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["cast_float_tree", "cast_floats", "promote_call"]


def cast_float_tree(tree, dtype):
    """Cast the floating tensors of a nest of dicts, lists and tuples to
    ``dtype``; everything else (int8 and packed weights, counters) passes
    through. The one copy of the mixed-precision cast rule, also used at
    every step of ``make_train_step(compute_dtype=...)``."""
    if isinstance(tree, dict):
        return {k: cast_float_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_float_tree(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def cast_floats(obj: nn.Module, dtype=torch.bfloat16, *,
                keep_batch_stats: bool = False) -> nn.Module:
    """Cast every floating-point parameter and buffer of ``obj`` to ``dtype``,
    in place. Integer state (packed and int8 weights, counters) is untouched,
    which is what ``nn.Module.to(dtype)`` does.

    ``keep_batch_stats=True`` leaves the BatchNorm running statistics in
    their dtype, as a model cast for low-precision *training* needs: the
    statistics are accumulated in f32, as the masters and the optimizer's
    moments are. The norm layers' outputs still come out in ``dtype``, the
    dtype of their inputs. Serving casts never update statistics and keep
    the default."""
    kept = {}
    if keep_batch_stats:
        kept = {(m, k): m._buffers[k] for m in obj.modules()
                if isinstance(m, nn.modules.batchnorm._BatchNorm)
                for k in ("running_mean", "running_var")
                if m._buffers.get(k) is not None}
    obj.to(dtype)
    for (m, k), buf in kept.items():
        m._buffers[k] = buf
    return obj


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
