"""Carry QAT weights from a ``bnn_tpu`` model into its port.

The JAX package names modules as torch does (``layer1.0.conv1``,
``downsample.1``), so only the leaves differ: HWIO / WIO / ``(I, O)``
kernels become OIHW / OIW / ``(O, I)`` weights, BatchNorm
``scale/bias/mean/var`` become ``weight/bias/running_mean/running_var``,
and a ``(C,)`` ``BasicScaleBinarizer.alpha`` takes the port's
``[1, C, 1, ...]`` shape. This module imports no JAX: it takes plain
numpy arrays.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["jax_to_port", "load_jax_state"]

# JAX leaf name -> port leaf name
_LEAF = {
    "kernel": "weight",
    "scale": "weight",          # BatchNorm gamma
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
    "alpha": "alpha",           # BasicScaleBinarizer
    "weight": "weight",         # PReLU slope
    "w_q": "w_q",               # inference.compress, in JAX's layout
    "w_scale": "w_scale",
}
# port leaves with no JAX counterpart (a stochastic binarizer's generator
# states are not JAX's nnx.Rngs)
_PORT_ONLY = ("num_batches_tracked", "_extra_state")
# kernel rank -> permutation from the JAX layout to torch's
_KERNEL_PERM = {4: (3, 2, 0, 1), 3: (2, 1, 0), 2: (1, 0)}


def _to_port(arr: np.ndarray, leaf: str, shape) -> torch.Tensor:
    t = torch.as_tensor(np.array(arr))
    if leaf == "kernel" and t.ndim in _KERNEL_PERM:
        t = t.permute(_KERNEL_PERM[t.ndim])
    elif leaf == "alpha" and t.numel() == int(np.prod(shape)):
        t = t.reshape(shape)
    return t


def _targets(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in model.state_dict().items()
            if k.rsplit(".", 1)[-1] not in _PORT_ONLY}


def jax_to_port(model: nn.Module, flat: Mapping[str, np.ndarray]
                ) -> Dict[str, torch.Tensor]:
    """``{port state_dict key: tensor in the port's layout}`` of ``flat``,
    ``{dotted JAX path: array}``, which may hold a subset of the model's
    leaves (the gradients of its parameters, say). Raises ``ValueError`` on
    an unexpected key or a shape mismatch."""
    targets = _targets(model)
    values: Dict[str, torch.Tensor] = {}
    unexpected, mismatched = [], []
    for jkey, arr in flat.items():
        prefix, _, leaf = jkey.rpartition(".")
        port_leaf = _LEAF.get(leaf)
        key = f"{prefix}.{port_leaf}" if prefix else port_leaf
        if port_leaf is None or key not in targets or key in values:
            unexpected.append(jkey)
            continue
        t = _to_port(arr, leaf, tuple(targets[key].shape))
        if tuple(t.shape) != tuple(targets[key].shape):
            mismatched.append(f"{jkey}: {tuple(np.shape(arr))} -> {key} "
                              f"{tuple(targets[key].shape)}")
            continue
        values[key] = t
    if unexpected or mismatched:
        raise ValueError(f"JAX state does not match the model: "
                         f"unexpected={unexpected[:5]} "
                         f"shape mismatch={mismatched[:5]}")
    return values


def load_jax_state(model: nn.Module, flat: Mapping[str, np.ndarray]) -> None:
    """Fill ``model`` in place from ``flat``, ``{dotted JAX path: array}``
    (for example ``nnx.to_flat_state(nnx.state(jax_model))`` with the path
    tuples joined by dots). Raises ``ValueError`` on a missing key, an
    unexpected key or a shape mismatch; nothing is written then."""
    targets = _targets(model)
    values = jax_to_port(model, flat)
    missing = sorted(set(targets) - set(values))
    if missing:
        raise ValueError(f"JAX state does not match the model: "
                         f"missing={missing[:5]}")
    with torch.no_grad():
        for key, t in values.items():
            targets[key].copy_(t.to(targets[key].dtype))
