"""Checkpoint save and restore (counterpart of ``bnn_tpu/utils/checkpoint.py``).

A checkpoint is a directory holding one ``torch.save`` payload,
``{"model": state_dict, "opt_state": optimizer state_dict, "metadata": {...}}``
(the last two only when given). The payload holds tensors and plain Python
types only, so :func:`load_checkpoint` reads it with ``weights_only=True``;
a stochastic binarizer's generator states travel in its ``_extra_state``, so
a resumed run goes on drawing where it stopped.

The format is the port's own, not Orbax's: a JAX checkpoint reaches the port
through :func:`bnn_tpu_torch.utils.load_jax_state` on its arrays.

Restoring follows the JAX package's rules: restored values take the
destination's dtype (a bf16 model stays bf16), and ``strict=False`` moves
only the entries whose name and shape match and returns the skipped names.
"""
from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional

import torch
from torch import nn

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "restore_into",
    "optimizer_state_dict",
    "restore_optimizer",
    "gather_replicated",
]

PAYLOAD = "checkpoint.pt"


def gather_replicated(tree):
    """Multi-host gathering of sharded state before a save. The port has no
    multi-device state yet: it waits for ``torch.distributed`` parallelism
    (ROADMAP queue 1, item 5)."""
    raise NotImplementedError(
        "gather_replicated is multi-host; the port's parallelism "
        "(ROADMAP queue 1, item 5) is not ported yet")


def optimizer_state_dict(optimizer: torch.optim.Optimizer) -> Dict:
    """The optimizer's moments, step counts and hyperparameters, the
    counterpart of the reference saving ``optimizer.state_dict()``."""
    return optimizer.state_dict()


def save_checkpoint(path: str, model: nn.Module, opt_state: Any = None,
                    metadata: Optional[Dict] = None, is_best: bool = False,
                    best_path: Optional[str] = None) -> None:
    """Save ``model``'s state (and ``opt_state``, a live optimizer or its
    ``state_dict``, and ``metadata``) into the directory ``path``. The
    payload is written under a temporary name and moved into place, so a
    reader never sees half a file. ``is_best=True`` also copies the
    directory to ``best_path`` (default ``path + '.best'``)."""
    path = os.path.abspath(path)
    payload = {"model": model.state_dict()}
    if opt_state is not None:
        if isinstance(opt_state, torch.optim.Optimizer):
            opt_state = optimizer_state_dict(opt_state)
        payload["opt_state"] = opt_state
    if metadata:
        payload["metadata"] = dict(metadata)
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, PAYLOAD)
    tmp = f"{final}.{os.getpid()}.tmp"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    if is_best:
        best = os.path.abspath(best_path or path + ".best")
        if os.path.exists(best):
            shutil.rmtree(best)
        shutil.copytree(path, best)


def load_checkpoint(path: str) -> Dict:
    """The payload dict of the checkpoint directory ``path``, on the CPU."""
    return torch.load(os.path.join(os.path.abspath(path), PAYLOAD),
                      map_location="cpu", weights_only=True)


def _fits(new, cur) -> bool:
    if isinstance(new, torch.Tensor) and isinstance(cur, torch.Tensor):
        return new.shape == cur.shape
    return not isinstance(new, torch.Tensor) and not isinstance(cur, torch.Tensor)


def restore_into(model: nn.Module, payload: Dict, strict: bool = True) -> List[str]:
    """Restore a payload's model state into ``model``; each value is copied
    into the destination tensor, so it takes that tensor's dtype and device.

    ``strict=True`` raises on a missing or unexpected entry or a shape
    mismatch (``load_state_dict``'s ``RuntimeError``) and returns ``[]``.
    ``strict=False`` restores only the entries whose name and shape match
    (the reference's mismatched-keys fallback) and returns the names of the
    model's entries it left as they were."""
    saved = payload["model"]
    if strict:
        model.load_state_dict(saved, strict=True)
        return []
    current = model.state_dict()
    matched = {k: v for k, v in saved.items()
               if k in current and _fits(v, current[k])}
    model.load_state_dict(matched, strict=False)
    return [k for k in current if k not in matched]


def restore_optimizer(optimizer: torch.optim.Optimizer, payload: Dict,
                      strict: bool = True) -> List[str]:
    """Restore a checkpoint's ``opt_state`` into a live optimizer: its
    moments and step counts, so a resumed run continues the saved
    trajectory. The hyperparameters (``lr``, betas, ``weight_decay``, flags)
    stay the live optimizer's, as in the JAX package, where an optax
    transform keeps them in its closure: a *different* base LR passed at
    resume time re-parameterizes the run while the step counts keep its
    position. Raises ``KeyError`` when the checkpoint has no optimizer
    state. A parameter's saved state fits when each of its tensors (the
    step count aside) has the parameter's shape; the parameters are named
    ``state.<i>`` in ``state_dict`` order. ``strict=True`` raises
    ``ValueError`` unless every saved state fits and the groups hold as many
    parameters as the saved ones; ``strict=False`` restores what fits, keeps
    the optimizer's own state elsewhere and returns the names it kept."""
    saved = payload.get("opt_state")
    if saved is None:
        raise KeyError("checkpoint has no 'opt_state' "
                       "(saved with save_checkpoint(..., opt_state=None)?)")
    current = optimizer.state_dict()
    groups, saved_groups = current["param_groups"], saved["param_groups"]
    if [len(g["params"]) for g in groups] != [len(g["params"]) for g in saved_groups]:
        skipped = [f"state.{i}" for g in groups for i in g["params"]]
        if strict:
            raise ValueError("optimizer state mismatch: the saved groups hold "
                             f"{[len(g['params']) for g in saved_groups]} "
                             "parameters, the optimizer's "
                             f"{[len(g['params']) for g in groups]}")
        return skipped
    params = [p for g in optimizer.param_groups for p in g["params"]]
    ids = zip(params, (i for g in saved_groups for i in g["params"]),
              (i for g in groups for i in g["params"]))
    state, skipped = {}, []
    for p, sid, cid in ids:
        moments = saved["state"].get(sid)
        if moments is not None and not all(
                v.shape == p.shape for v in moments.values()
                if isinstance(v, torch.Tensor) and v.ndim > 0):
            skipped.append(f"state.{cid}")
            moments = current["state"].get(cid)
        if moments is not None:
            state[cid] = moments
    if strict and skipped:
        raise ValueError(f"optimizer state mismatch on {skipped[:5]}"
                         f"{'...' if len(skipped) > 5 else ''}")
    optimizer.load_state_dict({"state": state, "param_groups": groups})
    return skipped
