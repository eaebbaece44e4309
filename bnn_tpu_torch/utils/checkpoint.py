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
    """Every sharded tensor of ``tree`` made whole, on every rank: a
    collective that every rank calls (the ranks of the axes a tensor is
    split over take part in its gather).

    ``tree``: a module placed by ``parallel.shard_model`` (its
    ``state_dict`` with each tensor-parallel shard gathered), an optimizer
    (its ``state_dict`` with each moment whole: ZeRO-1 shards over ``data``,
    tensor-parallel ones over ``model``), a tensor a ``parallel`` function
    recorded a spec on (a pipeline's flat row, a stacked stage state), or
    tuples, lists and dicts of these. Anything else comes back as it is.
    Then rank 0 saves; :func:`save_checkpoint` does both for a placed model.
    """
    from ..parallel.mesh import (gather_optimizer_state, gather_tensor,
                                 layout_of, placement_of)

    if isinstance(tree, torch.optim.Optimizer):
        return gather_optimizer_state(tree)
    if isinstance(tree, nn.Module):
        state = tree.state_dict()
        placement = placement_of(tree)
        if placement is not None:
            for k, spec in placement.sharded().items():
                state[k] = gather_tensor(state[k], spec, placement.mesh)
        return state
    if isinstance(tree, torch.Tensor):
        layout = layout_of(tree)
        return tree if layout is None else gather_tensor(tree.detach(), layout[1], layout[0])
    if isinstance(tree, (tuple, list)):
        return type(tree)(gather_replicated(v) for v in tree)
    if isinstance(tree, dict):
        return {k: gather_replicated(v) for k, v in tree.items()}
    return tree


def _placed(obj):
    """The mesh ``obj`` is placed on, or None."""
    from ..parallel.mesh import mesh_of

    return None if obj is None else mesh_of(obj)


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
    directory to ``best_path`` (default ``path + '.best'``).

    A model or optimizer placed on a mesh (``parallel.shard_model``,
    ``shard_optimizer_zero1``) makes this a collective, as in the JAX
    package: EVERY rank calls it, the shards are gathered whole
    (:func:`gather_replicated`), rank 0 alone writes, and every rank
    returns only after the checkpoint (and its ``.best`` copy) is in place,
    so any rank may read it next. A failed write raises on every rank."""
    path = os.path.abspath(path)
    mesh = _placed(model) or _placed(opt_state)
    if mesh is None:
        payload = {"model": model.state_dict()}
        if opt_state is not None:
            if isinstance(opt_state, torch.optim.Optimizer):
                opt_state = optimizer_state_dict(opt_state)
            payload["opt_state"] = opt_state
        _write(path, payload, metadata, is_best, best_path)
        return
    payload = {"model": gather_replicated(model)}
    if opt_state is not None:
        payload["opt_state"] = gather_replicated(opt_state)
    written = torch.zeros((), device=mesh.device)
    error = None
    if torch.distributed.get_rank() == 0:
        try:
            _write(path, payload, metadata, is_best, best_path)
            written.fill_(1)
        except Exception as e:  # raised below, after the other ranks hear of it
            error = e
    torch.distributed.broadcast(written, 0)
    if error is not None:
        raise error
    if not written.item():
        raise RuntimeError(f"rank 0 failed to write the checkpoint {path}")


def _write(path, payload, metadata, is_best, best_path) -> None:
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
    model's entries it left as they were. A model placed on a mesh takes
    each whole saved tensor's shard."""
    from ..parallel.mesh import localize_state_dict

    saved = localize_state_dict(model, payload["model"])
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
    from ..parallel.mesh import localize_optimizer_state, optimizer_whole_shapes

    # a parameter's whole shape: a ZeRO-1 or tensor-parallel shard's moments
    # are saved whole and cut again below
    wholes = optimizer_whole_shapes(optimizer)
    ids = zip(wholes, (i for g in saved_groups for i in g["params"]),
              (i for g in groups for i in g["params"]))
    state, skipped = {}, []
    for whole, sid, cid in ids:
        moments = saved["state"].get(sid)
        if moments is not None and not all(
                tuple(v.shape) == tuple(whole) for v in moments.values()
                if isinstance(v, torch.Tensor) and v.ndim > 0):
            skipped.append(f"state.{cid}")
            moments = current["state"].get(cid)
        if moments is not None:
            state[cid] = moments
    if strict and skipped:
        raise ValueError(f"optimizer state mismatch on {skipped[:5]}"
                         f"{'...' if len(skipped) > 5 else ''}")
    optimizer.load_state_dict({"state": state, "param_groups": groups})
    localize_optimizer_state(optimizer)
    return skipped
