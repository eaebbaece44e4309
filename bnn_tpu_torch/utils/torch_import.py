"""Import reference (PyTorch) checkpoints into port models (counterpart of
``bnn_tpu/utils/torch_import.py``).

The reference trains with torch and checkpoints ``{'state_dict': ...,
'optimizer': ..., 'epoch': ..., 'best_acc1': ...}`` with ``torch.save``. The
port's modules carry the reference's names and layouts (``conv1.weight``
OIHW, BatchNorm ``running_mean``, ``activation_post_process.alpha`` as
``[1, C, 1, 1]``), so the mapping is by name; only the guards of the JAX
importer remain:

- a file is read with ``torch.load(..., weights_only=True)``: arbitrary
  globals are refused, and so are malformed files and tensors that are
  broadcast or overlapping views of their storage
  (``pickle.UnpicklingError`` for each);
- a name-matched tensor of another shape is reported in ``missing`` with
  both shapes, never reshaped, except a broadcast-shaped ``alpha`` or a
  1-D target of the same values (``(C,)`` against ``[1, C, 1, 1]``);
- ``num_batches_tracked`` is dropped, and DDP's ``module.`` prefix
  stripped.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List, Tuple, Union

import numpy as np
import torch
from torch import nn

__all__ = ["load_torch_file", "torch_to_state_dict", "import_torch_checkpoint"]

# torch leaves with no counterpart to fill, dropped silently
_TORCH_ONLY_LEAVES = {"num_batches_tracked"}
# port leaves that no reference checkpoint holds
_PORT_ONLY_LEAVES = {"num_batches_tracked", "_extra_state"}


def _check_views(obj, path: str = "") -> None:
    """Refuse tensors that read a storage element more than once (a
    zero-stride broadcast, or a view larger than its storage): checkpointed
    tensors are never such views, and copying one would materialise it."""
    if isinstance(obj, torch.Tensor):
        size, stride = obj.shape, obj.stride()
        if any(st == 0 and n > 1 for n, st in zip(size, stride)):
            raise pickle.UnpicklingError(
                f"{path}: zero stride over a dimension of size > 1: "
                f"size={tuple(size)} stride={stride}")
        room = (obj.untyped_storage().nbytes() // max(obj.element_size(), 1)
                - obj.storage_offset())
        if obj.numel() > room:
            raise pickle.UnpicklingError(
                f"{path}: a tensor of {obj.numel()} elements over {room} "
                "elements of storage")
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _check_views(v, f"{path}.{k}" if path else str(k))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _check_views(v, f"{path}.{i}" if path else str(i))


def load_torch_file(path: str) -> Any:
    """Load a ``torch.save`` file onto the CPU with
    ``torch.load(..., weights_only=True)``. A file that is refused or
    malformed raises ``pickle.UnpicklingError`` (a truncated zip
    ``zipfile.BadZipFile`` or ``EOFError``)."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except FileNotFoundError:
        raise
    except (RuntimeError, TypeError, AttributeError, KeyError, ValueError,
            IndexError, OSError) as e:
        raise pickle.UnpicklingError(
            f"{path}: not a loadable torch checkpoint: {e}") from e
    _check_views(obj)
    return obj


def torch_to_state_dict(obj: Union[str, Dict]) -> Dict[str, torch.Tensor]:
    """A checkpoint path or payload as a flat ``state_dict`` of tensors.
    Accepts the reference's wrapper (``{'state_dict': ...}``) or a bare
    state_dict, and strips DDP's ``module.`` prefix."""
    if isinstance(obj, (str, os.PathLike)):
        obj = load_torch_file(os.fspath(obj))
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if not isinstance(obj, dict):
        raise TypeError(f"expected a state_dict, got {type(obj)}")
    out = {}
    for k, v in obj.items():
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    return out


def _fit(t: torch.Tensor, leaf: str, target_shape) -> torch.Tensor | None:
    """``t`` in the target's shape, or None where it does not fit."""
    target_shape = tuple(target_shape)
    if tuple(t.shape) == target_shape:
        return t
    # only a broadcast-shaped alpha (or a 1-D target) is reshaped: a
    # size-matched kernel of another shape ((3, 1) against (1, 3)) would be
    # scrambled, so it is reported instead
    squeezable = tuple(d for d in t.shape if d != 1) == tuple(
        d for d in target_shape if d != 1)
    if squeezable and (len(target_shape) <= 1 or leaf == "alpha"):
        return t.reshape(target_shape)
    return None


def import_torch_checkpoint(model: nn.Module, src: Union[str, Dict],
                            strict: bool = True) -> Tuple[List[str], List[str]]:
    """Load a reference torch checkpoint's tensors into ``model`` in place.

    Returns ``(missing, unexpected)``: ``missing`` the model's entries with
    no usable tensor (no key of that name, or a shape that does not fit,
    annotated with both shapes); ``unexpected`` the checkpoint's keys that
    matched nothing. A name-matched tensor of the wrong shape is only in
    ``missing``. ``strict=True`` raises ``ValueError`` if either list is
    non-empty; nothing is written then."""
    sd = torch_to_state_dict(src)
    targets = {k: v for k, v in model.state_dict().items()
               if k.rsplit(".", 1)[-1] not in _PORT_ONLY_LEAVES}
    missing, values, used = [], {}, set()
    for key, cur in targets.items():
        if key not in sd:
            missing.append(key)
            continue
        used.add(key)
        got = _fit(sd[key], key.rsplit(".", 1)[-1], cur.shape)
        if got is None:
            missing.append(f"{key} [shape: torch {tuple(sd[key].shape)} vs "
                           f"{tuple(cur.shape)}]")
            continue
        values[key] = got
    unexpected = [k for k in sd if k not in used
                  and k.rsplit(".", 1)[-1] not in _TORCH_ONLY_LEAVES]
    if strict and (missing or unexpected):
        raise ValueError(f"torch import mismatch: missing={missing[:5]} "
                         f"unexpected={unexpected[:5]}")
    with torch.no_grad():
        for key, t in values.items():
            targets[key].copy_(t.to(targets[key].dtype))
    return missing, unexpected
