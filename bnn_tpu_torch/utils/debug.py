"""Numerical debugging (counterpart of ``bnn_tpu/utils/debug.py``).

- :func:`debug_nans`: a block in which the first op whose floating output
  holds a NaN raises ``FloatingPointError`` naming the op (a
  ``TorchDispatchMode``, so it sees every op, the kernels' operators
  included);
- :func:`checkify_errors`: a function wrapped to raise on NaN or inf
  produced anywhere inside it;
- :func:`assert_finite`: a walk over tensors, modules, dicts and lists,
  raising ``ValueError`` that names every non-finite leaf, for step
  boundaries (an exploding alpha in a QAT loop).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["debug_nans", "checkify_errors", "assert_finite"]

_CHECKS = {"nan": torch.isnan, "inf": torch.isinf}


class _FloatChecks(TorchDispatchMode):
    """Raise ``FloatingPointError`` at the first op whose floating output
    holds a value of one of ``errors`` ('nan', 'inf')."""

    def __init__(self, errors: Iterable[str]):
        super().__init__()
        unknown = set(errors) - set(_CHECKS)
        if unknown:
            raise ValueError(f"unknown float checks {sorted(unknown)}; "
                             f"expected some of {sorted(_CHECKS)}")
        self.errors = tuple(errors)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and t.device.type != "meta":
                for name in self.errors:
                    if bool(_CHECKS[name](t).any()):
                        raise FloatingPointError(
                            f"{name} in the output of {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """``with debug_nans(): step(...)`` raises ``FloatingPointError`` at the
    first op that produces a NaN, naming it. Every op's output is read back,
    so the block runs slowly."""
    if not enable:
        yield
        return
    with _FloatChecks(("nan",)):
        yield


def checkify_errors(fn: Callable, *, errors=("nan", "inf")) -> Callable:
    """``fn`` wrapped so that a NaN or inf (``errors``) produced by any op
    inside it raises ``FloatingPointError`` naming the op."""
    mode_errors = tuple(errors)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _FloatChecks(mode_errors):
            return fn(*args, **kwargs)

    return wrapper


def _walk(tree, path: str):
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{path}.{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}.{i}" if path else str(i))
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def assert_finite(tree, name: str = "tree") -> None:
    """Raise ``ValueError`` naming the dotted path of every floating tensor
    in ``tree`` (tensors, modules by their ``state_dict``, dicts, lists)
    that holds a non-finite value. Reads the values back: use it at step
    boundaries."""
    bad = [path for path, t in _walk(tree, "")
           if t.is_floating_point() and not bool(torch.isfinite(t).all())]
    if bad:
        raise ValueError(f"non-finite values in {name}: {bad}")
