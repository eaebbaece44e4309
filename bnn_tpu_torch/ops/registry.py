"""Binarizer registry: explicit string -> class resolution (counterpart of
``bnn_tpu/ops/registry.py``)."""
from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register(cls: Callable = None, *, name: str = None, aliases: tuple = ()):
    """Register a binarizer class under its name (and optional aliases).

    Usable as ``@register``, ``@register(name=...)`` or ``register(MyClass)``.
    """

    def _do(c):
        _REGISTRY[name or c.__name__] = c
        for alias in aliases:
            _REGISTRY[alias] = c
        return c

    if cls is None:
        return _do
    return _do(cls)


def resolve(name: str) -> Callable:
    """Look up a registered binarizer class by name."""
    if name not in _REGISTRY:
        known = ", ".join(sorted(_REGISTRY))
        raise KeyError(
            f"Unknown binarizer {name!r}. Registered binarizers: {known}. "
            f"Register custom binarizers with bnn_tpu_torch.ops.register."
        )
    return _REGISTRY[name]


def registered_names() -> tuple:
    return tuple(sorted(_REGISTRY))
