"""Where the port's built libraries live (counterpart of
``bnn_tpu/utils/cache.py``).

The CUDA kernels (``nvcc``, minutes for a full build) and the native host
libraries (``g++ -march=native``) are built at first use into one build
directory. :func:`enable_compilation_cache` points it at a directory keyed by
a fingerprint of the machine: the host CPU's features (a ``-march=native``
library may not run on another CPU) and the card's name and compute
capability, so a directory shared between machines never hands one the
other's libraries.
"""
from __future__ import annotations

import hashlib
import os
from pathlib import Path

import torch

from ..kernels import _build

__all__ = ["enable_compilation_cache"]


def _machine_tag() -> str:
    """The host CPU's fingerprint (``kernels._build.host_tag``) with the
    card's name and compute capability."""
    props = torch.cuda.get_device_properties(0)
    feats = (f"{_build.host_tag()} {props.name} "
             f"sm_{props.major}{props.minor}")
    return hashlib.sha1(feats.encode()).hexdigest()[:10]


def enable_compilation_cache(path: str | None = None) -> str:
    """Build and load the port's libraries under ``path/<machine tag>``
    (``path`` defaults to ``bnn_tpu_torch/_build``) from now on, and return
    that directory; libraries already loaded stay loaded. Returns ``""``
    and changes nothing where no CUDA device is present (the kernels cannot
    run there)."""
    if not torch.cuda.is_available():
        return ""
    base = Path(path) if path else _build.CSRC.parent / "_build"
    target = base / _machine_tag()
    os.makedirs(target, exist_ok=True)
    return str(_build.set_build_dir(target))
