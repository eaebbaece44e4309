"""The architecture of a configuration file, in plain Python: the benchmark's
own reading of the published network, shared by the weights it makes, the
plain reference and the roofline arithmetic. Nothing here imports torch or
the measured program.

A configuration's ``arch`` (the ``bnn_tpu_torch.models`` constructor the
program builds) picks its family: the module under ``families/`` whose
``ARCHS`` holds it. Adding an architecture adds files only: a family, its
reference (``reference/<REFERENCE>.py``, see
:mod:`portbench.reference.common`), a configuration and a workload. A
family defines

- ``ARCHS``, ``REFERENCE`` and ``INITS`` (init rules beyond those of
  :mod:`portbench.weights`: ``{name: (draw, transform)}``);
- ``conv_layers(config)``: every conv and dense layer in forward order, as
  dicts with ``name``, ``kind`` (``binary`` or ``float``), ``cin``,
  ``cout``, ``k``, ``stride``, ``pad``, ``h_in``, ``h_out``, ``stage`` and
  ``macs`` (per image);
- ``state_spec(config)``: ``(name, shape, init)`` of every tensor of the QAT
  model's state, in a fixed order; ``fan_in(spec_by_name, name)``;
- for the serving check, ``published_name(name)``, ``watched_names(config)``
  and ``serve_pairs(ref, low, q, requests)``; for the training check,
  ``train_watched(config)`` and ``train_layer(f, layer, h)``;
- optionally ``blocks(config)`` and ``fused_blocks(config, kernel)`` (the
  blocks a fused kernel computes in one call, for its roofline).
"""
from __future__ import annotations

import functools
import importlib
import json
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent
FAMILIES = ROOT / "families"


def load_config(name: str) -> dict:
    """``configs/<name>.json``."""
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


@functools.lru_cache(maxsize=None)
def _families() -> dict:
    """``{arch: family module}`` over every module under ``families/``."""
    out = {}
    for path in sorted(FAMILIES.glob("*.py")):
        if path.stem.startswith("_"):
            continue
        mod = importlib.import_module(f"portbench.families.{path.stem}")
        for a in mod.ARCHS:
            if a in out:
                raise ValueError(f"arch {a!r} is in families {out[a].__name__} "
                                 f"and {mod.__name__}")
            out[a] = mod
    return out


def family(config: dict):
    """The family module of ``config["arch"]``."""
    try:
        return _families()[config["arch"]]
    except KeyError:
        raise KeyError(f"no module under portbench/families/ has arch "
                       f"{config['arch']!r} in its ARCHS") from None


def reference(config: dict):
    """The plain reference module of the configuration's family."""
    return importlib.import_module(f"portbench.reference.{family(config).REFERENCE}")


def blocks(config: dict):
    return family(config).blocks(config)


def conv_layers(config: dict) -> List[dict]:
    return family(config).conv_layers(config)


def state_spec(config: dict) -> List[tuple]:
    return family(config).state_spec(config)


def fan_in(config: dict, spec_by_name: Dict[str, tuple], name: str) -> int:
    return family(config).fan_in(spec_by_name, name)


def fused_blocks(config: dict, kernel: str) -> Optional[list]:
    """``(layers, first, last)`` of each block ``kernel`` computes in one
    call; None where the family has no such blocks."""
    fused = getattr(family(config), "fused_blocks", None)
    return None if fused is None else fused(config, kernel)
