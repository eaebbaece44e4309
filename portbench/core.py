"""What a run hands between its parts: the cell as read from its files, and
the record a traffic kind fills for the readers and the result line."""
from __future__ import annotations

import gc
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import arch
from .trace import Trace

ROOT = Path(__file__).resolve().parent


def load_cell(name: str) -> dict:
    """``workloads/<name>.json`` with its configuration and traffic mix read
    in: ``{"name", "config": {...}, "mix": {...}, "chips", "limits"}``."""
    path = ROOT / "workloads" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"unknown workload {name!r}: no {path.relative_to(ROOT.parent)}")
    cell = json.loads(path.read_text())
    cell["name"] = name
    cell["config"] = arch.load_config(cell["config"])
    cell["mix"] = json.loads((ROOT / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell


@dataclass
class Context:
    cell: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    clock0: float            # perf_counter() at the run's start
    age0: float              # the process's age at clock0, in seconds
    rank: int = 0            # this process's rank in a cell on several chips
    world: int = 1           # the cell's chips, one process each

    @property
    def config(self) -> dict:
        return self.cell["config"]

    @property
    def mix(self) -> dict:
        return self.cell["mix"]

    def setup_s(self) -> float:
        """Seconds from the process's start until now."""
        return self.age0 + time.perf_counter() - self.clock0

    def ready(self) -> float:
        """Close the set-up: what it made is collected and moved out of the
        collector's sight (``gc.freeze``), so that the window's collections
        walk only what the window makes; returns :meth:`setup_s`."""
        self.sync()
        gc.collect()
        gc.freeze()
        return self.setup_s()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclass
class Record:
    """What a traffic kind measured. ``window`` holds ``seconds`` (the
    window's length), ``units`` (requests or steps completed), ``images``
    and, for serving, ``call_s`` (host seconds inside each
    ``Predictor.__call__``) and ``latency_s``."""
    kind: str
    config: dict
    mix: dict
    batch: int
    attempted: int = 0
    failed: int = 0
    end_to_end: Dict[str, tuple] = field(default_factory=dict)   # name -> (value, unit)
    window: dict = field(default_factory=dict)
    trace: Optional[Trace] = None
    checks: Dict[str, tuple] = field(default_factory=dict)       # name -> (value, limit)
    memory_peak_bytes: int = 0
    notes: List[str] = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return (self.failed == 0 and bool(self.checks)
                and all(v <= lim for v, lim in self.checks.values()))
