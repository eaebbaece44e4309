"""One run of one cell of the port's benchmark on the card it is started on.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is ``workloads/<cell>.json``: its configuration
(``configs/<name>.json``) and its traffic mix (``traffic/<mix>.json``),
whose ``kind`` names the generator (``traffic/<kind>.py``). With
``--trace 0`` the last line of standard output holds the cell's end-to-end
metrics; with ``--trace 1`` the per-layer metrics, each read by
``metrics/<metric>.py`` (a reader that finds nothing to read returns None
and its metric is left out), with the device's busy and traced seconds and
a breakdown of the profiled slice. Each run checks what its timed path
produced against the plain reference (``reference/``) and prints each
number compared beside its limit, last on standard error and under
``checks``, the line's last key.

Without a CUDA device, or with fewer than the cell's chips, the run exits
2 and prints no result: it never falls back to the CPU. It exits 3 if
JAX, flax or the JAX package was loaded by the time the result is ready
(in this process, or in rank 0 of a cell on several chips), and 1 if a
rank of such a cell failed.
"""
from __future__ import annotations

import time

_CLOCK0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
METRICS = Path(__file__).resolve().parent / "metrics"
FORBIDDEN = ("jax", "jaxlib", "flax", "bnn_tpu")
CACHE = CHECKOUT / ".portbench_cache"
# the host threads of torch's CPU operators (the serving call's cast of its
# input) unless the traffic mix names its ``threads``: few, so that a run's
# host work spreads less with what else the machine's cores are doing; a
# mix whose requests are tens of MB to cast takes more
HOST_THREADS = 2


def process_age_s() -> float:
    """Seconds since this process started (``/proc/self/stat``), or 0."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return max(0.0, time.clock_gettime(time.CLOCK_BOOTTIME) - started)
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE0 = process_age_s()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def readers() -> dict:
    """``{metric name: module}`` of every reader under ``metrics/``."""
    out = {}
    for path in sorted(METRICS.glob("*.py")):
        spec = importlib.util.spec_from_file_location(
            "portbench.metrics." + path.stem.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[path.stem] = mod
    return out


def listed(cell: str, section: str):
    """The names of ``BENCHMARK.json``'s ``section`` metrics that ``cell``
    reports (a metric without ``workloads`` in every cell), or None where
    the file is not beside the harness or names no such cell."""
    path = CHECKOUT / "BENCHMARK.json"
    if not path.is_file():
        return None
    bench = json.loads(path.read_text())
    if cell not in {w["name"] for w in bench.get("workloads", [])}:
        return None
    return {m["name"] for m in bench[section] if cell in m.get("workloads", [cell])}


def loaded_forbidden() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


def _merge(base: dict, extra: dict) -> dict:
    for k, v in extra.items():
        base[k] = _merge(dict(base.get(k, {})), v) if isinstance(v, dict) else v
    return base


def _host(cell: dict) -> None:
    import torch

    torch.set_num_threads(cell["mix"].get("threads", HOST_THREADS))


def measure(args, cell: dict, device, rank: int = 0, world: int = 1,
            clock0: float = _CLOCK0, age0: float = _AGE0):
    """The cell's traffic on ``device``; returns the result line (without
    the check of loaded modules) and the lines for standard error."""
    import torch

    from .core import Context

    kind = importlib.import_module(f"portbench.traffic.{cell['mix']['kind']}")
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace), device, clock0, age0,
                  rank, world)
    rec = kind.run(ctx)

    metrics = {}
    if args.trace:
        for name, mod in readers().items():
            value = mod.read(rec)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": mod.UNIT}
    else:
        metrics = {k: {"value": float(v), "unit": u} for k, (v, u) in rec.end_to_end.items()}
    # the line holds what BENCHMARK.json lists for the cell, where it lists it
    keep = listed(cell["name"], "per_layer" if args.trace else "end_to_end")
    if keep is not None:
        metrics = {k: v for k, v in metrics.items() if k in keep}
    on_card = device.type == "cuda"
    result = {
        "correct": rec.correct, "attempted": rec.attempted, "failed": rec.failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else device.type,
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": rec.memory_peak_bytes},
        "card": card_line() if on_card else "cpu",
    }
    if args.trace and rec.trace is not None:
        result["device"]["busy_s"] = rec.trace.busy_s()
        result["device"]["window_s"] = rec.trace.wall_s
        result["breakdown"] = rec.trace.breakdown()
        result["slices"] = {"taken": rec.trace.slices, "whole": rec.trace.whole,
                            "units": rec.trace.units}
    # a number that could not be read (NaN) is printed as null, and is not correct
    result["checks"] = {k: {"value": v if math.isfinite(v) else None, "limit": lim}
                        for k, (v, lim) in rec.checks.items()}
    lines = list(rec.notes) + [f"check {k} {v!r} limit {lim!r}"
                               for k, (v, lim) in rec.checks.items()]
    return result, lines


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(rank: int, args, cell: dict, device_type: str, world: int, port: int,
          clock0: float, age0: float, queue) -> None:
    """One rank of a cell on several chips: the process group over
    ``localhost``, the traffic on this rank's device; rank 0 hands back the
    result, what it prints, and what it loaded that a run may not."""
    import torch
    import torch.distributed as dist

    _host(cell)
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device(device_type)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        out = measure(args, cell, device, rank, world, clock0, age0)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        queue.put((*out, loaded_forbidden()))


def launch(args, cell: dict, device_type: str):
    """Start the cell's ``chips`` ranks, one process a chip, and wait for
    every one of them; returns rank 0's result, lines and loaded modules,
    or None where a rank failed."""
    import torch.multiprocessing as mp

    spawn = mp.get_context("spawn")
    queue = spawn.SimpleQueue()
    world, port = cell["chips"], _free_port()
    procs = [spawn.Process(target=_rank, args=(r, args, cell, device_type, world, port,
                                               _CLOCK0, _AGE0, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    got = None
    while got is None and any(p.is_alive() for p in procs):
        if not queue.empty():
            got = queue.get()
        else:
            time.sleep(0.05)
    if got is None and not queue.empty():
        got = queue.get()
    for p in procs:
        p.join()
    if any(p.exitcode != 0 for p in procs):
        print("rank exit codes: " + ", ".join(str(p.exitcode) for p in procs),
              file=sys.stderr)
        return None
    return got


def main(argv=None, *, device=None, overrides=None) -> int:
    """One run; returns the exit code. ``device`` and ``overrides`` (merged
    into the cell) are for the tests, which drive a run on the CPU at a
    small size; the command line never sets them. A cell on more than one
    chip runs as that many ranks, one process each (:func:`launch`); its
    traffic kind gathers what the ranks measured into rank 0's record."""
    args = parse_args(argv)
    # the program's kernel caches stay inside the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    import torch

    from .core import load_cell

    cell = _merge(load_cell(args.workload), overrides or {})
    _host(cell)
    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark measures the card and does not "
                  "fall back to the CPU", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell["chips"]:
            print(f"{cell['name']} needs {cell['chips']} cards, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    if cell["chips"] > 1:
        got = launch(args, cell, device.type)
        if got is None:
            return 1
        result, lines, found = got
    else:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        result, lines = measure(args, cell, device)
        found = []

    found = sorted(set(found) | set(loaded_forbidden()))
    if found:
        print(f"loaded in this process: {', '.join(found)}; the benchmark runs "
              "without JAX and without the JAX package", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
