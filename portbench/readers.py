"""Helpers the per-layer readers under ``metrics/`` share."""
from __future__ import annotations

from .roofline import KERNEL_BOUNDS
from .trace import port_kernel


def roofline_pct(rec, kernel: str):
    """Sum of the least times of ``kernel``'s calls in the profiled slice
    (a unit's calls, :data:`portbench.roofline.KERNEL_BOUNDS` each from the
    configuration's layer that the call's input shapes name, times the
    slice's units) over the sum of their device times, in percent. None
    where a unit makes no such call, a call that no layer of the
    configuration explains, or device events that are not a whole number
    per call (CUPTI dropped some)."""
    if rec.trace is None:
        return None
    bound = KERNEL_BOUNDS[kernel]
    shapes = [sh for name, sh in rec.trace.calls if name == kernel]
    if not shapes:
        return None
    bounds = [bound(rec.config, sh, rec.batch) for sh in shapes]
    seconds, count = rec.trace.kernel_s(lambda n: port_kernel(n) == kernel)
    calls = len(shapes) * rec.trace.units
    if None in bounds or count == 0 or count % calls or seconds <= 0:
        return None
    return 100 * sum(bounds) * rec.trace.units / seconds


def idle_pct(rec, kind: str):
    if rec.kind != kind or rec.trace is None or not rec.trace.kernels:
        return None
    return 100 * (1 - rec.trace.busy_s() / rec.trace.wall_s)
