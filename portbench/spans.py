"""The program's spans in a profiled slice, and what the span readers take
from them: a span's host milliseconds a unit, and the share of the device's
idle time that lies inside a span.

The program records each span as a plain host event (no user annotation),
only while a profiler runs, so a span puts nothing on the device's timeline
and sits on the same clock as the kernels. The names are frozen here, as
``trace.PORT_KERNELS`` freezes the kernels', so that a reader's meaning does
not move. A trace with no event of a span's name (a program that records no
spans) gives None, never 0."""
from __future__ import annotations

from typing import List, Optional, Tuple

# one serving call (``Predictor`` or ``ExportedServer``): the request's cast
# and copy to the device, then the padded batches through the served model
SERVE_CALL = "bnn.serve.call"
SERVE_COPY_IN = "bnn.serve.copy_in"
SERVE_FORWARD = "bnn.serve.forward"
# one ``make_train_step`` step: a forward (the loss) and a backward per
# microbatch, then the optimizer's step
TRAIN_STEP = "bnn.train.step"
TRAIN_FORWARD = "bnn.train.forward"
TRAIN_BACKWARD = "bnn.train.backward"
TRAIN_OPTIMIZER = "bnn.train.optimizer"
SPANS = (SERVE_CALL, SERVE_COPY_IN, SERVE_FORWARD,
         TRAIN_STEP, TRAIN_FORWARD, TRAIN_BACKWARD, TRAIN_OPTIMIZER)


def _intervals(rec, name: str) -> List[Tuple[float, float]]:
    if rec.trace is None:
        return []
    return [(s, e) for n, s, e in rec.trace.host if n == name]


def _union(intervals) -> List[Tuple[float, float]]:
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(i) for i in out]


def span_ms(rec, name: str) -> Optional[float]:
    """Summed host milliseconds of the ``name`` spans in the profiled
    slice, over its units (requests or steps)."""
    spans = _intervals(rec, name)
    if not spans:
        return None
    return sum(e - s for s, e in spans) / 1e3 / rec.trace.units


def idle_in_pct(rec, name: str) -> Optional[float]:
    """The share, in percent, of the slice's idle time (its gaps between
    kernels, ``Trace.gaps``) that lies inside the union of the ``name``
    spans: each gap split exactly by its overlap with them."""
    spans = _union(_intervals(rec, name))
    if not spans:
        return None
    gaps = rec.trace.gaps()
    idle = sum(e - s for s, e in gaps)
    if idle <= 0:
        return None
    inside, j = 0.0, 0
    for gs, ge in gaps:
        # spans wholly before this gap are before every later gap too
        while j < len(spans) and spans[j][1] <= gs:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < ge:
            inside += min(ge, spans[k][1]) - max(gs, spans[k][0])
            k += 1
    return 100 * inside / idle
