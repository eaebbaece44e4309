"""A profiled slice of the traffic under ``torch.profiler``, and what the
per-layer readers take from it: kernel intervals, host operations, the
union of busy time and the breakdown of device operations and idle gaps."""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import torch

SLICE = "portbench.slice"
# the namespace of the port's operators on the host's timeline
PORT_OPS = "bnn_tpu_torch::"
# the profiler's own bookkeeping on the host's timeline
PROFILER_HOST_EVENTS = ("Activity Buffer Request",)
NAME_CHARS = 160

# the port's own hand kernels (the __global__ functions of its csrc/*.cu), as
# the profiler names them; frozen here so that a reader's meaning does not move
PORT_KERNELS = ("binary_gemm", "fused_stem", "fused_chain", "fused_basic_block",
                "fused_downsample_block", "fused_bottleneck", "fused_stem_chain",
                "binary_conv2d_s1", "popcount_gemm", "binary_conv2d")
_PORT = re.compile(r"\b(" + "|".join(PORT_KERNELS) + r")_kernel\b")
# convolution and matrix-product kernels (cuDNN, cuBLAS, CUTLASS, the port's
# GEMMs); layout transposes around them are not
_MATMUL = re.compile(r"gemm|xmma|cutlass|conv|wgrad|dgrad|fprop|gmma|hmma|implicit|"
                     r"_int_mm|mma_", re.I)
_NOT_MATMUL = re.compile(r"nchwToNhwc|nhwcToNchw|transpose", re.I)


def port_kernel(name: str) -> Optional[str]:
    """The port's kernel a device event belongs to, or None."""
    m = _PORT.search(name)
    return m.group(1) if m else None


def is_matmul(name: str) -> bool:
    return bool(_MATMUL.search(name)) and not _NOT_MATMUL.search(name)


@dataclass
class Trace:
    kernels: List[Tuple[str, float, float]]      # (name, start_us, end_us)
    host: List[Tuple[str, float, float]]         # host operations, same clock
    start_us: float
    end_us: float
    units: int                                   # requests or steps inside
    slices: int                                  # traces taken
    whole: bool                                  # every kernel a whole number per period
    # one unit's operator calls: (name, input shapes)
    calls: List[Tuple[str, list]] = field(default_factory=list)

    @property
    def wall_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        out, end = [], -math.inf
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            s, e = max(s, self.start_us), min(e, self.end_us)
            if e <= s:
                continue
            if s > end:
                out.append([s, e])
                end = e
            elif e > end:
                out[-1][1] = e
                end = e
        return [tuple(i) for i in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def kernel_s(self, pick: Callable[[str], bool]) -> Tuple[float, int]:
        """Summed device seconds and count of the kernels ``pick`` accepts."""
        sel = [e - s for n, s, e in self.kernels if pick(n)]
        return sum(sel) / 1e6, len(sel)

    def gaps(self) -> List[Tuple[float, float]]:
        cur, out = self.start_us, []
        for s, e in self.busy_intervals():
            if s > cur:
                out.append((cur, s))
            cur = max(cur, e)
        if self.end_us > cur:
            out.append((cur, self.end_us))
        return out

    def host_at(self, t: float) -> str:
        """The innermost host operation running at ``t``."""
        best = None
        for n, s, e in self.host:
            if s <= t <= e and n != SLICE and (best is None or s >= best[1]):
                best = (n, s)
        return best[0] if best else "host idle"

    def breakdown(self) -> dict:
        by = {}
        for n, s, e in self.kernels:
            by[n] = by.get(n, 0.0) + (e - s) / 1e6
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:10]
        return {"device_ops": [[n[:NAME_CHARS], v] for n, v in ops],
                "idle_gaps": [[self.host_at((s + e) / 2)[:NAME_CHARS], (e - s) / 1e6]
                              for s, e in gaps]}


def _whole(kernels, units: int) -> bool:
    counts = {}
    for n, _, _ in kernels:
        counts[n] = counts.get(n, 0) + 1
    return bool(counts) and all(c % units == 0 for c in counts.values())


def op_calls(run_unit: Callable[[], object]) -> List[Tuple[str, list]]:
    """The port's operators that ``run_unit()`` calls, with their input
    shapes, from a profile of the host alone (recording shapes slows the
    host, so the timed slice does not)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        run_unit()
    return [(e.name[len(PORT_OPS):], list(e.input_shapes or [])) for e in prof.events()
            if e.name.startswith(PORT_OPS)]


def profile_slice(run_units: Callable[[], object], units: int, periods: int = 0,
                  attempts: int = 3, run_unit: Optional[Callable[[], object]] = None) -> Trace:
    """Trace ``run_units()`` (``units`` requests or steps, ending on a
    synchronize) under ``torch.profiler``. The traffic repeats itself
    ``periods`` times in the slice (by default once a unit). A trace with no
    kernel events, or with a kernel whose events are not a whole number per
    period (CUPTI now and then drops events), is taken again, up to
    ``attempts`` times; the last one is kept with ``whole=False`` if none
    was whole. With ``run_unit``, one more unit after the slice gives the
    port's operator calls a unit makes, with their input shapes (``calls``,
    :func:`op_calls`), from which the rooflines count each call's work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    trace = None
    for attempt in range(1, attempts + 1):
        with profile(activities=activities) as prof:
            with record_function(SLICE):
                run_units()
                if card:
                    torch.cuda.synchronize()
        kernels, host, span = [], [], None
        for e in prof.events():
            item = (e.name, float(e.time_range.start), float(e.time_range.end))
            if e.name == SLICE:
                # the range's copy on the device's timeline is no device work
                if e.device_type != DeviceType.CUDA:
                    span = item
            elif e.device_type == DeviceType.CUDA:
                kernels.append(item)
            elif e.name not in PROFILER_HOST_EVENTS:
                host.append(item)
        if span is None:
            continue
        trace = Trace(kernels, host, span[1], span[2], units, attempt,
                      _whole(kernels, periods or units))
        if trace.whole:
            break
    if trace is None:
        raise RuntimeError(f"torch.profiler returned no slice in {attempts} traces")
    if run_unit is not None:
        trace.calls = op_calls(run_unit)
    return trace
