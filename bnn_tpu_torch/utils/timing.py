"""Device time of a call (counterpart of ``bnn_tpu/utils/timing.py``).

:func:`loop_time` runs ``fn`` back to back, each call's output fed back into
the next call's input scaled by a zero epsilon held on the device, so that
every call depends on the one before. Two run lengths are timed and their
difference divided by the difference in calls, so the cost of starting and
ending a run cancels. On the card the runs are timed by CUDA events, each
queued behind a device sleep long enough for the host to have issued the
whole run first: the events then see the kernels back to back, not the
host's launch rate. On the CPU the host clock times them.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

__all__ = ["loop_time"]

# the device sleep's cycles per second of host issue time it must cover;
# more than any H100 clock, so the sleep outlasts the issue
_SLEEP_CYCLES_PER_S = 2.5e9


def loop_time(fn: Callable, x: torch.Tensor, *args, iters: int = 100,
              rounds: int = 1) -> float:
    """Seconds per execution of ``fn(x, *args)`` on ``x``'s device.

    ``fn`` takes ``x`` (a float tensor) first; its output may have any shape
    and dtype. The sum of each output times a zero epsilon is added to ``x``
    before the next call. Each run length is timed ``rounds + 1`` times,
    interleaved, and the minimum of each taken. The first run, which may
    build or autotune, is never timed."""
    eps = torch.zeros((), dtype=x.dtype, device=x.device)

    def run(n):
        carry = x
        for _ in range(n):
            y = fn(carry, *args)
            carry = carry + y.sum().to(carry.dtype) * eps
        return carry

    n1 = max(iters // 5, 1)
    n2 = n1 + iters
    on_card = x.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        run(n2)  # compiles what it must; also the host's issue time of n2
        issue_s = time.perf_counter() - t0
        torch.cuda.synchronize(x.device)
    else:
        run(n1)

    def timed(n) -> float:
        if not on_card:
            t0 = time.perf_counter()
            run(n)
            return time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2 * issue_s * _SLEEP_CYCLES_PER_S) + 1)
        start.record()
        run(n)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    t_short = t_long = float("inf")
    for _ in range(max(rounds, 1) + 1):
        t_short = min(t_short, timed(n1))
        t_long = min(t_long, timed(n2))
    return max(t_long - t_short, 1e-12) / (n2 - n1)
