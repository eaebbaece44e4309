"""Tracing and cost counting (counterpart of ``bnn_tpu/utils/profiling.py``).

- :func:`trace`: a block under ``torch.profiler`` (CPU and, where there is a
  card, CUDA activities), written as a Chrome / TensorBoard trace into a
  directory;
- :func:`span`: a named range on the host's timeline, recorded only while a
  profiler runs. A :func:`trace` shows the program's own spans
  (:data:`SPANS`) beside the operators and kernels they hold:

  - ``bnn.serve.call``: one ``Predictor`` or ``ExportedServer`` call, which
    holds ``bnn.serve.copy_in`` (the request's cast and copy to the device)
    then ``bnn.serve.forward`` (the padded batches through the served
    model: the modules' Python, the kernels' wrappers and launches);
  - ``bnn.train.step``: one ``make_train_step`` step, which holds a
    ``bnn.train.forward`` (the loss) and a ``bnn.train.backward`` per
    microbatch, then ``bnn.train.optimizer`` (``optimizer.step()``); the
    gradients' zeroing and averaging and the metrics lie in the step,
    outside the three;
- :func:`compiled_stats`: the FLOPs of one call, counted by
  ``torch.utils.flop_counter.FlopCounterMode``, and on the card its peak
  device memory.
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Dict

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["trace", "span", "SPANS", "compiled_stats"]

SERVE_CALL = "bnn.serve.call"
SERVE_COPY_IN = "bnn.serve.copy_in"
SERVE_FORWARD = "bnn.serve.forward"
TRAIN_STEP = "bnn.train.step"
TRAIN_FORWARD = "bnn.train.forward"
TRAIN_BACKWARD = "bnn.train.backward"
TRAIN_OPTIMIZER = "bnn.train.optimizer"
# every span the program records; none is named ``bnn_tpu_torch::...``, the
# namespace of the port's operators, nor after a kernel
SPANS = (SERVE_CALL, SERVE_COPY_IN, SERVE_FORWARD,
         TRAIN_STEP, TRAIN_FORWARD, TRAIN_BACKWARD, TRAIN_OPTIMIZER)

_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block: ``with trace('/tmp/tb') as prof: step(...)``. The
    trace is written into ``log_dir`` (``*.pt.trace.json``, for TensorBoard
    or chrome://tracing) when the block ends; ``prof`` is the
    ``torch.profiler.profile`` object (``prof.key_averages()``)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def span(name: str):
    """``with span(SERVE_COPY_IN): ...``: with no profiler running, a shared
    no-op context (one flag read, no ``RecordFunction``); under one, a host
    event named ``name``. The event is a plain function-scope record, not a
    user annotation (``torch.profiler.record_function``), which the profiler
    would copy onto the device's timeline as a range over the kernels
    launched inside it."""
    if _autograd_profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _OFF


def _devices(args, kwargs) -> set:
    found = set()

    def visit(v):
        if isinstance(v, torch.Tensor):
            found.add(v.device)
        elif isinstance(v, (list, tuple)):
            for u in v:
                visit(u)
        elif isinstance(v, dict):
            for u in v.values():
                visit(u)
        elif isinstance(v, torch.nn.Module):
            for p in v.parameters():
                found.add(p.device)

    visit(list(args))
    visit(kwargs)
    return found


def compiled_stats(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once and return its costs: ``"flops"``
    (matrix products and convolutions, 2 per multiply-add, as
    ``FlopCounterMode`` counts them) and, when a tensor or module argument
    lies on the card, ``"peak_memory_bytes"``, the most device memory
    allocated during the call (``torch.cuda.max_memory_allocated`` after a
    reset, so it includes what was allocated before the call)."""
    cuda = [d for d in _devices(args, kwargs) if d.type == "cuda"]
    if cuda:
        torch.cuda.synchronize(cuda[0])
        torch.cuda.reset_peak_memory_stats(cuda[0])
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    out: Dict[str, Any] = {"flops": counter.get_total_flops()}
    if cuda:
        torch.cuda.synchronize(cuda[0])
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(cuda[0])
    return out
