"""Continuous batching: coalesce a request stream into fixed-size batches
(counterpart of ``bnn_tpu/inference/batching.py``).

Requests (one image, or a few rows, NCHW, as numpy arrays or CPU tensors)
are queued; one dispatcher thread joins whatever is waiting, up to the
predictor's ``batch_size`` or until ``max_delay`` has passed for the oldest
request, into one ``torch.cat``, makes ONE predictor call, copies its output
to the host once and hands each request its rows through a
``concurrent.futures.Future``.

- **One batch shape.** Every call goes to the predictor at its fixed
  ``batch_size`` (the ``Predictor`` pads), so the card runs the same
  kernels with the same launch plans for the whole stream.
- **One dispatcher thread.** Every launch is made from it, on its current
  CUDA stream (the kernel wrappers launch on the calling thread's current
  stream); callers only build host arrays and wait on futures. Autograd's
  mode is per thread: the dispatcher runs every call under
  ``torch.no_grad``.
- **One latency knob.** ``max_delay`` bounds how long the oldest request
  waits for co-riders; under a high offered load batches fill first.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import numpy as np
import torch

__all__ = ["ContinuousBatcher", "BatcherStats"]


@dataclass
class _Request:
    x: torch.Tensor             # (n, *feature_dims), on the host
    rows: int
    future: Future
    t_enqueue: float


LATENCY_WINDOW = 65536  # most recent requests kept for the percentiles


@dataclass
class BatcherStats:
    """Cumulative serving statistics (see :meth:`ContinuousBatcher.stats`).

    The counters are cumulative; ``latencies_ms`` is a sliding window of the
    last ``LATENCY_WINDOW`` request latencies, so a long-lived server does
    not grow without bound."""
    requests: int = 0
    rows: int = 0
    batches: int = 0
    max_batch_rows: int = 0
    latencies_ms: Any = field(
        default_factory=lambda: deque(maxlen=LATENCY_WINDOW))

    @property
    def mean_occupancy(self) -> float:
        """Mean share of the batch filled with real rows."""
        if not self.batches or not self.max_batch_rows:
            return 0.0
        return self.rows / (self.batches * self.max_batch_rows)

    def latency_percentile(self, p: float) -> float:
        """p-th percentile request latency (enqueue to result), ms."""
        if not self.latencies_ms:
            return 0.0
        return float(np.percentile(np.asarray(list(self.latencies_ms)), p))


class ContinuousBatcher:
    """Queue and dispatcher turning a request stream into batched calls.

    ``predictor`` is typically :class:`bnn_tpu_torch.inference.Predictor`
    or a bundle loaded with :func:`bnn_tpu_torch.inference.load_serving`
    (its ``batch_size`` is the coalescing target), but any ``fn(x) -> y``
    that maps row ``i`` of ``x`` to row ``i`` of ``y`` works (pass
    ``max_batch`` for a plain callable)::

        server = ContinuousBatcher(predictor, max_delay_ms=2.0)
        fut = server.submit(image[None])    # non-blocking
        logits = fut.result()               # CPU tensor rows
        server.close()
    """

    def __init__(self, predictor: Callable, *,
                 max_batch: Optional[int] = None,
                 max_delay_ms: float = 2.0,
                 max_queue: int = 1024):
        if max_batch is None:
            max_batch = getattr(predictor, "batch_size", None)
        if not max_batch or max_batch < 1:
            raise ValueError(
                "max_batch must be provided (or predictor.batch_size set)")
        self._predictor = predictor
        self.max_batch = int(max_batch)
        self.max_delay = max_delay_ms / 1e3
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue(
            maxsize=max_queue)
        self._stats = BatcherStats(max_batch_rows=self.max_batch)
        self._stats_lock = threading.Lock()
        self._closed = False
        # guards submit()'s closed check and enqueue against a concurrent
        # close(): without it a request can land behind the shutdown
        # sentinel and wait forever
        self._submit_lock = threading.Lock()
        self._feature_shape: Optional[tuple] = None
        self._held: Optional[_Request] = None  # the dispatcher thread's alone
        self._thread = threading.Thread(
            target=self._dispatch_loop, name="bnn-batcher", daemon=True)
        self._thread.start()

    # -- client side ---------------------------------------------------------

    def submit(self, x) -> Future:
        """Enqueue one request; returns a Future resolving to its rows.

        ``x`` is a batch ``(n, *feature_dims)``, a numpy array or a CPU
        tensor, with an explicit leading batch dim (:meth:`predict_one` takes
        a bare example); the future resolves to the matching ``(n, classes)``
        CPU tensor rows. Raises ``ValueError`` on a rank or feature-shape
        mismatch with earlier requests (every rider of one stream joins one
        tensor), ``queue.Full`` when ``max_queue`` requests already wait
        (backpressure: the caller sheds or retries), and ``RuntimeError``
        after :meth:`close`.
        """
        x = torch.as_tensor(x)
        if x.ndim < 1 or x.shape[0] < 1:
            raise ValueError(
                f"submit() needs (n, *feature_dims) with n >= 1, got "
                f"shape {tuple(x.shape)}; use predict_one() for bare examples")
        fut: Future = Future()
        req = _Request(x=x, rows=x.shape[0], future=fut,
                       t_enqueue=time.monotonic())
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("ContinuousBatcher is closed")
            # a mismatched shape fails here, in the caller's thread: a failed
            # torch.cat in the dispatcher would fail every co-rider
            if self._feature_shape is None:
                self._feature_shape = tuple(x.shape[1:])
            elif tuple(x.shape[1:]) != self._feature_shape:
                raise ValueError(
                    f"request feature shape {tuple(x.shape[1:])} != stream's "
                    f"{self._feature_shape}")
            self._queue.put_nowait(req)
        return fut

    def predict(self, x):
        """Blocking :meth:`submit`."""
        return self.submit(x).result()

    def predict_one(self, x):
        """Blocking single-example predict: ``(*feature_dims)`` in,
        ``(classes,)`` out."""
        return self.submit(torch.as_tensor(x)[None]).result()[0]

    def stats(self) -> BatcherStats:
        with self._stats_lock:
            return BatcherStats(
                requests=self._stats.requests,
                rows=self._stats.rows,
                batches=self._stats.batches,
                max_batch_rows=self._stats.max_batch_rows,
                latencies_ms=list(self._stats.latencies_ms),
            )

    def close(self, *, drain: bool = True) -> None:
        """Stop accepting requests; finish (``drain=True``) or fail
        (``drain=False``) what is queued; join the dispatcher."""
        with self._submit_lock:  # no submit interleaves past here
            if self._closed:
                return
            self._closed = True
            if not drain:
                try:
                    while True:
                        req = self._queue.get_nowait()
                        if req is not None:
                            self._fail_future(req.future, RuntimeError(
                                "ContinuousBatcher closed"))
                except queue.Empty:
                    pass
            # the sentinel wakes and stops the dispatcher; a blocking put is
            # safe: submits are locked out, so only the dispatcher takes from
            # the queue and frees a slot
            self._queue.put(None)
        self._thread.join(timeout=60.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- dispatcher side -----------------------------------------------------

    def _collect(self, seed: Optional[_Request] = None
                 ) -> Optional[List[_Request]]:
        """Block for the first request (or start from a held ``seed``), then
        take co-riders until the batch is full or the oldest request's delay
        has passed."""
        first = seed if seed is not None else self._queue.get()
        if first is None:
            return None
        batch = [first]
        rows = first.rows
        deadline = first.t_enqueue + self.max_delay
        while rows < self.max_batch:
            timeout = deadline - time.monotonic()
            try:
                nxt = self._queue.get(block=timeout > 0,
                                      timeout=timeout if timeout > 0 else None)
            except queue.Empty:
                break
            if nxt is None:  # close()'s sentinel: serve what is here,
                self._queue.put(None)   # then stop on the next round
                break
            if rows + nxt.rows > self.max_batch:
                # too big for this batch: held whole for the next one, never
                # split across two calls
                self._held = nxt
                break
            batch.append(nxt)
            rows += nxt.rows
        return batch

    @staticmethod
    def _fail_future(fut: Future, exc: Exception) -> None:
        try:
            fut.set_exception(exc)
        except Exception:  # already cancelled or resolved by the client
            pass

    def _dispatch_loop(self) -> None:
        with torch.no_grad():
            while True:
                held, self._held = self._held, None
                batch = self._collect(held)
                if batch is None:
                    return
                self._dispatch(batch)

    def _dispatch(self, batch: List[_Request]) -> None:
        # a client may have cancelled while waiting; set_result on a
        # cancelled Future raises, so claim each rider first and drop the
        # cancelled ones
        batch = [r for r in batch if r.future.set_running_or_notify_cancel()]
        if not batch:
            return
        # everything below is guarded: an escaped exception would end the
        # dispatcher thread and leave every future waiting forever
        try:
            x = torch.cat([r.x for r in batch]) if len(batch) > 1 else batch[0].x
            y = torch.as_tensor(self._predictor(x)).cpu()  # one copy to the host
            now = time.monotonic()
            off = 0
            for r in batch:
                r.future.set_result(y[off:off + r.rows])
                off += r.rows
        except Exception as e:  # every rider hears of it; serving goes on
            for r in batch:
                self._fail_future(r.future, e)
            return
        with self._stats_lock:
            self._stats.requests += len(batch)
            self._stats.rows += off
            self._stats.batches += 1
            self._stats.latencies_ms.extend(
                (now - r.t_enqueue) * 1e3 for r in batch)
