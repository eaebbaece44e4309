"""The port's continuous batcher (bnn_tpu_torch.inference.batching): the
single-device cases of tests/test_batching.py, over the port's Predictor on
a deployed binary model (its weights carried from bnn_tpu's) and over plain
callables for the protocol's edges. Every wait has a timeout."""
import queue
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import bnn_tpu
import bnn_tpu_torch as bt
from bnn_tpu.inference import Predictor as JPredictor
from bnn_tpu.ops import binarizers as jops
from bnn_tpu_torch.inference import ContinuousBatcher, Predictor
from bnn_tpu_torch.inference.batching import LATENCY_WINDOW
from bnn_tpu_torch.ops import binarizers as tops
from bnn_tpu_torch.utils import load_jax_state
from test_torch_serving import _flat, _randomized, _write_flat


def _nets():
    """(JAX net, port net) of tests/test_batching.py's model, one state."""
    rngs = nnx.Rngs(0)
    jn = bnn_tpu.nn
    jm = jn.Sequential(
        jn.Conv2d(3, 8, 3, padding=1, rngs=rngs), jn.BatchNorm2d(8, rngs=rngs),
        jn.ReLU(), jn.Conv2d(8, 8, 3, padding=1, rngs=rngs),
        jn.AdaptiveAvgPool2d(1), jn.Flatten(), jn.Linear(8, 4, rngs=rngs))
    jm = bnn_tpu.prepare_binary_model(
        jm, bnn_tpu.BConfig(jops.BasicInputBinarizer, jops.BasicScaleBinarizer,
                            jops.XNORWeightBinarizer),
        ignore_layers_name=["_first_", "_last_"])
    tm = torch.nn.Sequential(
        torch.nn.Conv2d(3, 8, 3, padding=1), bt.nn.BatchNorm2d(8), torch.nn.ReLU(),
        torch.nn.Conv2d(8, 8, 3, padding=1), torch.nn.AdaptiveAvgPool2d(1),
        torch.nn.Flatten(), torch.nn.Linear(8, 4))
    tm = bt.prepare_binary_model(
        tm, bt.BConfig(tops.BasicInputBinarizer, tops.BasicScaleBinarizer,
                       tops.XNORWeightBinarizer),
        ignore_layers_name=["_first_", "_last_"])
    flat = _randomized(_flat(jm), np.random.RandomState(0))
    _write_flat(jm, flat)
    load_jax_state(tm, flat)
    jm.eval()
    return jm, tm.eval()


def make_predictor(batch_size=8):
    return Predictor(_nets()[1], batch_size=batch_size, fuse=False,
                     space_to_depth=False, dtype=None, device="cpu")


def _requests(seed, sizes):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, 3, 8, 8).astype(np.float32) for n in sizes]


class TestAgainstPredictor:
    def test_results_match_direct_calls(self):
        """Rows coalesced across requests equal the direct per-request calls
        of the same predictor, and the JAX Predictor's rows."""
        jm, tm = _nets()
        pred = Predictor(tm, batch_size=8, fuse=False, space_to_depth=False,
                         dtype=None, device="cpu")
        jpred = JPredictor(jm, batch_size=8, use_pallas=False, fuse=False,
                           space_to_depth=False, dtype=None)
        reqs = _requests(0, (1, 3, 1, 2, 5, 8, 1))
        with ContinuousBatcher(pred, max_delay_ms=20.0) as srv:
            futs = [srv.submit(r) for r in reqs]
            outs = [f.result(timeout=120) for f in futs]
        for r, o in zip(reqs, outs):
            assert isinstance(o, torch.Tensor) and o.device.type == "cpu"
            assert o.shape == (r.shape[0], 4)
            torch.testing.assert_close(o, pred(r), rtol=0, atol=1e-5)
            want = np.asarray(jpred(jnp.asarray(r.transpose(0, 2, 3, 1))))
            np.testing.assert_allclose(o.numpy(), want, rtol=1e-5, atol=1e-5)

    def test_coalescing_batches_requests(self):
        """Requests submitted together ride one call (batches < requests)
        and the occupancy counts real rows."""
        pred = make_predictor(batch_size=8)
        with ContinuousBatcher(pred, max_delay_ms=200.0) as srv:
            futs = [srv.submit(r) for r in _requests(1, (2,) * 8)]
            for f in futs:
                f.result(timeout=120)
            st = srv.stats()
        assert st.requests == 8 and st.rows == 16
        assert st.batches < st.requests, st
        assert 0 < st.mean_occupancy <= 1.0
        assert st.latency_percentile(99) > 0

    def test_single_request_flushes_on_delay(self):
        """A lone request does not wait forever for co-riders."""
        pred = make_predictor(batch_size=8)
        with ContinuousBatcher(pred, max_delay_ms=5.0) as srv:
            out = srv.predict_one(torch.zeros(3, 8, 8))
        assert out.shape == (4,)


class _CountingModel:
    """A callable predictor recording the batch sizes it sees."""

    def __init__(self, delay=0.0):
        self.calls = []
        self.delay = delay

    def __call__(self, x):
        self.calls.append(x.shape[0])
        if self.delay:
            time.sleep(self.delay)
        return x.sum(dim=tuple(range(1, x.ndim))) if x.ndim > 1 else x


class TestProtocol:
    def test_oversized_corider_is_held_not_split(self):
        """A request that does not fit the current batch goes whole in the
        next one, never split across two calls."""
        m = _CountingModel(delay=0.05)
        with ContinuousBatcher(m, max_batch=4, max_delay_ms=100.0) as srv:
            f1 = srv.submit(np.ones((3, 2)))   # fills 3 of 4
            time.sleep(0.01)                   # the dispatcher takes it
            f2 = srv.submit(np.ones((2, 2)))   # does not fit: held
            assert f1.result(timeout=30).shape == (3,)
            assert f2.result(timeout=30).shape == (2,)
        assert m.calls == [3, 2], m.calls

    def test_error_propagates_and_server_survives(self):
        calls = {"n": 0}

        def flaky(x):
            calls["n"] += 1
            if calls["n"] == 1:
                raise ValueError("boom")
            return x

        with ContinuousBatcher(flaky, max_batch=4, max_delay_ms=5.0) as srv:
            bad = srv.submit(np.ones((1, 2)))
            with pytest.raises(ValueError, match="boom"):
                bad.result(timeout=30)
            ok = srv.submit(np.ones((1, 2)))
            torch.testing.assert_close(ok.result(timeout=30),
                                       torch.ones(1, 2, dtype=torch.float64))

    def test_backpressure_raises_queue_full(self):
        m = _CountingModel(delay=0.5)  # slow: the queue backs up
        srv = ContinuousBatcher(m, max_batch=1, max_delay_ms=1.0, max_queue=2)
        try:
            with pytest.raises(queue.Full):
                for _ in range(16):
                    srv.submit(np.ones((1, 2)))
        finally:
            srv.close()
        assert not srv._thread.is_alive()

    def test_close_drains_then_rejects(self):
        m = _CountingModel()
        srv = ContinuousBatcher(m, max_batch=4, max_delay_ms=1.0)
        futs = [srv.submit(np.ones((1, 2))) for _ in range(5)]
        srv.close()
        for f in futs:
            assert f.result(timeout=30) is not None
        with pytest.raises(RuntimeError):
            srv.submit(np.ones((1, 2)))

    def test_requires_max_batch_for_plain_callables(self):
        with pytest.raises(ValueError):
            ContinuousBatcher(lambda x: x)

    def test_mismatched_feature_shape_rejected_in_client(self):
        """A shape mismatch fails the submitting caller and never reaches
        the dispatcher (a failed torch.cat there would fail the co-riders)."""
        m = _CountingModel(delay=0.05)
        with ContinuousBatcher(m, max_batch=8, max_delay_ms=50.0) as srv:
            ok = srv.submit(np.ones((2, 3, 8, 8)))
            with pytest.raises(ValueError, match="feature shape"):
                srv.submit(np.ones((1, 3, 4, 4)))
            with pytest.raises(ValueError, match="predict_one"):
                srv.submit(np.ones(()))  # a scalar: no batch dim
            assert ok.result(timeout=30).shape == (2,)
            # the server still serves well-shaped requests
            assert srv.submit(torch.ones(1, 3, 8, 8)).result(timeout=30).shape == (1,)

    def test_cancelled_future_does_not_kill_dispatcher(self):
        """A client that cancels its Future does not stop the dispatcher
        (set_result on a cancelled future raises); later requests serve."""
        m = _CountingModel(delay=0.2)
        with ContinuousBatcher(m, max_batch=4, max_delay_ms=1.0) as srv:
            doomed = srv.submit(np.ones((1, 2)))
            time.sleep(0.02)  # the dispatcher may or may not have taken it:
            doomed.cancel()   # either way the cancel is survivable
            ok = srv.submit(np.ones((1, 2)))
            torch.testing.assert_close(ok.result(timeout=30),
                                       torch.tensor([2.0], dtype=torch.float64))

    def test_latency_window_is_bounded(self):
        m = _CountingModel()
        with ContinuousBatcher(m, max_batch=64, max_delay_ms=0.5) as srv:
            for _ in range(50):
                srv.submit(np.ones((1, 2))).result(timeout=30)
            st = srv.stats()
        assert len(st.latencies_ms) <= LATENCY_WINDOW
        assert st.requests == 50

    def test_concurrent_submitters(self):
        """Many client threads, one dispatcher, a short switch interval:
        each future gets its own rows back."""
        m = _CountingModel()
        outs = {}

        def client(i, srv):
            outs[i] = srv.submit(np.full((2, 3), float(i))).result(timeout=60)

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            with ContinuousBatcher(m, max_batch=8, max_delay_ms=5.0) as srv:
                ts = [threading.Thread(target=client, args=(i, srv))
                      for i in range(12)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(timeout=60)
                assert not any(t.is_alive() for t in ts)
        finally:
            sys.setswitchinterval(interval)
        assert sorted(outs) == list(range(12))
        for i, o in outs.items():
            torch.testing.assert_close(o, torch.full((2,), 3.0 * i, dtype=torch.float64))
