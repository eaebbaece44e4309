"""The port's spans (``bnn_tpu_torch.utils.profiling.span``) on the CPU: the
serving call's and the training step's spans, nested and ordered on one
thread under ``torch.profiler``; nothing recorded, and no RecordFunction
made, without a profiler; and ``trace()`` writing them into its Chrome
trace."""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bnn_tpu_torch.inference import Predictor, load_serving
from bnn_tpu_torch.parallel import make_train_step
from bnn_tpu_torch.utils import profiling, trace
from bnn_tpu_torch.utils.profiling import (SERVE_CALL, SERVE_COPY_IN, SERVE_FORWARD, SPANS,
                                           TRAIN_BACKWARD, TRAIN_FORWARD, TRAIN_OPTIMIZER,
                                           TRAIN_STEP)


def _predictor():
    return Predictor(torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3)), batch_size=2,
                     device="cpu", dtype=torch.bfloat16)


def _train_parts(accum_steps=1):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Flatten(), torch.nn.Linear(12, 3))
    opt = torch.optim.AdamW(model.parameters())
    x, y = torch.randn(4, 3, 2, 2), torch.tensor([0, 1, 2, 0])
    return make_train_step(accum_steps=accum_steps), model, opt, x, y


def _events(fn):
    """``(name, thread, start, end)`` of the host events ``fn()`` records,
    in the order they start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = [(e.name, e.thread, e.time_range.start, e.time_range.end) for e in prof.events()]
    return sorted(out, key=lambda e: e[2])


def _named(events, name):
    return [e for e in events if e[0] == name]


def _inside(inner, outer):
    return inner[1] == outer[1] and outer[2] <= inner[2] and inner[3] <= outer[3]


def _serve_spans_are_nested(events, calls):
    spans = {n: _named(events, n) for n in (SERVE_CALL, SERVE_COPY_IN, SERVE_FORWARD)}
    assert all(len(v) == calls for v in spans.values()), spans
    copies = [e for e in events if e[0] in ("aten::to", "aten::copy_")]
    for call, copy_in, forward in zip(*spans.values()):
        assert _inside(copy_in, call) and _inside(forward, call)
        assert copy_in[3] <= forward[2]
        assert any(_inside(c, copy_in) for c in copies)


def test_predictor_call_records_copy_in_then_forward():
    pred = _predictor()
    x = torch.randn(3, 3, 8, 8)
    events = _events(lambda: (pred(x), pred(x)))
    _serve_spans_are_nested(events, calls=2)


def test_exported_server_call_records_copy_in_then_forward(tmp_path):
    pred = _predictor()
    pred.export(str(tmp_path / "bundle"), (3, 8, 8))
    server = load_serving(str(tmp_path / "bundle"))
    x = torch.randn(3, 3, 8, 8)
    events = _events(lambda: server(x))
    _serve_spans_are_nested(events, calls=1)


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_records_its_phases(accum_steps):
    step, model, opt, x, y = _train_parts(accum_steps)
    events = _events(lambda: step(model, opt, x, y))
    (outer,) = _named(events, TRAIN_STEP)
    phases = [e for e in events if e[0] in (TRAIN_FORWARD, TRAIN_BACKWARD, TRAIN_OPTIMIZER)]
    assert [e[0] for e in phases] == [TRAIN_FORWARD, TRAIN_BACKWARD] * accum_steps + [
        TRAIN_OPTIMIZER]
    assert all(_inside(e, outer) for e in phases)
    assert all(a[3] <= b[2] for a, b in zip(phases, phases[1:]))
    assert any(e[0] == "aten::linear" and _inside(e, phases[0]) for e in events)


def test_no_record_function_without_a_profiler(monkeypatch):
    made = []
    real = profiling._RecordFunctionFast

    def spy(name):
        made.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "_RecordFunctionFast", spy)
    pred = _predictor()
    step, model, opt, x, y = _train_parts(accum_steps=2)
    pred(torch.randn(3, 3, 8, 8))
    step(model, opt, x, y)
    assert made == []
    assert profiling.span(SERVE_CALL) is profiling.span(TRAIN_STEP)
    # the same spy sees every span once a profiler runs
    _events(lambda: (pred(torch.randn(3, 3, 8, 8)), step(model, opt, x, y)))
    assert sorted(set(made)) == sorted(SPANS)


def test_span_names():
    assert len(set(SPANS)) == len(SPANS) == 7
    assert all(n.startswith("bnn.") and not n.startswith("bnn_tpu_torch::") for n in SPANS)


def test_trace_writes_the_spans(tmp_path):
    pred = _predictor()
    step, model, opt, x, y = _train_parts()
    with trace(str(tmp_path)):
        pred(torch.randn(3, 3, 8, 8))
        step(model, opt, x, y)
    (path,) = tmp_path.glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert set(SPANS) <= names
