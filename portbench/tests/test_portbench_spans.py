"""The span readers on a hand-built trace whose kernels, gaps and spans are
known, and (on the card) the program's spans kept off the device's
timeline."""
from types import SimpleNamespace

import pytest

from portbench import run, spans
from portbench.trace import Trace

# two units over 0-1000 us; kernels leave the gaps 0-100, 200-300, 350-600,
# 700-800 and 850-1000 (700 us idle). Each unit: a call of 400 us, its first
# phase 130 us, its second 270 us; the phases tile the call.
KERNELS = [("k", 100, 200), ("k", 300, 350), ("k", 600, 700), ("k", 800, 850)]
CALLS = [(20, 150, 420), (520, 650, 920)]

# idle inside each first phase: 20-100 and 520-600, 160 us; inside each
# second: 200-300, 350-420, 700-800 and 850-920, 340 us; outside the calls:
# 0-20, 420-520 and 920-1000, 200 us. A split at each gap's midpoint would
# give 350-600 (midpoint 475) to the outside whole.
FIRST_IDLE, SECOND_IDLE, OUTSIDE_IDLE = 100 * 160 / 700, 100 * 340 / 700, 100 * 200 / 700

SERVE = (spans.SERVE_CALL, spans.SERVE_COPY_IN, spans.SERVE_FORWARD)
TRAIN = (spans.TRAIN_STEP, spans.TRAIN_FORWARD, spans.TRAIN_BACKWARD)


def _rec(kind, names, with_spans=True):
    call, first, second = names
    host = [("aten::copy_", 30, 140), ("cudaLaunchKernel", 90, 95)]
    if with_spans:
        for s, m, e in CALLS:
            host += [(call, s, e), (first, s, m), (second, m, e)]
    trace = Trace(list(KERNELS), host, 0.0, 1000.0, units=2, slices=1, whole=True)
    return SimpleNamespace(kind=kind, trace=trace)


def _train_rec(with_spans=True):
    rec = _rec("train", TRAIN, with_spans)
    if with_spans:
        # the optimizer just after each backward: 420-440 and 920-940, both
        # idle, 40 us of the 700
        rec.trace.host += [(spans.TRAIN_OPTIMIZER, 420, 440),
                           (spans.TRAIN_OPTIMIZER, 920, 940)]
    return rec


READERS = run.readers()

CASES = [
    ("copy_in_ms.serve", "serve", 0.13),
    ("forward_host_ms.serve", "serve", 0.27),
    ("idle_copy_in_pct.serve", "serve", FIRST_IDLE),
    ("idle_forward_pct.serve", "serve", SECOND_IDLE),
    ("idle_forward_pct.train", "train", FIRST_IDLE),
    ("idle_backward_pct.train", "train", SECOND_IDLE),
    ("idle_optimizer_pct.train", "train", 100 * 40 / 700),
]


def _make(kind, with_spans=True):
    return _rec("serve", SERVE, with_spans) if kind == "serve" else _train_rec(with_spans)


@pytest.mark.parametrize("metric, kind, want", CASES)
def test_each_reader_reads_its_exact_value(metric, kind, want):
    assert READERS[metric].read(_make(kind)) == pytest.approx(want, rel=1e-12)
    # and nothing from the other kind's record, which holds no such span
    other = "train" if kind == "serve" else "serve"
    assert READERS[metric].read(_make(other)) is None


@pytest.mark.parametrize("metric, kind, want", CASES)
def test_no_span_reads_none(metric, kind, want):
    assert READERS[metric].read(_make(kind, with_spans=False)) is None
    assert READERS[metric].read(SimpleNamespace(kind=kind, trace=None)) is None


def test_serving_shares_and_the_outside_share_sum_to_100():
    rec = _make("serve")
    copy_in = READERS["idle_copy_in_pct.serve"].read(rec)
    forward = READERS["idle_forward_pct.serve"].read(rec)
    outside = 100 - spans.idle_in_pct(rec, spans.SERVE_CALL)
    assert outside == pytest.approx(OUTSIDE_IDLE, rel=1e-12)
    assert copy_in + forward + outside == pytest.approx(100, rel=1e-12)


def test_overlapping_spans_count_once():
    rec = _make("serve")
    rec.trace.host.append((spans.SERVE_COPY_IN, 40, 160))
    # the union of 20-150 and 40-160 adds 150-160 of no idle time
    assert spans.idle_in_pct(rec, spans.SERVE_COPY_IN) == pytest.approx(FIRST_IDLE)


def test_span_names_are_the_programs():
    from bnn_tpu_torch.utils import profiling

    assert spans.SPANS == profiling.SPANS


@pytest.mark.card
def test_spans_put_nothing_on_the_device_timeline(card):
    """A few ``r18-serve-b8``-sized calls under the profiler with CUDA
    activity: the spans are host events, and no device-side event carries
    a ``bnn.`` name (a user annotation would, and would read as a kernel)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from portbench import program, weights
    from portbench.core import load_cell

    cell = load_cell("r18-serve-b8")
    cfg, batch = cell["config"], cell["mix"]["batch"]
    model = program.qat_model(cfg, weights.make_state(cfg, 2147483659, card), card)
    pred = program.predictor(model, cfg, batch, card, **cell["mix"].get("predictor", {}))
    x = torch.randn(batch, cfg["in_channels"], cfg["image_size"], cfg["image_size"])
    for _ in range(3):
        pred(x).cpu()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            pred(x).cpu()
        torch.cuda.synchronize()
    events = prof.events()
    host = [e.name for e in events if e.device_type != DeviceType.CUDA]
    device = [e.name for e in events if e.device_type == DeviceType.CUDA]
    assert device, "the profiler recorded no device event"
    assert all(host.count(n) == 5 for n in SERVE), host
    assert not [n for n in device if n.startswith("bnn.")]
