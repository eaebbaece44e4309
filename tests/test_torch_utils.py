"""The port's training utilities (bnn_tpu_torch.utils: meters, flops, timing,
profiling, debug, cache) against bnn_tpu.utils on the CPU: the meters' text,
accuracy and count_parameters on the CIFAR trainer's model, count_ops layer
by layer on tests/test_utils.py's net and on ResNet-18 in float, binarized
and deployed form, assert_finite's leaf names, and the checks that have no
JAX counterpart to compare with (debug_nans, loop_time, compiled_stats'
FLOPs against 2 * MACs, the cache directory, the trace file)."""
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import bnn_tpu
import bnn_tpu_torch as bt
from bnn_tpu.ops import binarizers as jops
from bnn_tpu_torch.examples import cifar10
from bnn_tpu_torch.kernels import _build
from bnn_tpu_torch.ops import binarizers as tops
from bnn_tpu_torch.utils import (AverageMeter, ProgressMeter, accuracy,
                                 assert_finite, checkify_errors,
                                 compiled_stats, count_ops, count_parameters,
                                 debug_nans, enable_compilation_cache,
                                 loop_time, trace)
from test_torch_zoo import jax_model

_BINARY = ("BasicInputBinarizer", "BasicScaleBinarizer", "XNORWeightBinarizer")
_CIFAR = ("BasicInputBinarizer", "Identity", "XNORWeightBinarizer")


def _bconfigs(names):
    return (bnn_tpu.BConfig(*[getattr(jops, n) for n in names]),
            bt.BConfig(*[getattr(tops, n) for n in names]))


def make_nets(binarize=None, **kw):
    """tests/test_utils.py's make_net in both packages (the port's from
    torch.nn with the port's BatchNorm), binarized with ``binarize``."""
    rngs = nnx.Rngs(0)
    jm = bnn_tpu.nn.Sequential(
        bnn_tpu.nn.Conv2d(3, 16, 3, padding=1, rngs=rngs),
        bnn_tpu.nn.BatchNorm2d(16, rngs=rngs), bnn_tpu.nn.ReLU(),
        bnn_tpu.nn.AdaptiveAvgPool2d(1), bnn_tpu.nn.Flatten(),
        bnn_tpu.nn.Linear(16, 4, rngs=rngs))
    tm = torch.nn.Sequential(
        torch.nn.Conv2d(3, 16, 3, padding=1), bt.nn.BatchNorm2d(16),
        torch.nn.ReLU(), torch.nn.AdaptiveAvgPool2d(1), torch.nn.Flatten(),
        torch.nn.Linear(16, 4))
    if binarize is not None:
        jc, tc = _bconfigs(binarize)
        jm = bnn_tpu.prepare_binary_model(jm, jc, **kw)
        custom = {k: bt.BConfig() for k in kw.get("custom_config_layers_name", {})}
        tkw = dict(kw, custom_config_layers_name=custom) if custom else kw
        tm = bt.prepare_binary_model(tm, tc, **tkw)
    return jm, tm


def _jax_resnet18(names=None, **kw):
    """The JAX ResNet-18 (10 classes), binarized with the binarizers
    ``names`` and ``prepare_binary_model``'s ``kw`` inside the build, so
    that ``jax_model`` fills its state from numpy without running the
    initializers (seconds on the CPU)."""
    def build():
        m = bnn_tpu.models.resnet18(num_classes=10, rngs=nnx.Rngs(0))
        return m if names is None else bnn_tpu.prepare_binary_model(
            m, _bconfigs(names)[0], **kw)
    return jax_model(build)


def resnets(form, jax=True):
    """ResNet-18 (10 classes) in both packages (the JAX one None unless
    ``jax``): 'float', 'binarized' (the flagship's config, first and last
    layers float) or 'deployed'."""
    ignore = ["_first_", "_last_"]
    binary = form != "float"
    jm = (_jax_resnet18(*((_BINARY,) if binary else ()),
                        **({"ignore_layers_name": ignore} if binary else {}))
          if jax else None)
    tm = bt.models.resnet18(num_classes=10)
    if binary:
        tm = bt.prepare_binary_model(tm, _bconfigs(_BINARY)[1],
                                     ignore_layers_name=ignore)
    if form == "deployed":
        tm = bt.inference.deploy(tm.eval())
        if jax:
            jm.eval()
            jm = bnn_tpu.inference.deploy(jm, use_pallas=False)
    return jm, tm


def test_meters_render_as_jax():
    for ours, theirs in ((AverageMeter("Loss", ":.4e"), bnn_tpu.utils.AverageMeter("Loss", ":.4e")),
                         (AverageMeter("Acc@1", ":6.2f"), bnn_tpu.utils.AverageMeter("Acc@1", ":6.2f"))):
        for v, n in ((2.0, 1), (4.5, 3), (0.125, 8)):
            ours.update(v, n)
            theirs.update(v, n)
            assert str(ours) == str(theirs)
        assert (ours.avg, ours.count, ours.val) == (theirs.avg, theirs.count, theirs.val)


def test_progress_meter_prints_as_jax(capsys):
    m = AverageMeter("acc", ":.1f")
    m.update(1.0)
    ProgressMeter(10, [m], prefix="Epoch[0]").display(3)
    ours = capsys.readouterr().out
    jm = bnn_tpu.utils.AverageMeter("acc", ":.1f")
    jm.update(1.0)
    bnn_tpu.utils.ProgressMeter(10, [jm], prefix="Epoch[0]").display(3)
    assert ours == capsys.readouterr().out == "Epoch[0][ 3/10]\tacc 1.0 (1.0)\n"


@pytest.mark.parametrize("classes,topk", [(10, (1, 5)), (2, (1, 5)), (100, (1, 2, 10))])
def test_accuracy_equal(classes, topk):
    rng = np.random.default_rng(classes)
    logits = rng.normal(size=(64, classes)).astype(np.float32)
    target = rng.integers(0, classes, 64)
    ours = accuracy(torch.from_numpy(logits), torch.from_numpy(target), topk=topk)
    theirs = bnn_tpu.utils.accuracy(jnp.asarray(logits), jnp.asarray(target), topk=topk)
    assert ours == pytest.approx(theirs, abs=1e-4)


def test_count_parameters_of_the_cifar_model():
    """The CIFAR trainer's model: the port counts its parameters as the JAX
    package counts nnx.Param leaves (BatchNorm statistics are not
    parameters in either; the binarizers hold none)."""
    jm = _jax_resnet18(_CIFAR, custom_config_layers_name={
        "conv1": bnn_tpu.BConfig(), "fc": bnn_tpu.BConfig()})
    ours = count_parameters(cifar10.build_model(0))
    assert ours == bnn_tpu.utils.count_parameters(jm) == 11_181_642


@pytest.mark.parametrize("case", ["float", "binary", "identity", "deployed"])
def test_count_ops_of_make_net(case):
    kw = {"float": (None, {}),
          "binary": (_BINARY, {"ignore_layers_name": ["_first_"]}),
          "identity": (_BINARY, {"custom_config_layers_name": {"0": None, "5": None}}),
          "deployed": (_BINARY, {"ignore_layers_name": ["_first_"]})}[case]
    binarize, extra = kw
    if case == "identity":
        jm, tm = make_nets(binarize, custom_config_layers_name={
            "0": bnn_tpu.BConfig(), "5": bnn_tpu.BConfig()})
    else:
        jm, tm = make_nets(binarize, **extra)
    if case == "deployed":
        jm.eval()
        jm = bnn_tpu.inference.deploy(jm, use_pallas=False)
        tm = bt.inference.deploy(tm.eval())
    ours, theirs = count_ops(tm, (1, 3, 8, 8)), bnn_tpu.utils.count_ops(jm, (1, 8, 8, 3))
    assert ours.per_layer == theirs.per_layer
    assert (ours.flops, ours.bops) == (theirs.flops, theirs.bops)
    assert ours.effective_flops == theirs.effective_flops


@pytest.mark.parametrize("form", ["float", "binarized", "deployed"])
def test_count_ops_of_resnet18(form):
    jm, tm = resnets(form)
    ours = count_ops(tm, (2, 3, 32, 32))
    theirs = bnn_tpu.utils.count_ops(jm, (2, 32, 32, 3))
    assert len(ours.per_layer) == 21
    assert ours.per_layer == theirs.per_layer
    assert (ours.flops, ours.bops) == (theirs.flops, theirs.bops)
    assert (ours.bops > 0) == (form != "float")
    # counting leaves the model as it was
    assert next(tm.parameters()).device.type == "cpu"


def test_compiled_stats_counts_twice_the_macs():
    """FlopCounterMode's count of a float and of a QAT ResNet-18 forward is
    count_ops' 2 * MACs over every conv and linear (a QAT binary layer runs
    a float conv on +/-1 values)."""
    x = torch.randn(2, 3, 32, 32)
    for form in ("float", "binarized"):
        _, tm = resnets(form, jax=False)
        ops = count_ops(tm, tuple(x.shape))
        stats = compiled_stats(tm.eval(), x)
        assert stats["flops"] == ops.flops + ops.bops
        assert "peak_memory_bytes" not in stats  # only on the card


def _jax_keys(msg):
    """JAX's keystr paths (``"['a']['b']"``, ``"['d'][1]"``) as dotted names."""
    paths = eval(msg.split(": ", 1)[1])
    return [".".join(a or b for a, b in re.findall(r"\['([^']*)'\]|\[(\d+)\]", p))
            for p in paths]


def test_assert_finite_names_the_same_leaves():
    nan, inf = float("nan"), float("inf")
    tree = {"a": {"b": [1.0, nan], "c": [1.0, 2.0]}, "d": [[1.0], [inf]],
            "e": [3.0]}
    with pytest.raises(ValueError) as ours:
        assert_finite({"a": {k: torch.tensor(v) for k, v in tree["a"].items()},
                       "d": [torch.tensor(v) for v in tree["d"]],
                       "e": torch.tensor(tree["e"])}, name="grads")
    with pytest.raises(ValueError) as theirs:
        bnn_tpu.utils.assert_finite(
            {"a": {k: jnp.asarray(v) for k, v in tree["a"].items()},
             "d": [jnp.asarray(v) for v in tree["d"]],
             "e": jnp.asarray(tree["e"])}, name="grads")
    assert "non-finite values in grads" in str(ours.value)
    named = eval(str(ours.value).split(": ", 1)[1])
    assert named == ["a.b", "d.1"] == _jax_keys(str(theirs.value))
    # modules by their state_dict
    net = torch.nn.Linear(2, 2)
    with torch.no_grad():
        net.bias[0] = inf
    with pytest.raises(ValueError, match=r"\['bias'\]"):
        assert_finite(net)
    assert_finite({"w": torch.ones(3), "n": torch.arange(3)})


def test_debug_nans_and_checkify():
    x = torch.tensor([-1.0, 1.0])
    with pytest.raises(FloatingPointError, match="nan in the output of aten.log"):
        with debug_nans():
            torch.log(x)
    with debug_nans(enable=False):
        torch.log(x)
    with debug_nans():
        torch.exp(x)
    with pytest.raises(FloatingPointError, match="inf in the output of aten.div"):
        checkify_errors(lambda a: a / 0)(torch.ones(2))
    assert torch.equal(checkify_errors(lambda a: a + 1)(torch.ones(2)), torch.full((2,), 2.0))
    with pytest.raises(ValueError, match="unknown float checks"):
        checkify_errors(lambda a: a, errors=("oob",))(x)


def test_loop_time_is_positive_and_finite():
    x = torch.randn(32, 32)
    t = loop_time(lambda a, b: a @ b, x, x, iters=20, rounds=1)
    assert 0 < t < 1 and np.isfinite(t)


def test_compilation_cache_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = _build.BUILD_DIR
    assert enable_compilation_cache() == ""
    assert _build.BUILD_DIR == before


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(16, 16)
    with trace(str(tmp_path)) as prof:
        torch.mm(x, x)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())
