"""The whole slice: the port's Predictor against the JAX Predictor on the
flagship binary ResNet-18 (32x32, 10 classes), with the QAT weights, BN
statistics and alphas carried across by load_jax_state."""
import copy
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import bnn_tpu
import bnn_tpu_torch as bt
from bnn_tpu.inference import Predictor as JPredictor
from bnn_tpu.ops import binarizers as jops
from bnn_tpu_torch.inference import Predictor, batched_call
from bnn_tpu_torch.ops import binarizers as tops
from bnn_tpu_torch.utils import load_jax_state


def _flat(module):
    out = {}

    def walk(prefix, d):
        for k, v in d.items():
            key = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, dict):
                walk(key, v)
            else:
                out[key] = np.asarray(v)

    walk("", nnx.to_pure_dict(nnx.state(module)))
    return out


def _randomized(flat, rng):
    """BN statistics and alphas away from their initial values, so that
    every folded ``add`` is non-zero."""
    out = dict(flat)
    for key, v in flat.items():
        leaf = key.rsplit(".", 1)[-1]
        if key.startswith("fc.") or leaf in ("kernel",):
            continue
        if leaf == "mean":
            out[key] = rng.randn(*v.shape) * 0.3
        elif leaf == "var":
            out[key] = rng.uniform(0.5, 2.0, v.shape)
        elif leaf == "scale":
            out[key] = 1.0 + rng.randn(*v.shape) * 0.3
        elif leaf == "bias":
            out[key] = rng.randn(*v.shape) * 0.3
        elif leaf == "alpha":
            out[key] = rng.uniform(0.5, 1.5, v.shape)
        out[key] = np.asarray(out[key], np.float32)
    return out


def _write_flat(module, flat):
    pure = nnx.to_pure_dict(nnx.state(module))
    for key, v in flat.items():
        d = pure
        *head, last = key.split(".")
        for p in head:
            d = d[p] if p in d else d[int(p)]
        d[last if last in d else int(last)] = jnp.asarray(v)
    state = nnx.state(module)
    nnx.replace_by_pure_dict(state, pure)
    nnx.update(module, state)


@pytest.fixture(scope="module")
def flagship():
    """(JAX QAT model, port QAT model, carried flat state, images NHWC)."""
    jm = bnn_tpu.models.resnet18(num_classes=10, rngs=nnx.Rngs(0))
    jm = bnn_tpu.prepare_binary_model(
        jm, bnn_tpu.BConfig(jops.BasicInputBinarizer, jops.BasicScaleBinarizer,
                            jops.XNORWeightBinarizer),
        ignore_layers_name=["_first_", "_last_"])
    rng = np.random.RandomState(0)
    flat = _randomized(_flat(jm), rng)
    _write_flat(jm, flat)
    tm = bt.models.resnet18(num_classes=10)
    tm = bt.prepare_binary_model(
        tm, bt.BConfig(tops.BasicInputBinarizer, tops.BasicScaleBinarizer,
                       tops.XNORWeightBinarizer),
        ignore_layers_name=["_first_", "_last_"])
    load_jax_state(tm, flat)
    images = rng.randn(10, 32, 32, 3).astype(np.float32)
    return jm, tm, flat, images


@pytest.fixture(scope="module")
def jax_logits(flagship):
    jm, _, _, images = flagship
    pred = JPredictor(jm, use_pallas=False, fuse=False, dtype=None, batch_size=8)
    return {n: np.asarray(pred(jnp.asarray(images[:n]))) for n in (3, 10)}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("fuse", [None, False])
def test_predictor_matches_jax(flagship, jax_logits, fuse):
    _, tm, _, images = flagship
    pred = Predictor(copy.deepcopy(tm), batch_size=8, device="cpu", dtype=None,
                     fuse=fuse)
    stem = type(pred.model.conv1).__name__
    assert stem == ("FusedStem" if fuse is None else "SpaceToDepthConv")
    # fused: layer4 is a stage kernel whose batch-8 fallback holds the block
    layer4 = pred.model.layer4
    block = layer4.stage[0].block if fuse is None else layer4[0]
    assert block.downsample[1].mode == "gemm"
    for n in (3, 10):  # padding one batch, and splitting into two
        got = pred(_nchw(images[:n])).numpy()
        want = jax_logits[n]
        assert got.shape == (n, 10)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_qat_forward_matches_jax(flagship):
    jm, tm, _, images = flagship
    jm.eval()
    want = np.asarray(jm(jnp.asarray(images[:4])))
    got = copy.deepcopy(tm).eval()(_nchw(images[:4])).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_bf16_predictor_runs_on_cpu(flagship):
    _, tm, _, images = flagship
    pred = Predictor(copy.deepcopy(tm), batch_size=8, device="cpu")
    out = pred(_nchw(images[:3]))
    assert out.dtype == torch.bfloat16 and out.shape == (3, 10)
    assert torch.isfinite(out.float()).all()
    # integer state is untouched by the cast
    assert pred.model.layer1.stage[0].block.conv1.w_packed.dtype == torch.int8


def test_load_jax_state_rejects_mismatches(flagship):
    _, tm, flat, _ = flagship
    model = copy.deepcopy(tm)
    missing = {k: v for k, v in flat.items() if k != "layer2.0.bn1.var"}
    with pytest.raises(ValueError, match="missing=.*layer2.0.bn1.running_var"):
        load_jax_state(model, missing)
    with pytest.raises(ValueError, match="unexpected=.*layer9.kernel"):
        load_jax_state(model, {**flat, "layer9.kernel": np.zeros(3)})
    bad = dict(flat)
    bad["fc.kernel"] = np.zeros((512, 11), np.float32)
    with pytest.raises(ValueError, match="shape mismatch=.*fc.kernel"):
        load_jax_state(model, bad)
    # nothing was written by the failed calls
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, tm.state_dict()[k])


def test_batched_call_contract():
    calls = []

    def one(xb):
        calls.append(xb.shape[0])
        return xb * 2

    x = torch.arange(5.0).reshape(5, 1)
    torch.testing.assert_close(batched_call(one, x, 4), x * 2)
    assert calls == [4, 4]
    with pytest.raises(ValueError, match="empty request batch"):
        batched_call(one, x[:0], 4)


def _tiny():
    return torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3))


class _FakeMesh:
    """The part of a parallel.Mesh that the Predictor's guards read."""

    def __init__(self, **shape):
        self.shape = shape

    def size(self, axis):
        return self.shape.get(axis, 1)


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(tensor_parallel=True), ValueError, "needs a mesh"),
    (dict(tensor_parallel=True, mesh=object(), fuse=True), ValueError,
     "incompatible with fuse=True"),
    (dict(binary_gemm_impl="popcount", fuse=True), ValueError,
     "incompatible with fuse=True"),
    # a batch that does not split over the mesh's data axis
    (dict(mesh=_FakeMesh(data=3), fuse=False), ValueError, "divide evenly"),
    # a serving bundle runs on the device type it is exported on
    (dict(export=("bundle", (3, 8, 8), ["cuda"])), ValueError, "device type"),
])
def test_predictor_loud_errors(kwargs, error, match, tmp_path):
    kwargs = {"batch_size": 8, "device": "cpu", **kwargs}
    export = kwargs.pop("export", None)
    with pytest.raises(error, match=match):
        pred = Predictor(_tiny(), **kwargs)
        path, shape, platforms = export
        pred.export(str(tmp_path / path), shape, platforms=platforms)


@pytest.mark.parametrize("kwargs", [dict(batch_size=4),
                                    dict(batch_size=8, max_fused_batch=8)])
def test_predictor_small_batch_fused_is_allowed(kwargs):
    pred = Predictor(_tiny(), device="cpu", dtype=None, **kwargs)
    assert pred(torch.zeros(3, 3, 8, 8)).shape == (3, 4, 6, 6)


def test_predictor_small_batch_unfused_is_allowed():
    pred = Predictor(_tiny(), batch_size=2, fuse=False, device="cpu", dtype=None)
    assert pred(torch.zeros(3, 3, 8, 8)).shape == (3, 4, 6, 6)


def test_predictor_defaults_to_cuda():
    if torch.cuda.is_available():
        assert Predictor(_tiny(), batch_size=8).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Predictor(_tiny(), batch_size=8)


def test_predictor_use_pallas_false_matches_jax(flagship, jax_logits, monkeypatch):
    """``Predictor(use_pallas=False)`` against JAX's ``Predictor(use_pallas=
    False)`` on the same weights (1e-4, as above): no fused module, every
    deployed layer flagged, and the GEMM kernels' wrappers never reached."""
    from bnn_tpu_torch.inference.deploy import DeployedConv, DeployedLinear

    tdeploy = importlib.import_module("bnn_tpu_torch.inference.deploy")

    def refuse(*args, **kwargs):
        raise AssertionError("use_pallas=False reached a kernel wrapper")

    monkeypatch.setattr(tdeploy, "binary_gemm", refuse)
    monkeypatch.setattr(tdeploy, "popcount_gemm", refuse)
    _, tm, _, images = flagship
    pred = Predictor(copy.deepcopy(tm), batch_size=8, device="cpu", dtype=None,
                     use_pallas=False)
    kinds = {type(m).__name__ for m in pred.model.modules()}
    assert not {k for k in kinds if k.startswith("Fused")}
    deployed = [m for m in pred.model.modules()
                if isinstance(m, (DeployedConv, DeployedLinear))]
    assert deployed and all(m.use_pallas is False for m in deployed)
    assert pred.model.layer4[0].downsample[1].mode == "gemm"  # reaches the GEMM
    for n in (3, 10):
        got = pred(_nchw(images[:n])).numpy()
        np.testing.assert_allclose(got, jax_logits[n], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got.argmax(1), jax_logits[n].argmax(1))


@pytest.mark.parametrize("use_pallas", [None, True, False])
def test_deploy_sets_use_pallas_on_every_layer(flagship, use_pallas):
    from bnn_tpu_torch.inference import deploy
    from bnn_tpu_torch.inference.deploy import DeployedConv, DeployedLinear

    _, tm, _, _ = flagship
    model = deploy(copy.deepcopy(tm), use_pallas=use_pallas)
    flags = [m.use_pallas for m in model.modules()
             if isinstance(m, (DeployedConv, DeployedLinear))]
    assert len(flags) == 19  # the binary body: 16 3x3 convs, 3 shortcuts
    assert set(flags) == {use_pallas is not False}


def test_popcount_layer_under_use_pallas_false_matches_jax(monkeypatch):
    """A zero_to_one dense layer on the popcount GEMM: under use_pallas=False
    it reaches popcount_gemm_reference, never the kernel's wrapper, and
    equals JAX's DeployedLinear(use_pallas=False) in popcount mode."""
    jdeploy = importlib.import_module("bnn_tpu.inference.deploy")
    from bnn_tpu.layers import Linear as JLinear
    from bnn_tpu_torch.layers import Linear as TLinear

    tdeploy = importlib.import_module("bnn_tpu_torch.inference.deploy")

    rng = np.random.RandomState(5)
    w = rng.randn(40, 70).astype(np.float32)         # (in, out), JAX's layout
    x = rng.randn(6, 40).astype(np.float32)
    x[:, ::9] = 0.0
    jcfg = bnn_tpu.BConfig(jops.BasicInputBinarizer.with_args(zero_to_one=True),
                           jops.BasicScaleBinarizer, jops.XNORWeightBinarizer)
    tcfg = bt.BConfig(tops.BasicInputBinarizer.with_args(zero_to_one=True),
                      tops.BasicScaleBinarizer, tops.XNORWeightBinarizer)
    jl = JLinear(40, 70, bconfig=jcfg, rngs=nnx.Rngs(0))
    jl.kernel[...] = jnp.asarray(w)
    tl = TLinear(40, 70, bconfig=tcfg)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w.T))
        tl.bias.copy_(torch.from_numpy(np.array(jl.bias[...])))
    jd = jdeploy.DeployedLinear(jl, use_pallas=False)
    jd.gemm_impl = "popcount"
    want = np.asarray(jd(jnp.asarray(x)))

    calls = []
    monkeypatch.setattr(tdeploy, "popcount_gemm", lambda *a: calls.append(a))
    td = tdeploy.DeployedLinear(tl, use_pallas=False)
    assert tdeploy.set_gemm_impl(td, "popcount") == [""]
    got = td(torch.from_numpy(x)).detach().numpy()
    assert not calls
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
