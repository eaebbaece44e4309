"""bnn_tpu_torch.inference (deploy, BN folds, stem rewrites) against
bnn_tpu.inference on the same QAT weights, carried across with
load_jax_state. The JAX GEMM paths run the Pallas kernel in interpret mode;
the port takes its plain versions on the CPU."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import bnn_tpu
import bnn_tpu_torch as bt
from bnn_tpu import layers as jlayers
from bnn_tpu.inference import optimize as joptimize
from bnn_tpu.inference import stem as jstem
from bnn_tpu.ops import binarizers as jops
from bnn_tpu_torch import layers as tlayers
from bnn_tpu_torch.inference import optimize as toptimize
from bnn_tpu_torch.inference import stem as tstem
from bnn_tpu_torch.ops import binarizers as tops
from bnn_tpu_torch.utils import load_jax_state

# the packages re-export the function deploy() under the module's name
jdeploy = importlib.import_module("bnn_tpu.inference.deploy")
tdeploy = importlib.import_module("bnn_tpu_torch.inference.deploy")


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


def _bconfigs(zero_to_one):
    jb = bnn_tpu.BConfig(jops.BasicInputBinarizer.with_args(zero_to_one=zero_to_one),
                         jops.BasicScaleBinarizer, jops.XNORWeightBinarizer)
    tb = bt.BConfig(tops.BasicInputBinarizer.with_args(zero_to_one=zero_to_one),
                    tops.BasicScaleBinarizer, tops.XNORWeightBinarizer)
    return jb, tb


def _randomize_alpha(jlayer, rng):
    a = jlayer.activation_post_process.alpha
    a[...] = jnp.asarray(rng.uniform(0.5, 1.5, a[...].shape), jnp.float32)


def _conv_pair(cin, cout, k, stride, padding, zero_to_one, seed, bias=True):
    rng = np.random.RandomState(seed)
    jb, tb = _bconfigs(zero_to_one)
    jl = jlayers.Conv2d(cin, cout, k, stride, padding, bias=bias, bconfig=jb,
                        rngs=nnx.Rngs(seed))
    _randomize_alpha(jl, rng)
    tl = tlayers.Conv2d(cin, cout, k, stride, padding, bias=bias, bconfig=tb)
    load_jax_state(tl, _flat(jl))
    return jl, tl


def _activations(rng, shape):
    # ReLU-like input: about half exact zeros, where sign(0) conventions differ
    return np.maximum(rng.randn(*shape), 0.0).astype(np.float32)


def _unit_epilogue(jd, td):
    jd.scale[...] = jnp.ones_like(jd.scale[...])
    jd.add[...] = jnp.zeros_like(jd.add[...])
    td.scale = torch.ones_like(td.scale)
    td.add = torch.zeros_like(td.add)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


_CONV_CASES = [
    # (cin, cout, k, stride, padding, mode, weight_format, zero_to_one)
    (8, 16, 3, 1, 1, "conv", "int8", False),
    (8, 16, 3, 2, 1, "conv", "packed", False),
    (40, 16, 3, 1, 1, "conv", "packed", True),
    (8, 16, 3, 2, 1, "im2col", "packed", False),
    (40, 24, 3, 1, 1, "im2col", "int8", True),
    (256, 32, 1, 1, 0, "auto", "int8", False),   # auto -> gemm
    (300, 16, 1, 1, 0, "gemm", "packed", True),
]


@pytest.mark.parametrize("case", _CONV_CASES, ids=lambda c: "-".join(map(str, c)))
def test_deployed_conv_matches_jax(case):
    cin, cout, k, stride, padding, mode, fmt, z21 = case
    seed = cin + cout + k + stride
    jl, tl = _conv_pair(cin, cout, k, stride, padding, z21, seed)
    x = _activations(np.random.RandomState(seed), (2, 6, 6, cin))
    jd = jdeploy.DeployedConv(jl, use_pallas=mode != "conv", interpret=True,
                              mode=mode, weight_format=fmt)
    td = tdeploy.DeployedConv(tl, mode=mode, weight_format=fmt)
    assert td.mode == jd.mode
    assert td.k == jd.k
    want = np.asarray(jd(jnp.asarray(x)))
    got = _nhwc(td(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the QAT layer computes the same function (up to f32 rounding)
    np.testing.assert_allclose(got, np.asarray(jl(jnp.asarray(x))),
                               rtol=1e-4, atol=1e-4)
    _unit_epilogue(jd, td)
    np.testing.assert_array_equal(_nhwc(td(_nchw(x))),
                                  np.asarray(jd(jnp.asarray(x))))


@pytest.mark.parametrize("kind", ["conv1d", "grouped"])
def test_deployed_conv_variants_match_jax(kind):
    rng = np.random.RandomState(61)
    jb, tb = _bconfigs(False)
    if kind == "conv1d":
        jl = jlayers.Conv1d(8, 12, 3, 1, 1, bconfig=jb, rngs=nnx.Rngs(1))
        tl = tlayers.Conv1d(8, 12, 3, 1, 1, bconfig=tb)
        x = _activations(rng, (2, 9, 8))
        to_t = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1)))
        from_t = lambda t: t.detach().permute(0, 2, 1).numpy()
        modes = ("conv", "im2col")
    else:  # grouped convs deploy in conv mode only
        jl = jlayers.Conv2d(8, 12, 3, 1, 1, groups=2, bconfig=jb, rngs=nnx.Rngs(1))
        tl = tlayers.Conv2d(8, 12, 3, 1, 1, groups=2, bconfig=tb)
        x = _activations(rng, (2, 6, 6, 8))
        to_t, from_t = _nchw, _nhwc
        modes = ("conv",)
        with pytest.raises(NotImplementedError, match="grouped"):
            tdeploy.DeployedConv(tl, mode="im2col")
    _randomize_alpha(jl, rng)
    load_jax_state(tl, _flat(jl))
    for mode in modes:
        jd = jdeploy.DeployedConv(jl, use_pallas=mode != "conv", interpret=True,
                                  mode=mode)
        td = tdeploy.DeployedConv(tl, mode=mode)
        np.testing.assert_allclose(from_t(td(to_t(x))), np.asarray(jd(jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-6)


def test_deployed_weight_words_equal_jax():
    jl, tl = _conv_pair(40, 16, 3, 1, 1, False, seed=7)
    jd = jdeploy.DeployedConv(jl, use_pallas=False, mode="conv")
    td = tdeploy.DeployedConv(tl, mode="conv")
    # (O, ceil(I/32), kh, kw) words in the port, (kh, kw, ceil(I/32), O) in JAX
    np.testing.assert_array_equal(
        td.w_packed.numpy().transpose(2, 3, 1, 0).view(np.uint32),
        np.asarray(jd.w_packed[...]))
    jd = jdeploy.DeployedConv(jl, use_pallas=False, mode="im2col")
    td = tdeploy.DeployedConv(tl, mode="im2col")
    np.testing.assert_array_equal(td.w_packed.numpy().view(np.uint32),
                                  np.asarray(jd.w_packed[...]))


@pytest.mark.parametrize("zero_to_one", [False, True])
def test_deployed_linear_matches_jax(zero_to_one):
    rng = np.random.RandomState(11)
    jb, tb = _bconfigs(zero_to_one)
    jl = jlayers.Linear(70, 24, bconfig=jb, rngs=nnx.Rngs(3))
    _randomize_alpha(jl, rng)
    tl = tlayers.Linear(70, 24, bconfig=tb)
    load_jax_state(tl, _flat(jl))
    x = _activations(rng, (5, 70))
    jd = jdeploy.DeployedLinear(jl, use_pallas=True, interpret=True)
    td = tdeploy.DeployedLinear(tl)
    np.testing.assert_array_equal(td.w_packed.numpy().view(np.uint32),
                                  np.asarray(jd.w_packed[...]))
    want = np.asarray(jd(jnp.asarray(x)))
    np.testing.assert_allclose(td(torch.from_numpy(x)).detach().numpy(), want,
                               rtol=1e-6, atol=1e-6)
    _unit_epilogue(jd, td)
    np.testing.assert_array_equal(td(torch.from_numpy(x)).detach().numpy(),
                                  np.asarray(jd(jnp.asarray(x))))


def _bn_pair(c, seed):
    rng = np.random.RandomState(seed)
    jbn = bnn_tpu.nn.BatchNorm2d(c, rngs=nnx.Rngs(0))
    jbn.scale[...] = jnp.asarray(rng.randn(c) * 0.5 + 1.0, jnp.float32)
    jbn.bias[...] = jnp.asarray(rng.randn(c) * 0.3, jnp.float32)
    jbn.mean[...] = jnp.asarray(rng.randn(c) * 0.3, jnp.float32)
    jbn.var[...] = jnp.asarray(rng.uniform(0.5, 2.0, c), jnp.float32)
    jbn.eval()
    tbn = torch.nn.BatchNorm2d(c)
    load_jax_state(tbn, _flat(jbn))
    return jbn, tbn.eval()


@pytest.mark.parametrize("mode", ["conv", "im2col"])
def test_fold_bn_after_matches_jax(mode):
    jl, tl = _conv_pair(8, 16, 3, 1, 1, False, seed=21)
    jbn, tbn = _bn_pair(16, seed=22)
    jd = jdeploy.DeployedConv(jl, use_pallas=mode != "conv", interpret=True, mode=mode)
    td = tdeploy.DeployedConv(tl, mode=mode)
    assert joptimize.fold_bn_after(jd, jbn)
    assert toptimize.fold_bn_after(td, tbn)
    np.testing.assert_allclose(td.scale.numpy(), np.asarray(jd.scale[...]), rtol=1e-6)
    np.testing.assert_allclose(td.add.numpy(), np.asarray(jd.add[...]),
                               rtol=1e-6, atol=1e-6)
    x = _activations(np.random.RandomState(23), (2, 6, 6, 8))
    np.testing.assert_allclose(_nhwc(td(_nchw(x))), np.asarray(jd(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    # a width mismatch is container adjacency, not data flow: no fold
    assert not toptimize.fold_bn_after(td, torch.nn.BatchNorm2d(8).eval())


@pytest.mark.parametrize("mode,fmt", [("conv", "int8"), ("conv", "packed"),
                                      ("im2col", "packed")])
def test_fold_bn_before_matches_jax(mode, fmt):
    jl, tl = _conv_pair(8, 16, 3, 1, 1, False, seed=31)
    jbn, tbn = _bn_pair(8, seed=32)
    # some negative gammas exercise the weight flips
    jbn.scale[...] = jbn.scale[...] * jnp.asarray(np.where(np.arange(8) % 3, 1, -1),
                                                  jnp.float32)
    load_jax_state(tbn, _flat(jbn))
    jd = jdeploy.DeployedConv(jl, use_pallas=mode != "conv", interpret=True,
                              mode=mode, weight_format=fmt)
    td = tdeploy.DeployedConv(tl, mode=mode, weight_format=fmt)
    x = np.random.RandomState(33).randn(2, 6, 6, 8).astype(np.float32)
    jref = np.asarray(jd(jbn(jnp.asarray(x))))
    assert joptimize.fold_bn_before(jbn, jd)
    assert toptimize.fold_bn_before(tbn, td)
    np.testing.assert_allclose(td.threshold.numpy(), np.asarray(jd.threshold[...]),
                               rtol=1e-6, atol=1e-6)
    got = _nhwc(td(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(jd(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, jref, rtol=1e-5, atol=1e-5)
    assert not toptimize.fold_bn_before(tbn, td)  # already folded


def _bn1d_models(kind, seed):
    """(JAX model, port model, input of the JAX layout, torch <- JAX layout)
    for the three BatchNorm1d folds, from the same numpy-seeded weights."""
    rng = np.random.RandomState(seed)
    r = nnx.Rngs(seed)
    jn, tn = bnn_tpu.nn, torch.nn
    if kind == "linear-linear-bn":  # the model of ROADMAP queue 3, item 1
        jm = jn.Sequential(jn.Linear(64, 64, rngs=r), jn.Linear(64, 32, rngs=r),
                           jn.BatchNorm1d(32, rngs=r))
        tm = tn.Sequential(tn.Linear(64, 64), tn.Linear(64, 32), tn.BatchNorm1d(32))
        x, to_t, ignore = rng.randn(5, 64), torch.from_numpy, ["_first_"]
    else:
        # (N, L, C) in JAX, (N, C, L) in the port
        to_t = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1)))
        if kind == "conv1d-bn":  # a float and a deployed Conv1d, each then a BN
            jm = jn.Sequential(jn.Conv1d(4, 8, 3, 1, 1, rngs=r), jn.BatchNorm1d(8, rngs=r),
                               jn.Conv1d(8, 12, 3, 1, 1, rngs=r),
                               jn.BatchNorm1d(12, rngs=r))
            tm = tn.Sequential(tn.Conv1d(4, 8, 3, 1, 1), tn.BatchNorm1d(8),
                               tn.Conv1d(8, 12, 3, 1, 1), tn.BatchNorm1d(12))
            x, ignore = rng.randn(2, 9, 4), ["_first_"]
        else:  # "bn-conv1d": the BN-before fold into a deployed Conv1d
            jm = jn.Sequential(jn.BatchNorm1d(8, rngs=r), jn.Conv1d(8, 12, 3, 1, 1, rngs=r))
            tm = tn.Sequential(tn.BatchNorm1d(8), tn.Conv1d(8, 12, 3, 1, 1))
            x, ignore = rng.randn(2, 9, 8), []
    jb, tb = _bconfigs(False)
    jm = bnn_tpu.prepare_binary_model(jm, jb, ignore_layers_name=ignore)
    tm = bt.prepare_binary_model(tm, tb, ignore_layers_name=ignore)
    for _, m in bnn_tpu.binarize.named_modules(jm):
        if isinstance(m, jn.BatchNorm1d):
            c = m.mean[...].shape[0]
            # negative gammas on every third channel exercise the weight flips
            m.scale[...] = jnp.asarray((rng.randn(c) * 0.5 + 1.0)
                                       * np.where(np.arange(c) % 3, 1, -1), jnp.float32)
            m.bias[...] = jnp.asarray(rng.randn(c) * 0.3, jnp.float32)
            m.mean[...] = jnp.asarray(rng.randn(c) * 0.3, jnp.float32)
            m.var[...] = jnp.asarray(rng.uniform(0.5, 2.0, c), jnp.float32)
        elif isinstance(m, (jlayers.Linear, jlayers.Conv1d)):
            _randomize_alpha(m, rng)
    load_jax_state(tm, _flat(jm))
    jm.eval()
    return jm, tm.eval(), x.astype(np.float32), to_t


@pytest.mark.parametrize("kind,folds", [("linear-linear-bn", 1), ("conv1d-bn", 2),
                                        ("bn-conv1d", 1)])
def test_optimize_folds_batchnorm1d_as_jax(kind, folds):
    """``BatchNorm1d`` is the JAX package's ``BatchNorm2d``, so both fold it:
    after a deployed and a float layer, and before a deployed conv."""
    jm, tm, x, to_t = _bn1d_models(kind, seed=len(kind))
    jd = jdeploy.deploy(jm, use_pallas=True, interpret=True)
    td = tdeploy.deploy(tm)
    want_unfolded = np.asarray(jd(jnp.asarray(x)))
    got_unfolded = td(to_t(x)).detach()
    assert joptimize.optimize_deployed(jd) == folds
    assert toptimize.optimize_deployed(td) == folds
    for jl, tl in zip(jd, td):
        assert isinstance(tl, torch.nn.Identity) == isinstance(jl, bnn_tpu.nn.Identity)
        assert not isinstance(tl, torch.nn.BatchNorm1d)
    want = np.asarray(jd(jnp.asarray(x)))
    got = td(to_t(x)).detach()
    from_t = (lambda t: t.numpy()) if got.ndim == 2 else (lambda t: t.permute(0, 2, 1).numpy())
    np.testing.assert_allclose(from_t(got), want, rtol=1e-5, atol=1e-5)
    # the fold keeps what each package computed before it
    np.testing.assert_allclose(from_t(got), from_t(got_unfolded), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(want, want_unfolded, rtol=1e-5, atol=1e-5)


def _stem_models(seed):
    jm = bnn_tpu.models.resnet18(num_classes=10, rngs=nnx.Rngs(seed))
    tm = bt.models.resnet18(num_classes=10)
    jbn, _ = _bn_pair(64, seed)
    for leaf in ("scale", "bias", "mean", "var"):
        getattr(jm.bn1, leaf)[...] = getattr(jbn, leaf)[...]
    load_jax_state(tm, _flat(jm))
    jm.eval()
    return jm, tm.eval()


@pytest.mark.parametrize("shape", [(1, 32, 32, 3), (1, 32, 28, 3), (2, 24, 20, 3),
                                   (9, 16, 16, 3)])
def test_fused_stem_module_matches_jax(shape):
    """FusedStem routes the v3, v2 and v1 branches to one kernel, and a batch
    above max_batch to the unfused chain."""
    jm, tm = _stem_models(seed=41)
    assert jstem.space_to_depth_stem(jm) == tstem.space_to_depth_stem(tm) == 1
    assert jstem.fuse_stem(jm, interpret=True) == tstem.fuse_stem(tm) == 1
    assert isinstance(tm.conv1, tstem.FusedStem)
    assert isinstance(tm.bn1, torch.nn.Identity) and isinstance(tm.maxpool, torch.nn.Identity)
    x = np.random.RandomState(42).randn(*shape).astype(np.float32)
    np.testing.assert_allclose(_nhwc(tm.conv1(_nchw(x))),
                               np.asarray(jm.conv1(jnp.asarray(x))),
                               rtol=1e-4, atol=1e-4)
    assert tstem.fuse_stem(tm) == 0  # idempotent


def test_space_to_depth_conv_matches_jax():
    jm, tm = _stem_models(seed=43)
    jconv, tconv = jstem.SpaceToDepthConv(jm.conv1), tstem.SpaceToDepthConv(tm.conv1)
    x = np.random.RandomState(44).randn(2, 18, 14, 3).astype(np.float32)
    want = np.asarray(jconv(jnp.asarray(x)))
    np.testing.assert_allclose(_nhwc(tconv(_nchw(x))), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_nhwc(tm.conv1(_nchw(x))), want, rtol=1e-4, atol=1e-4)


def test_loud_errors():
    with pytest.raises(ValueError, match="SpaceToDepthConv requires"):
        tstem.SpaceToDepthConv(torch.nn.Conv2d(3, 8, 3, stride=1))
    with pytest.raises(ValueError, match="SpaceToDepthConv requires"):
        tstem.SpaceToDepthConv(torch.nn.Conv2d(3, 8, 3, stride=2, dilation=2))
    with pytest.raises(ValueError, match="FusedStem requires"):
        tstem.FusedStem(torch.nn.Conv2d(3, 64, 5, stride=2, padding=2))
    with pytest.raises(ValueError, match="FusedStem requires"):
        tstem.FusedStem(torch.nn.Conv2d(8, 64, 7, stride=2, padding=3))
    _, tl = _conv_pair(8, 16, 3, 2, 1, False, seed=51)
    with pytest.raises(ValueError, match="stride-1"):
        tdeploy.DeployedConv(tl, mode="pallas-conv")
    model = tdeploy.deploy(torch.nn.Sequential(tl))
    assert tdeploy.set_gemm_impl(model, "popcount") == []  # a ternary 3x3
    with pytest.raises(ValueError, match="unknown gemm impl"):
        tdeploy.set_gemm_impl(model, "mxm")
    assert tdeploy.set_gemm_impl(model, "mxu") == []
