"""The last public names of the port against the JAX package's, on the same
inputs and weights made with numpy from a seed: the three-argument
``swap_modules_by_name``, ``named_modules`` / ``get_module_by_name``, the
reference's ``SignActivation`` Functions and ``tanh_surrogate_sign``,
``copy_paramters``, ``functional``'s conv, dense, pooling and flatten, and
``nn``'s float layers (with ``BatchNorm2d(use_fast_variance=True)``).

Tolerances: f32 sums in another order, 1e-5; signs and gradient masks
exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import bnn_tpu
import bnn_tpu_torch as bt
from bnn_tpu import functional as JF
from bnn_tpu import nn as jnn
from bnn_tpu.ops import binarizers as jops
from bnn_tpu.ops import ste as jste
from bnn_tpu_torch import functional as TF
from bnn_tpu_torch import nn as tnn
from bnn_tpu_torch.ops import binarizers as tops
from bnn_tpu_torch.ops import ste as tste
from bnn_tpu_torch.utils import load_jax_state
from test_torch_small_batch import _flat, _randomized, _write_flat
from test_torch_zoo import jax_model

TOL = 1e-5


def _to_port(a: np.ndarray) -> torch.Tensor:
    """Channels-last numpy -> channels-first tensor."""
    perm = {3: (0, 2, 1), 4: (0, 3, 1, 2)}.get(a.ndim)
    return torch.from_numpy(np.ascontiguousarray(a.transpose(perm) if perm else a))


def _to_jax_layout(t: torch.Tensor) -> np.ndarray:
    a = t.detach().numpy()
    perm = {3: (0, 2, 1), 4: (0, 2, 3, 1)}.get(a.ndim)
    return a.transpose(perm) if perm else a


# -- binarize -----------------------------------------------------------------

def _small_net(nn, rngs=None):
    kw = {} if rngs is None else {"rngs": rngs}
    return nn.Sequential(
        nn.Conv2d(3, 8, 3, padding=1, bias=False, **kw),
        nn.BatchNorm2d(8, **kw),
        nn.ReLU(),
        nn.Conv2d(8, 8, 3, stride=2, padding=1, **kw),
        nn.BatchNorm2d(8, **kw),
        nn.AdaptiveAvgPool2d(1),
        nn.Flatten(1),
        nn.Linear(8, 8, **kw),
        nn.Linear(8, 4, **kw))


def test_swap_modules_by_name_takes_the_mapping():
    jm, tm = _small_net(jnn, nnx.Rngs(0)), _small_net(tnn)
    jcfg = bnn_tpu.BConfig(jops.BasicInputBinarizer, jops.BasicScaleBinarizer,
                           jops.XNORWeightBinarizer)
    tcfg = bt.BConfig(tops.BasicInputBinarizer, tops.BasicScaleBinarizer,
                      tops.XNORWeightBinarizer)
    jrep = bnn_tpu.get_modules_to_binarize(jm, jcfg, ignore_layers_name=["_first_"])
    trep = bt.get_modules_to_binarize(tm, tcfg, ignore_layers_name=["_first_"])
    assert sorted(jrep) == sorted(trep) == ["3", "7", "8"]
    # three positional arguments, as the reference calls it
    jm = bnn_tpu.swap_modules_by_name(jm, jrep, bnn_tpu.DEFAULT_MODULE_MAPPING)
    tm = bt.swap_modules_by_name(tm, trep, bt.DEFAULT_MODULE_MAPPING)
    for name in ("3", "7", "8"):
        assert type(bt.binarize.get_module_by_name(tm, name)).__name__ == \
            type(bnn_tpu.binarize.get_module_by_name(jm, name)).__name__
    flat = _randomized(_flat(jm), np.random.RandomState(1))
    _write_flat(jm, flat)
    load_jax_state(tm, flat)
    jm.eval()
    tm.eval()
    x = np.random.RandomState(2).randn(2, 8, 8, 3).astype(np.float32)
    want = np.asarray(jm(jnp.asarray(x)))
    with torch.no_grad():
        got = tm(_to_port(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_prepare_binary_model_passes_its_mapping_on(monkeypatch):
    seen = []
    real = bt.binarize.swap_modules_by_name
    monkeypatch.setattr(bt.binarize, "swap_modules_by_name",
                        lambda m, r, mapping: seen.append(mapping) or real(m, r, mapping))
    cfg = bt.BConfig(tops.BasicInputBinarizer, tops.BasicScaleBinarizer,
                     tops.XNORWeightBinarizer)
    bt.prepare_binary_model(_small_net(tnn), cfg, bt.DEFAULT_MODULE_MAPPING)
    assert seen == [bt.DEFAULT_MODULE_MAPPING]


def test_named_modules_and_get_module_by_name_match_jax():
    jm = jax_model(lambda: bnn_tpu.models.resnet18(num_classes=10, rngs=nnx.Rngs(0)))
    tm = bt.models.resnet18(num_classes=10)
    jnames = [n for n, _ in bnn_tpu.named_modules(jm)]
    tnames = [n for n, _ in bt.named_modules(tm)]
    assert tnames == jnames
    for name in ("layer2.0.downsample.1", "layer4.1.conv2", "fc"):
        assert type(bt.binarize.get_module_by_name(tm, name)).__name__ == \
            type(bnn_tpu.binarize.get_module_by_name(jm, name)).__name__
    assert bt.Identity is tops.Identity and "Identity" in bt.__all__


# -- ops ---------------------------------------------------------------------

def _ste_input(seed=0):
    """Values on both sides of +-1 and of 0, with exact zeros and +-1."""
    x = (np.random.RandomState(seed).randn(6, 7) * 1.5).astype(np.float32)
    flat = x.reshape(-1)
    flat[::5], flat[1::7], flat[2::9] = 0.0, 1.0, -1.0
    return x


def _torch_vjp(fn, x, g, *extra):
    xt = torch.from_numpy(x).requires_grad_()
    y = fn(xt, *extra)
    y.backward(torch.from_numpy(g))
    return y.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("call", ["apply", "instance"])
def test_sign_activation_matches_sign_ste(call):
    x = _ste_input()
    g = np.random.RandomState(3).randn(*x.shape).astype(np.float32)
    fn = tste.SignActivation.apply if call == "apply" else bt.ops.SignActivation()
    got_y, got_g = _torch_vjp(fn, x, g)
    want_y, vjp = jax.vjp(jste.sign_ste, jnp.asarray(x))
    np.testing.assert_array_equal(got_y, np.asarray(want_y))
    np.testing.assert_array_equal(got_g, np.asarray(vjp(jnp.asarray(g))[0]))


@pytest.mark.parametrize("call", ["apply", "instance"])
def test_sign_activation_stochastic_matches_jax(call):
    """Values in {-1, +1} and JAX's gradient mask; the draws differ between
    the two generators, so the values are checked by their range."""
    x = _ste_input(1)
    g = np.random.RandomState(4).randn(*x.shape).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    fn = (tste.SignActivationStochastic.apply if call == "apply"
          else bt.ops.SignActivationStochastic())
    got_y, got_g = _torch_vjp(fn, x, g, gen)
    _, vjp = jax.vjp(lambda v: jste.stochastic_sign_ste(v, jax.random.key(0)),
                     jnp.asarray(x))
    assert set(np.unique(got_y)) <= {-1.0, 1.0}
    np.testing.assert_array_equal(got_y[x >= 1.0], 1.0)
    np.testing.assert_array_equal(got_y[x <= -1.0], -1.0)
    np.testing.assert_array_equal(got_g, np.asarray(vjp(jnp.asarray(g))[0]))
    # the functional form draws the same noise from the same generator
    again = tste.stochastic_sign_ste(torch.from_numpy(x),
                                     torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(again.numpy(), got_y)


def test_tanh_surrogate_sign_matches_jax():
    x = _ste_input(2) * 0.3
    g = np.random.RandomState(5).randn(*x.shape).astype(np.float32)
    got_y, got_g = _torch_vjp(tste.tanh_surrogate_sign, x, g)
    want_y, vjp = jax.vjp(jste.tanh_surrogate_sign, jnp.asarray(x))
    np.testing.assert_array_equal(got_y, np.asarray(want_y))
    np.testing.assert_allclose(got_g, np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=TOL, atol=TOL)


def test_copy_paramters_carries_alpha_as_jax_does():
    from bnn_tpu.layers import Linear as JLinear
    from bnn_tpu.layers.helpers import copy_paramters as jcopy
    from bnn_tpu_torch.layers import Linear as TLinear
    from bnn_tpu_torch.layers.helpers import copy_parameters, copy_paramters

    assert copy_paramters is copy_parameters
    alpha = np.random.RandomState(6).uniform(0.5, 1.5, 5).astype(np.float32)
    jcfg = bnn_tpu.BConfig(jops.BasicInputBinarizer, jops.BasicScaleBinarizer,
                           jops.XNORWeightBinarizer)
    tcfg = bt.BConfig(tops.BasicInputBinarizer, tops.BasicScaleBinarizer,
                      tops.XNORWeightBinarizer)
    jsrc, jdst = (JLinear(4, 5, bconfig=jcfg, rngs=nnx.Rngs(i)) for i in (0, 1))
    tsrc, tdst = TLinear(4, 5, bconfig=tcfg), TLinear(4, 5, bconfig=tcfg)
    jsrc.activation_post_process.alpha[...] = jnp.asarray(alpha).reshape(
        jsrc.activation_post_process.alpha[...].shape)
    with torch.no_grad():
        tsrc.activation_post_process.alpha.copy_(
            torch.from_numpy(alpha).reshape(tsrc.activation_post_process.alpha.shape))
    jcopy(jsrc, jdst, jcfg)
    copy_paramters(tsrc, tdst, tcfg)
    np.testing.assert_array_equal(
        tdst.activation_post_process.alpha.detach().numpy().reshape(-1),
        np.asarray(jdst.activation_post_process.alpha[...]).reshape(-1))


# -- functional ---------------------------------------------------------------

@pytest.mark.parametrize("shape,kernel,kw", [
    ((2, 9, 11, 3), (3, 3, 3, 5), dict(padding="same")),
    ((2, 9, 11, 3), (3, 3, 3, 5), dict(stride=2, padding="same")),
    ((2, 10, 8, 4), (3, 3, 2, 6), dict(stride=(2, 1), padding=1, dilation=2, groups=2)),
    ((2, 12, 3), (5, 3, 4), dict(stride=2, padding="valid")),
])
def test_conv_matches_jax(shape, kernel, kw):
    rng = np.random.RandomState(len(shape) + kernel[0])
    x = rng.randn(*shape).astype(np.float32)
    w = rng.randn(*kernel).astype(np.float32)
    want = np.asarray(JF.conv(jnp.asarray(x), jnp.asarray(w), **kw))
    wt = torch.from_numpy(np.ascontiguousarray(
        w.transpose((3, 2, 0, 1) if w.ndim == 4 else (2, 1, 0))))
    got = _to_jax_layout(TF.conv(_to_port(x), wt, **kw))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_conv_preferred_element_type_and_linear_match_jax():
    rng = np.random.RandomState(7)
    x = rng.randn(2, 6, 6, 3).astype(np.float32)
    w = rng.randn(3, 3, 3, 4).astype(np.float32)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = np.asarray(JF.conv(xb, wb, padding=1,
                              preferred_element_type=jnp.float32))
    xt = _to_port(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    wt = torch.from_numpy(np.asarray(wb.astype(jnp.float32)).transpose(3, 2, 0, 1)
                          .copy()).to(torch.bfloat16)
    got = TF.conv(xt, wt, padding=1, preferred_element_type=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_to_jax_layout(got), want, rtol=TOL, atol=TOL)
    a, k, b = rng.randn(5, 7), rng.randn(7, 3), rng.randn(3)
    a, k, b = (v.astype(np.float32) for v in (a, k, b))
    for bias in (b, None):
        want = np.asarray(JF.linear(jnp.asarray(a), jnp.asarray(k),
                                    None if bias is None else jnp.asarray(bias)))
        got = TF.linear(torch.from_numpy(a), torch.from_numpy(k.T.copy()),
                        None if bias is None else torch.from_numpy(bias)).numpy()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape,args", [
    ((2, 7, 9, 3), dict(kernel_size=3, stride=2, padding=1)),
    ((2, 7, 9, 3), dict(kernel_size=3, stride=2, padding=1, ceil_mode=True)),
    ((2, 7, 9, 3), dict(kernel_size=3, stride=2, padding=1,
                        count_include_pad=False)),
    ((2, 7, 9, 3), dict(kernel_size=2, stride=2, ceil_mode=True,
                        count_include_pad=False)),
    ((2, 11, 3), dict(kernel_size=3, stride=2, padding=1, ceil_mode=True)),
])
def test_avg_pool_matches_jax(shape, args):
    x = np.random.RandomState(8).randn(*shape).astype(np.float32)
    want = np.asarray(JF.avg_pool(jnp.asarray(x), **args))
    got = _to_jax_layout(TF.avg_pool(_to_port(x), **args))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape,out", [((2, 7, 5, 3), (3, 2)), ((2, 8, 8, 3), 2),
                                       ((2, 6, 6, 3), 1), ((2, 10, 3), 4)])
def test_adaptive_avg_pool_and_flatten_match_jax(shape, out):
    x = np.random.RandomState(9).randn(*shape).astype(np.float32)
    want = np.asarray(JF.adaptive_avg_pool(jnp.asarray(x), out))
    got = _to_jax_layout(TF.adaptive_avg_pool(_to_port(x), out))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # flatten is layout-free: the same array on both sides
    for start in (1, 2):
        np.testing.assert_array_equal(
            TF.flatten(torch.from_numpy(x), start).numpy(),
            np.asarray(JF.flatten(jnp.asarray(x), start)))


# -- nn --------------------------------------------------------------------

_LAYERS = {
    # name: (build(nn, rngs kwargs), JAX-layout input shape)
    "Conv1d": (lambda nn, kw: nn.Conv1d(3, 5, 3, stride=2, padding=1, **kw), (2, 9, 3)),
    "Conv2d": (lambda nn, kw: nn.Conv2d(3, 4, 3, padding="same", dilation=2, **kw),
               (2, 7, 6, 3)),
    "Linear": (lambda nn, kw: nn.Linear(6, 4, **kw), (3, 6)),
    "AvgPool2d": (lambda nn, kw: nn.AvgPool2d(3, stride=2, padding=1, ceil_mode=True,
                                              count_include_pad=False), (2, 8, 7, 3)),
    "AdaptiveAvgPool2d": (lambda nn, kw: nn.AdaptiveAvgPool2d((3, 2)), (2, 7, 5, 3)),
    "MaxPool1d": (lambda nn, kw: nn.MaxPool1d(3, 2, 1), (2, 9, 3)),
    "Flatten": (lambda nn, kw: nn.Flatten(1), (2, 1, 1, 6)),
    "Identity": (lambda nn, kw: nn.Identity(), (2, 4, 4, 3)),
    "ReLU": (lambda nn, kw: nn.ReLU(), (2, 4, 4, 3)),
    "PReLU": (lambda nn, kw: nn.PReLU(num_parameters=3, init=0.1, **kw), (2, 4, 4, 3)),
    "Hardtanh": (lambda nn, kw: nn.Hardtanh(-0.5, 0.7), (2, 4, 4, 3)),
    "Tanh": (lambda nn, kw: nn.Tanh(), (2, 4, 4, 3)),
}


@pytest.mark.parametrize("name", sorted(_LAYERS))
def test_float_layer_matches_jax(name):
    build, shape = _LAYERS[name]
    needs_rngs = name in ("Conv1d", "Conv2d", "Linear", "PReLU")
    jm = build(jnn, {"rngs": nnx.Rngs(0)} if needs_rngs else {})
    tm = build(tnn, {})
    flat = {k: v for k, v in _flat(jm).items()}
    if flat:
        rng = np.random.RandomState(10)
        flat = {k: rng.randn(*v.shape).astype(np.float32) for k, v in flat.items()}
        _write_flat(jm, flat)
        load_jax_state(tm, flat)
    x = np.random.RandomState(11).randn(*shape).astype(np.float32)
    x.reshape(-1)[::4] = 0.0  # PReLU's and ReLU's kink, exact
    want = np.asarray(jm(jnp.asarray(x)))
    with torch.no_grad():
        got = _to_jax_layout(tm(_to_port(x)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("container", ["Sequential", "ModuleList"])
def test_containers_hold_the_same_names(container):
    def build(nn, kw):
        layers = [nn.Linear(3, 3, **kw), nn.ReLU(), nn.Sequential(nn.Tanh(), nn.Identity())]
        return nn.Sequential(*layers) if container == "Sequential" else nn.ModuleList(layers)

    jm, tm = build(jnn, {"rngs": nnx.Rngs(0)}), build(tnn, {})
    assert ([n for n, _ in bt.named_modules(tm)]
            == [n for n, _ in bnn_tpu.named_modules(jm)]
            == ["", "0", "1", "2", "2.0", "2.1"])
    assert type(tm) is getattr(torch.nn, container)


@pytest.mark.parametrize("fast", [True, False])
def test_batch_norm_variance_forms_match_jax(fast):
    rng = np.random.RandomState(12)
    x = (rng.randn(4, 5, 3, 6) * 3.0 + 2.0).astype(np.float32)
    jm = jnn.BatchNorm2d(6, use_fast_variance=fast, rngs=nnx.Rngs(0))
    tm = tnn.BatchNorm2d(6, use_fast_variance=fast)
    flat = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
            "bias": rng.randn(6).astype(np.float32),
            "mean": np.zeros(6, np.float32), "var": np.ones(6, np.float32)}
    _write_flat(jm, flat)
    load_jax_state(tm, flat)
    jm.train()
    tm.train()
    want = np.asarray(jm(jnp.asarray(x)))
    got = _to_jax_layout(tm(_to_port(x)).detach())
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    state = _flat(jm)
    np.testing.assert_allclose(tm.running_var.numpy(), state["var"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tm.running_mean.numpy(), state["mean"], rtol=TOL, atol=TOL)
