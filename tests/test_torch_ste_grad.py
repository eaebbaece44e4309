"""The port's straight-through estimators and binarizer backwards against
jax.grad through bnn_tpu.ops on the same inputs (numpy, from a seed), and
the stochastic binarizer's own stream on the input's device."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from bnn_tpu.ops import binarizers as jops
from bnn_tpu.ops import ste as jste
from bnn_tpu_torch.ops import binarizers as tops
from bnn_tpu_torch.ops import ste as tste

TOL = 1e-6


def _x(shape, seed=0):
    """Values on both sides of +-1 and of 0, with exact zeros and +-1."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 1.5).astype(np.float32)
    flat = x.reshape(-1)
    flat[::7] = 0.0
    flat[1::11] = 1.0
    flat[2::13] = -1.0
    return x


def _grads(jfn, tfn, *arrays, seed=1):
    """Gradients of sum(f(*arrays) * r), r a fixed cotangent, in both
    packages; ``arrays`` are numpy in the layout both functions take."""
    out = np.asarray(jfn(*map(jnp.asarray, arrays)))
    r = np.random.RandomState(seed).randn(*out.shape).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jfn(*a) * r), argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]
    tout = tfn(*ts)
    np.testing.assert_allclose(tout.detach().numpy(), out, rtol=TOL, atol=TOL)
    (tout * torch.from_numpy(r)).sum().backward()
    return [np.asarray(g) for g in jg], [t.grad.numpy() for t in ts]


def _assert_same(jg, tg):
    """Each gradient within TOL of JAX's, as max |diff| over max |JAX|."""
    for a, b in zip(jg, tg):
        assert a.shape == b.shape
        assert np.abs(b - a).max() <= TOL * max(np.abs(a).max(), 1.0), \
            np.abs(b - a).max()


@pytest.mark.parametrize("zero_to_one", [False, True])
def test_basic_input_binarizer_grad(zero_to_one):
    jb = jops.BasicInputBinarizer(zero_to_one=zero_to_one)
    tb = tops.BasicInputBinarizer(zero_to_one=zero_to_one)
    _assert_same(*_grads(jb, tb, _x((4, 6, 5))))


@pytest.mark.parametrize("funct,t", [("tanh", 5.0), ("erf", 5.0), ("softsign", 5.0),
                                     ("hardtanh", 5.0), ("sin", 5.0), ("erf", 2.5)])
def test_advanced_input_binarizer_grad(funct, t):
    """The surrogate's gradient passes through (the documented intent)."""
    jb = jops.AdvancedInputBinarizer(derivative_funct=funct, t=t)
    tb = tops.AdvancedInputBinarizer(derivative_funct=funct, t=t)
    x = _x((3, 40)) * 0.3  # inside the surrogates' sloped range
    jg, tg = _grads(jb, tb, x)
    assert np.abs(jg[0]).max() > 0
    _assert_same(jg, tg)


@pytest.mark.parametrize("center", [False, True])
def test_xnor_weight_binarizer_grad(center):
    """alpha * sign(W) (optionally centred over the in-channels): the STE
    and alpha's own gradient, torch's OIHW against JAX's HWIO."""
    w = _x((3, 3, 5, 7), seed=2) * 0.5
    jb = jops.XNORWeightBinarizer(center_weights=center)
    tb = tops.XNORWeightBinarizer(center_weights=center)
    jg, tg = _grads(jb, lambda t: tb(t.permute(3, 2, 0, 1)).permute(2, 3, 1, 0), w)
    _assert_same(jg, tg)


def test_basic_scale_binarizer_grad():
    """Gradients through alpha and through the layer output."""
    alpha = np.random.RandomState(3).uniform(0.5, 1.5, 6).astype(np.float32)
    conv = types.SimpleNamespace(out_channels=6, kernel_size=(3, 3))
    jb, tb = jops.BasicScaleBinarizer(conv), tops.BasicScaleBinarizer(conv)
    jb.alpha.value = jnp.asarray(alpha)
    with torch.no_grad():
        tb.alpha.copy_(torch.from_numpy(alpha).view(1, 6, 1, 1))
    out = _x((2, 4, 4, 6), seed=4)
    r = np.random.RandomState(5).randn(*out.shape).astype(np.float32)
    jga, jgo = nnx.grad(lambda m, o: jnp.sum(m(o) * r), argnums=(0, 1))(
        jb, jnp.asarray(out))
    ot = torch.from_numpy(out).permute(0, 3, 1, 2).requires_grad_(True)
    y = tb(ot)
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(jb(jnp.asarray(out))), rtol=TOL)
    (y * torch.from_numpy(r).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(ot.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jgo),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tb.alpha.grad.reshape(-1).numpy(),
                               np.asarray(jga.alpha[...]), rtol=TOL, atol=1e-5)


@pytest.mark.parametrize("padding", [1, "same"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dilation", [1, 2])
def test_xnor_scale_binarizer_grad(dilation, stride, padding):
    """The dilation-aware XNOR spatial scale: gradients to the layer input
    (through mean |x| and the averaging conv) and to the layer output."""
    geom = dict(kernel_size=(3, 3), stride=(stride, stride), padding=padding,
                dilation=(dilation, dilation))
    jb = jops.XNORScaleBinarizer(types.SimpleNamespace(**geom))
    tb = tops.XNORScaleBinarizer(types.SimpleNamespace(**geom))
    x = _x((2, 9, 9, 4), seed=5)
    k = jnp.ones((3, 3, 4, 6), jnp.float32)
    out_shape = jax.lax.conv_general_dilated(
        jnp.asarray(x), k, (stride, stride),
        padding if padding == "same" else [(padding, padding)] * 2,
        rhs_dilation=(dilation, dilation),
        dimension_numbers=("NHWC", "HWIO", "NHWC")).shape
    out = _x(out_shape, seed=6)
    jg, tg = _grads(
        lambda o, i: jb(o, i),
        lambda o, i: tb(o.permute(0, 3, 1, 2), i.permute(0, 3, 1, 2)).permute(0, 2, 3, 1),
        out, x)
    _assert_same(jg, tg)


def test_stochastic_ste_on_given_noise():
    """round(clip((x+1)/2 + noise)) to {-1, +1} on the same noise, and the
    hardtanh STE, against JAX's _stochastic_sign."""
    x = _x((5, 8), seed=7)
    noise = np.random.RandomState(8).uniform(-0.5, 0.5, x.shape).astype(np.float32)
    jg, tg = _grads(lambda v: jste._stochastic_sign(v, jnp.asarray(noise)),
                    lambda v: tste._StochasticSignSTE.apply(v, torch.from_numpy(noise)), x)
    _assert_same(jg, tg)


def test_stochastic_binarizer_keeps_its_own_stream_on_the_device():
    x = torch.zeros(4096)
    a, b = tops.StochasticInputBinarizer(seed=11), tops.StochasticInputBinarizer(seed=11)
    c = tops.StochasticInputBinarizer(seed=12)
    ga = a.generator(x.device)
    assert ga.device == x.device and a.generator("cpu") is ga
    first = a(x)
    assert torch.equal(first, b(x))          # one seed, one stream
    assert not torch.equal(first, c(x))      # another seed, another stream
    assert not torch.equal(first, a(x))      # the stream advances
    # unseeded instances each take the next seed: no two share a stream
    d, e = tops.StochasticInputBinarizer(), tops.StochasticInputBinarizer()
    assert d.seed != e.seed and not torch.equal(d(x), e(x))
    # a given generator is the stream on its device
    g = torch.Generator().manual_seed(5)
    f = tops.StochasticInputBinarizer(generator=g)
    assert f.generator("cpu") is g and f.seed == 5
