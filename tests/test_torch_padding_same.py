"""``padding='same'`` in the port against ``bnn_tpu``: the binary
``layers.Conv2d`` (at any stride, as ``lax`` resolves it) and the deployed
conv in modes ``conv`` and ``im2col`` (padded after the sign, so that a
padded tap adds 0), on odd and even H and W, 2x2 to 5x5 kernels, dilation 1
and 2, with the same weights carried by load_jax_state. The JAX deployed
GEMM path runs its Pallas kernel in interpret mode; the port takes its plain
versions on the CPU."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import bnn_tpu
import bnn_tpu_torch as bt
from bnn_tpu import layers as jlayers
from bnn_tpu.ops import binarizers as jops
from bnn_tpu_torch import layers as tlayers
from bnn_tpu_torch.ops import binarizers as tops
from bnn_tpu_torch.utils import load_jax_state
from bnn_tpu_torch.utils.padding import same_pads, static_same_pads
from test_torch_deploy import _activations, _flat, _nchw, _nhwc, _randomize_alpha

jdeploy = importlib.import_module("bnn_tpu.inference.deploy")
tdeploy = importlib.import_module("bnn_tpu_torch.inference.deploy")


def _pair(cin, cout, k, stride, padding, dilation, z21, xnor_scale, seed):
    """A JAX binary Conv2d and the port's, with the same weights and alphas."""
    post_j = jops.XNORScaleBinarizer if xnor_scale else jops.BasicScaleBinarizer
    post_t = tops.XNORScaleBinarizer if xnor_scale else tops.BasicScaleBinarizer
    jb = bnn_tpu.BConfig(jops.BasicInputBinarizer.with_args(zero_to_one=z21), post_j,
                         jops.XNORWeightBinarizer)
    tb = bt.BConfig(tops.BasicInputBinarizer.with_args(zero_to_one=z21), post_t,
                    tops.XNORWeightBinarizer)
    jl = jlayers.Conv2d(cin, cout, k, stride, padding, dilation, bconfig=jb,
                        rngs=nnx.Rngs(seed))
    if not xnor_scale:
        _randomize_alpha(jl, np.random.RandomState(seed))
    tl = tlayers.Conv2d(cin, cout, k, stride, padding, dilation, bconfig=tb)
    load_jax_state(tl, _flat(jl))
    return jl, tl


# (cin, cout, k, stride, dilation, (H, W), deployed mode, weight format,
#  zero_to_one, XNOR spatial scale)
_CASES = [
    (8, 16, 3, 1, 1, (9, 9), "conv", "int8", False, False),
    (8, 16, 3, 2, 1, (9, 9), "conv", "packed", False, False),
    (8, 16, 3, 2, 1, (8, 10), "im2col", "packed", True, False),
    (8, 16, 5, 2, 1, (9, 8), "conv", "int8", True, False),
    (8, 16, 5, 2, 1, (10, 10), "im2col", "int8", False, False),
    (8, 16, 3, 1, 2, (9, 8), "conv", "packed", True, False),
    (8, 16, 3, 2, 2, (10, 9), "conv", "int8", False, False),
    (8, 16, 5, 1, 2, (8, 8), "im2col", "packed", False, False),
    (8, 16, 2, 1, 1, (9, 9), "conv", "int8", False, False),   # low 0, high 1
    (8, 16, 4, 2, 1, (10, 9), "im2col", "packed", True, False),
    (40, 16, 3, 2, 1, (7, 7), "conv", "packed", True, False),
    (8, 16, 3, 2, 1, (9, 10), "conv", "int8", False, True),   # XNOR scale
]


def _ids(c):
    return f"{c[0]}-{c[1]}-k{c[2]}-s{c[3]}-d{c[4]}-{c[5][0]}x{c[5][1]}-{c[6]}-{c[7]}" + \
        ("-z21" if c[8] else "") + ("-xnor" if c[9] else "")


@pytest.mark.parametrize("case", _CASES, ids=_ids)
def test_binary_conv_same_matches_jax(case):
    cin, cout, k, stride, dil, (h, w), _, _, z21, xnor = case
    seed = cin + cout + k + stride + dil + h + w
    jl, tl = _pair(cin, cout, k, stride, "same", dil, z21, xnor, seed)
    assert tl.padding == "same"
    x = _activations(np.random.RandomState(seed), (2, h, w, cin))
    want = np.asarray(jl(jnp.asarray(x)))
    got = _nhwc(tl(_nchw(x)))
    assert got.shape == (2, -(-h // stride), -(-w // stride), cout)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", _CASES, ids=_ids)
def test_deployed_conv_same_matches_jax(case):
    cin, cout, k, stride, dil, (h, w), mode, fmt, z21, xnor = case
    seed = cin + cout + k + stride + dil + h + w
    jl, tl = _pair(cin, cout, k, stride, "same", dil, z21, xnor, seed)
    x = _activations(np.random.RandomState(seed + 1), (2, h, w, cin))
    jd = jdeploy.DeployedConv(jl, use_pallas=mode != "conv", interpret=True,
                              mode=mode, weight_format=fmt)
    td = tdeploy.DeployedConv(tl, mode=mode, weight_format=fmt)
    assert td.mode == jd.mode
    # a pad that holds for every input size is resolved once; else per call
    static = static_same_pads((k, k), (stride, stride), (dil, dil))
    assert td.padding == (static if static is not None else "same")
    want = np.asarray(jd(jnp.asarray(x)))
    got = _nhwc(td(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if xnor:
        return
    # the integer accumulators (scale 1, add 0) are exact
    jd.scale[...] = jnp.ones_like(jd.scale[...])
    jd.add[...] = jnp.zeros_like(jd.add[...])
    td.scale = torch.ones_like(td.scale)
    td.add = torch.zeros_like(td.add)
    acc = _nhwc(td(_nchw(x)))
    np.testing.assert_array_equal(acc, np.asarray(jd(jnp.asarray(x))))
    assert np.all(acc == np.round(acc))


@pytest.mark.parametrize("mode", ["conv", "gemm"])
@pytest.mark.parametrize("k", [1, 3])
def test_deployed_conv_valid_matches_jax(mode, k):
    cin = 256 if mode == "gemm" else 8
    if mode == "gemm" and k != 1:
        mode = "im2col"  # the GEMM path of a 3x3 conv
    jl, tl = _pair(cin, 16, k, 1, "valid", 1, False, False, seed=k + cin)
    x = _activations(np.random.RandomState(k), (2, 7, 8, cin))
    jd = jdeploy.DeployedConv(jl, use_pallas=mode != "conv", interpret=True,
                              mode=mode, weight_format="packed")
    td = tdeploy.DeployedConv(tl, mode=mode, weight_format="packed")
    assert td.padding == (0, 0)
    got = _nhwc(td(_nchw(x)))
    assert got.shape == (2, 8 - k, 9 - k, 16)
    np.testing.assert_allclose(got, np.asarray(jd(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size,k,stride,dil", [
    (9, 3, 1, 1), (9, 3, 2, 1), (8, 3, 2, 1), (10, 5, 2, 1), (7, 5, 3, 2),
    (8, 2, 1, 1), (9, 4, 2, 1), (1, 3, 2, 1), (6, 7, 2, 1), (11, 3, 2, 2)])
def test_same_pads_match_lax(size, k, stride, dil):
    (want,) = jax.lax.padtype_to_pads((size,), ((k - 1) * dil + 1,), (stride,),
                                      "SAME")
    assert same_pads(size, k, stride, dil) == tuple(want)


def test_pallas_conv_takes_same_only_where_its_geometry_does():
    _, tl = _pair(8, 16, 3, 1, "same", 1, True, False, seed=3)
    td = tdeploy.DeployedConv(tl, mode="pallas-conv", weight_format="int8")
    assert td.padding == (1, 1)
    _, tl2 = _pair(8, 16, 3, 1, 1, 1, True, False, seed=3)
    ref = tdeploy.DeployedConv(tl2, mode="pallas-conv", weight_format="int8")
    x = _nchw(_activations(np.random.RandomState(0), (2, 9, 9, 8)))
    torch.testing.assert_close(td(x), ref(x), rtol=0, atol=0)
    _, tl3 = _pair(8, 16, 3, 2, "same", 1, True, False, seed=3)
    with pytest.raises(ValueError):
        tdeploy.DeployedConv(tl3, mode="pallas-conv")
