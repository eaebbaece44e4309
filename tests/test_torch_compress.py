"""The port's weight-only int8 / int4 compression (bnn_tpu_torch.inference.
compress) against bnn_tpu's: the same float weights, made with numpy from a
seed, quantized in both packages; the quantized flagship served by both
Predictors, with the QAT weights carried across by load_jax_state."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import bnn_tpu
import bnn_tpu_torch as bt
from bnn_tpu.inference import Predictor as JPredictor
from bnn_tpu.inference import compress as jcompress
from bnn_tpu.inference import model_weight_bytes as j_model_weight_bytes
from bnn_tpu.inference import packed_weight_bytes as j_packed_weight_bytes
from bnn_tpu.ops import binarizers as jops
from bnn_tpu_torch.inference import (Predictor, QuantizedConv, QuantizedLinear,
                                     model_weight_bytes, packed_weight_bytes,
                                     quantize_float_layers, state_bytes)
from bnn_tpu_torch.inference import compress as tcompress
from bnn_tpu_torch.ops import binarizers as tops
from bnn_tpu_torch.utils import load_jax_state
from test_torch_serving import _flat, _nchw, _randomized, _write_flat

# (bits, group) of the quantized-weight cases: int8 per channel, int4 in its
# default groups of 64, int4 in groups of 16
_FORMATS = [(8, None), (4, None), (4, 16)]


def _layers(kind, seed=0):
    """(JAX float layer, port float layer) with the same weights: a Linear
    300 -> 24 (K not a multiple of a group) or a 3x3 conv 20 -> 12."""
    rng = np.random.RandomState(seed)
    if kind == "linear":
        j = bnn_tpu.nn.Linear(300, 24, rngs=nnx.Rngs(0))
        t = torch.nn.Linear(300, 24)
        kernel = rng.randn(300, 24).astype(np.float32) * 0.1
        t_weight = kernel.T
    else:
        j = bnn_tpu.nn.Conv2d(20, 12, 3, padding=1, rngs=nnx.Rngs(0))
        t = torch.nn.Conv2d(20, 12, 3, padding=1)
        kernel = rng.randn(3, 3, 20, 12).astype(np.float32) * 0.1
        t_weight = kernel.transpose(3, 2, 0, 1)
    bias = rng.randn(kernel.shape[-1]).astype(np.float32)
    j.kernel[...] = jnp.asarray(kernel)
    j.bias[...] = jnp.asarray(bias)
    with torch.no_grad():
        t.weight.copy_(torch.from_numpy(np.ascontiguousarray(t_weight)))
        t.bias.copy_(torch.from_numpy(bias))
    return j, t


def _inputs(kind, seed=1):
    rng = np.random.RandomState(seed)
    if kind == "linear":
        x = rng.randn(5, 300).astype(np.float32)
        return jnp.asarray(x), torch.from_numpy(x)
    x = rng.randn(2, 9, 9, 20).astype(np.float32)
    return jnp.asarray(x), _nchw(x)


@pytest.mark.parametrize("bits,group", _FORMATS)
@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_quantized_weights_are_jax_bits(kind, bits, group):
    """w_q and w_scale bit for bit as JAX's, in JAX's layout (K in (kh, kw,
    ci) order for a conv, so the int4 groups are JAX's); the dequantised
    layer's outputs within 1e-5 of JAX's."""
    j, t = _layers(kind)
    jcls = jcompress.QuantizedLinear if kind == "linear" else jcompress.QuantizedConv
    tcls = QuantizedLinear if kind == "linear" else QuantizedConv
    jq, tq = jcls(j, bits=bits, group=group), tcls(t, bits=bits, group=group)
    assert tq.w_q.dtype == torch.int8 and tq.w_scale.dtype == torch.float32
    np.testing.assert_array_equal(tq.w_q.numpy(), np.asarray(jq.w_q[...]))
    np.testing.assert_array_equal(tq.w_scale.numpy(), np.asarray(jq.w_scale[...]))
    xj, xt = _inputs(kind)
    want = np.asarray(jq(xj))
    got = tq(xt).detach()
    got = (got if kind == "linear" else got.permute(0, 2, 3, 1)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # quantization error against the float layer: per-weight at most half a
    # step of its channel (or group)
    ref = t(xt).detach()
    rel = float((tq(xt) - ref).abs().max() / ref.abs().max())
    assert rel < (0.01 if bits == 8 else 0.1), rel


def test_int4_pack_roundtrip():
    rng = np.random.default_rng(0)
    q = rng.integers(-7, 8, size=(3, 64, 5)).astype(np.int8)
    packed = tcompress._pack_int4(torch.from_numpy(q))
    assert packed.shape == (3, 32, 5) and packed.dtype == torch.int8
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jcompress._pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(tcompress._unpack_int4(packed).numpy(), q)


def test_int4_odd_group_rejected():
    _, t = _layers("linear")
    with pytest.raises(ValueError, match="even"):
        QuantizedLinear(t, bits=4, group=7)
    with pytest.raises(ValueError, match="8 or 4"):
        QuantizedLinear(t, bits=6)


def test_min_params_and_skip():
    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 1), torch.nn.Linear(4096, 1000))
    skipped = quantize_float_layers(copy.deepcopy(m), min_params=1000, skip=("1",))
    assert type(skipped[1]) is torch.nn.Linear
    q = quantize_float_layers(m, min_params=1000)
    assert type(q[0]) is torch.nn.Conv2d and isinstance(q[1], QuantizedLinear)
    # a model that is itself one big float layer is replaced, not mutated
    lin = torch.nn.Linear(8, 8)
    assert isinstance(quantize_float_layers(lin, min_params=0), QuantizedLinear)


def test_binary_layers_are_left_alone():
    """The binary layers subclass torch's Linear / Conv2d: the exact-type
    test leaves them (and the small stem) float, and takes the fc."""
    m = bt.models.resnet18(num_classes=1000, generator=torch.Generator().manual_seed(0))
    m = bt.prepare_binary_model(
        m, bt.BConfig(tops.BasicInputBinarizer, tops.BasicScaleBinarizer,
                      tops.XNORWeightBinarizer),
        ignore_layers_name=["_first_", "_last_"])
    quantize_float_layers(m)
    kinds = {type(mm) for mm in m.modules()}
    assert isinstance(m.fc, QuantizedLinear) and QuantizedConv not in kinds
    assert type(m.conv1) is torch.nn.Conv2d  # 9,408 weights < 2**14
    assert type(m.layer1[0].conv1) is bt.layers.Conv2d


def test_jax_quantized_model_carries_across():
    """A model quantized by the JAX package reaches the port through
    load_jax_state (w_q and w_scale as they are) and gives its outputs."""
    rngs = nnx.Rngs(0)
    jm = bnn_tpu.nn.Sequential(
        bnn_tpu.nn.Conv2d(3, 16, 3, padding=1, rngs=rngs), bnn_tpu.nn.ReLU(),
        bnn_tpu.nn.AdaptiveAvgPool2d(1), bnn_tpu.nn.Flatten(),
        bnn_tpu.nn.Linear(16, 130, rngs=rngs))
    tm = torch.nn.Sequential(
        torch.nn.Conv2d(3, 16, 3, padding=1), torch.nn.ReLU(),
        torch.nn.AdaptiveAvgPool2d(1), torch.nn.Flatten(), torch.nn.Linear(16, 130))
    jcompress.quantize_float_layers(jm, bits=4, group=8, min_params=0)
    quantize_float_layers(tm, bits=4, group=8, min_params=0)
    flat = _flat(jm)
    assert {"0.w_q", "0.w_scale", "4.w_q", "4.w_scale", "4.bias"} <= flat.keys()
    load_jax_state(tm, flat)
    x = np.random.RandomState(2).randn(3, 10, 10, 3).astype(np.float32)
    want = np.asarray(jm(jnp.asarray(x)))
    np.testing.assert_allclose(tm(_nchw(x)).detach().numpy(), want,
                               rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def flagship1000():
    """The flagship of test_torch_serving at 32x32 with 1000 classes: its fc
    (512,000 weights) is over the default min_params, as in serving (with
    10 classes, 5,120, it would stay float). (JAX model, port model,
    images NHWC.)"""
    jm = bnn_tpu.models.resnet18(num_classes=1000, rngs=nnx.Rngs(0))
    jm = bnn_tpu.prepare_binary_model(
        jm, bnn_tpu.BConfig(jops.BasicInputBinarizer, jops.BasicScaleBinarizer,
                            jops.XNORWeightBinarizer),
        ignore_layers_name=["_first_", "_last_"])
    rng = np.random.RandomState(0)
    flat = _randomized(_flat(jm), rng)
    _write_flat(jm, flat)
    tm = bt.models.resnet18(num_classes=1000)
    tm = bt.prepare_binary_model(
        tm, bt.BConfig(tops.BasicInputBinarizer, tops.BasicScaleBinarizer,
                       tops.XNORWeightBinarizer),
        ignore_layers_name=["_first_", "_last_"])
    load_jax_state(tm, flat)
    return jm, tm, rng.randn(5, 32, 32, 3).astype(np.float32)


@pytest.mark.parametrize("fuse,bits", [(None, 8), (False, 8), (None, 4)])
def test_quantized_predictor_matches_jax(flagship1000, fuse, bits):
    jm, tm, images = flagship1000
    want = np.asarray(JPredictor(copy.deepcopy(jm), batch_size=4, use_pallas=False, fuse=False,
                                 dtype=None, quantize_float_bits=bits)(jnp.asarray(images)))
    pred = Predictor(copy.deepcopy(tm), batch_size=4, device="cpu", dtype=None,
                     fuse=fuse, quantize_float_bits=bits)
    assert isinstance(pred.served_model().fc, QuantizedLinear)
    if fuse is None:  # the quantized head is not folded into layer4's kernel
        assert pred.model.layer4.head_fc is None
    got = pred(_nchw(images)).numpy()
    assert got.shape == (5, 1000)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    # the int8 head stays close to the float one (int4 in groups of 64, less)
    ref = Predictor(copy.deepcopy(tm), batch_size=4, device="cpu", dtype=None,
                    fuse=fuse)(_nchw(images)).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < (0.02 if bits == 8 else 0.12)


def _leaf_bytes_jax(model):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(nnx.state(model)):
        if hasattr(leaf, "dtype") and hasattr(leaf, "size"):
            key = ".".join(str(getattr(p, "key", p)) for p in path)
            out[key] = leaf.size * leaf.dtype.itemsize
    return out


def _leaf_bytes_port(model):
    return {k: v.numel() * v.element_size() for k, v in model.state_dict().items()
            if isinstance(v, torch.Tensor)}


@pytest.mark.parametrize("weight_format,dtype", [
    ("int8", None), ("packed", None), ("int8", "bf16")])
def test_state_bytes_match_jax(flagship1000, weight_format, dtype):
    """The unfused quantized predictor's state bytes, packed weight bytes and
    weight bytes equal JAX's; a difference names the leaves."""
    jm, tm, _ = flagship1000
    jp = JPredictor(copy.deepcopy(jm), batch_size=4, use_pallas=False, fuse=False,
                    weight_format=weight_format, quantize_float_bits=8,
                    dtype=jnp.bfloat16 if dtype else None)
    tp = Predictor(copy.deepcopy(tm), batch_size=4, device="cpu", fuse=False,
                   weight_format=weight_format, quantize_float_bits=8,
                   dtype=torch.bfloat16 if dtype else None)
    jb, tb = _leaf_bytes_jax(jp.served_model()), _leaf_bytes_port(tp.model)
    assert tp.state_bytes() == sum(tb.values()) == state_bytes(tp.model)
    assert jp.state_bytes() == sum(jb.values())
    assert tp.state_bytes() == jp.state_bytes(), (
        sorted(set(jb.items()) - set(tb.items()))[:8],
        sorted(set(tb.items()) - set(jb.items()))[:8])
    assert packed_weight_bytes(tp.model) == j_packed_weight_bytes(jp.served_model())
    assert model_weight_bytes(tp.model) == j_model_weight_bytes(jp.served_model())
    # the int8 head: 512,000 int8 weights beside (1000,) scales and bias
    assert tb["fc.w_q"] == 512_000
