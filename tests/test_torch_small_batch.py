"""The whole small-batch slice: the port's fused Predictor (stem, stage and
block kernels, fused head) against the JAX package's unfused Predictor on
binary ResNets at 32x32, with the QAT weights, BN statistics, alphas and
PReLU slopes carried across by load_jax_state.

The port takes its kernels' plain versions on the CPU. The JAX package's own
tests (tests/test_stage_kernels.py) hold its fused stages bit-exact with its
unfused path, so the unfused JAX Predictor is the reference. Logits are held
to 1e-4: the stem's float convolution sums in another order than XLA's.
"""
import copy
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import bnn_tpu
import bnn_tpu_torch as bt
from bnn_tpu.inference import Predictor as JPredictor
from bnn_tpu.ops import binarizers as jops
from bnn_tpu_torch.inference import (FusedBlock, FusedBottleneck,
                                     FusedDownBlock, FusedStage, FusedStem,
                                     Predictor)
from bnn_tpu_torch.kernels import fused_basic_block, fused_chain
from bnn_tpu_torch.ops import binarizers as tops
from bnn_tpu_torch.utils import load_jax_state

_CONFIGS = {
    # name -> (depth, pre-activation blocks, PReLU)
    "flagship": (18, False, False),
    "prelu": (18, False, True),
    "pre": (18, True, True),
    "resnet50": (50, False, False),  # tests/test_torch_bottleneck.py
}


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
    """BN statistics, alphas and PReLU slopes away from their initial
    values, so that every folded add and threshold is non-zero."""
    out = dict(flat)
    for key, v in flat.items():
        leaf = key.rsplit(".", 1)[-1]
        if key.startswith("fc.") or leaf == "kernel":
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
        elif leaf == "weight":  # PReLU slopes
            out[key] = rng.uniform(0.05, 0.5, v.shape)
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


@functools.lru_cache(maxsize=None)
def _models(name):
    """(JAX QAT model, port QAT model, carried flat state) of a config."""
    depth, pre, prelu = _CONFIGS[name]
    jkw, tkw = {}, {}
    if pre:
        jkw["block_type"] = bnn_tpu.models.layers.PreBasicBlock
        tkw["block_type"] = bt.models.layers.PreBasicBlock
    if prelu:
        jkw["activation"] = bnn_tpu.nn.PReLU
        tkw["activation"] = torch.nn.PReLU
    jm = getattr(bnn_tpu.models, f"resnet{depth}")(num_classes=10,
                                                   rngs=nnx.Rngs(0), **jkw)
    jm = bnn_tpu.prepare_binary_model(
        jm, bnn_tpu.BConfig(jops.BasicInputBinarizer, jops.BasicScaleBinarizer,
                            jops.XNORWeightBinarizer),
        ignore_layers_name=["_first_", "_last_"])
    flat = _randomized(_flat(jm), np.random.RandomState(depth + 2 * pre + prelu))
    _write_flat(jm, flat)
    tm = getattr(bt.models, f"resnet{depth}")(num_classes=10, **tkw)
    tm = bt.prepare_binary_model(
        tm, bt.BConfig(tops.BasicInputBinarizer, tops.BasicScaleBinarizer,
                       tops.XNORWeightBinarizer),
        ignore_layers_name=["_first_", "_last_"])
    load_jax_state(tm, flat)
    return jm, tm.eval(), flat


_IMAGES = np.random.RandomState(1).randn(4, 32, 32, 3).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_logits(name):
    jm, _, _ = _models(name)
    pred = JPredictor(copy.deepcopy(jm), use_pallas=False, fuse=False,
                      dtype=None, batch_size=4)
    return np.asarray(pred(jnp.asarray(_IMAGES)))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("name,batch", [("flagship", 1), ("flagship", 3),
                                        ("prelu", 2), ("pre", 1), ("pre", 4)])
def test_fused_predictor_matches_jax(name, batch):
    _, tm, _ = _models(name)
    pred = Predictor(copy.deepcopy(tm), batch_size=batch, device="cpu",
                     dtype=None)
    got = pred(_nchw(_IMAGES)).numpy()
    want = _jax_logits(name)
    assert got.shape == (4, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_load_jax_state_carries_prelu_and_preact_blocks():
    jm, tm, flat = _models("pre")
    block = tm.layer2[0]
    assert isinstance(block, bt.models.layers.PreBasicBlock)
    np.testing.assert_array_equal(block.act1.weight.detach().numpy(),
                                  flat["layer2.0.act1.weight"])
    # the pre-activation norms sit on the unit inputs: bn1 is 64 wide
    assert block.bn1.running_mean.shape == (64,)
    np.testing.assert_array_equal(block.bn2.running_var.numpy(),
                                  flat["layer2.0.bn2.var"])


def test_pass_structure_and_launch_plan():
    """Stem, four stages with the head folded into layer4: five launches per
    forward at batch <= 4, and the stages fall back above it."""
    _, tm, _ = _models("flagship")
    pred = Predictor(copy.deepcopy(tm), batch_size=1, device="cpu")
    m = pred.model
    assert isinstance(m.conv1, FusedStem)
    assert [getattr(m, f"layer{i}").kind for i in (1, 2, 3, 4)] == \
        ["pair", "down", "down", "down"]
    assert m.layer4.head_fc is not None
    assert isinstance(m.fc, torch.nn.Identity)
    assert isinstance(m.avgpool, torch.nn.Identity)
    # fuse_blocks wrapped the blocks inside each stage's fallback
    assert isinstance(m.layer1.stage[0], FusedBlock)
    assert isinstance(m.layer2.stage[0], FusedDownBlock)
    # cast_floats rounds the stage's rows and head, not its int8 weights
    assert m.layer2.p0_3.dtype == torch.bfloat16  # po
    assert m.layer2.p0_0.dtype == torch.int8      # s2d w1
    assert m.layer4.wfc.dtype == torch.bfloat16
    out = pred(_nchw(_IMAGES[:2]))
    assert out.dtype == torch.float32  # a fused head's logits are f32
    assert out.shape == (2, 10) and torch.isfinite(out).all()


def test_resnet34_layer4_stays_per_block():
    """ResNet-34's layer4 (14 MB of int8 weights) is over the stage gate:
    one downsample and two basic block kernels, and the head unfused."""
    model = bt.models.resnet34(num_classes=10,
                               generator=torch.Generator().manual_seed(0))
    model = bt.prepare_binary_model(
        model, bt.BConfig(tops.BasicInputBinarizer, tops.BasicScaleBinarizer,
                          tops.XNORWeightBinarizer),
        ignore_layers_name=["_first_", "_last_"]).eval()
    fused = Predictor(copy.deepcopy(model), batch_size=1, device="cpu",
                      dtype=None)
    m = fused.model
    assert all(isinstance(getattr(m, f"layer{i}"), FusedStage) for i in (1, 2, 3))
    assert [len(getattr(m, f"layer{i}").stage) for i in (1, 2, 3)] == [3, 4, 6]
    assert isinstance(m.layer4, torch.nn.Sequential)
    assert [type(b) for b in m.layer4] == [FusedDownBlock, FusedBlock, FusedBlock]
    assert type(m.fc) is torch.nn.Linear
    plain = Predictor(copy.deepcopy(model), batch_size=1, device="cpu",
                      dtype=None, fuse=False)
    x = _nchw(_IMAGES[:2])
    torch.testing.assert_close(fused(x), plain(x), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("max_fused_batch", [4, 8])
def test_batch8_paths(max_fused_batch):
    """At batch 8 every stage falls back; with max_fused_batch=8 its blocks
    run the block kernels instead of the deployed convs."""
    _, tm, _ = _models("flagship")
    pred = Predictor(copy.deepcopy(tm), batch_size=8, device="cpu", dtype=None,
                     max_fused_batch=max_fused_batch)
    chain0, block0 = fused_chain.launches, fused_basic_block.launches
    got = pred(_nchw(_IMAGES)).numpy()
    np.testing.assert_allclose(got, _jax_logits("flagship"), rtol=1e-4, atol=1e-4)
    assert (fused_chain.launches, fused_basic_block.launches) == (chain0, block0)
    assert pred.model.layer1.max_fused_batch == 4


def _tiny_bottleneck_resnet():
    from bnn_tpu_torch.models.layers import Bottleneck
    from bnn_tpu_torch.models.resnet import ResNet
    model = ResNet(Bottleneck, [1, 1, 1, 1], num_classes=10,
                   generator=torch.Generator().manual_seed(0))
    return bt.prepare_binary_model(
        model, bt.BConfig(tops.BasicInputBinarizer, tops.BasicScaleBinarizer,
                          tops.XNORWeightBinarizer),
        ignore_layers_name=["_first_", "_last_"]).eval()


def test_bottleneck_small_batch_serves_and_matches_unfused():
    """A Bottleneck model at batch <= max_fused_batch runs its stride-1
    blocks through fused_bottleneck (the plain version on the CPU) and equals
    its unfused output; above the cap the wrapper runs the block, as the JAX
    one does. Nothing raises."""
    x = torch.randn(4, 3, 32, 32, generator=torch.Generator().manual_seed(3))
    plain = Predictor(_tiny_bottleneck_resnet(), batch_size=4, device="cpu",
                      dtype=None, fuse=False)(x)
    for batch in (4, 8):
        pred = Predictor(_tiny_bottleneck_resnet(), batch_size=batch,
                         device="cpu", dtype=None)
        assert isinstance(pred.model.layer1[0], FusedBottleneck)
        torch.testing.assert_close(pred(x), plain, rtol=1e-5, atol=1e-5)
