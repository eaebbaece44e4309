"""bnn_tpu_torch's QAT side (ops, binary layers, prepare_binary_model, the
ResNet zoo) against bnn_tpu on the same weights and inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import bnn_tpu
import bnn_tpu_torch as bt
from bnn_tpu import layers as jlayers
from bnn_tpu import ops as jops
from bnn_tpu_torch import layers as tlayers
from bnn_tpu_torch import ops as tops
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


def _with_zeros(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    x[rng.rand(*shape) < 0.25] = 0.0
    return x


@pytest.mark.parametrize("zero_to_one", [False, True])
def test_input_binarizer_sign_of_zero(zero_to_one):
    x = _with_zeros(np.random.RandomState(0), (64,))
    want = np.asarray(jops.BasicInputBinarizer(zero_to_one=zero_to_one)(jnp.asarray(x)))
    got = tops.BasicInputBinarizer(zero_to_one=zero_to_one)(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[x == 0] == (1.0 if zero_to_one else 0.0)).all()


@pytest.mark.parametrize("center", [False, True])
def test_xnor_weight_binarizer_matches_jax(center):
    w = np.random.RandomState(1).randn(3, 3, 8, 16).astype(np.float32)  # HWIO
    want = np.asarray(jops.XNORWeightBinarizer(center_weights=center)(jnp.asarray(w)))
    got = tops.XNORWeightBinarizer(center_weights=center)(
        torch.from_numpy(w).permute(3, 2, 0, 1))
    np.testing.assert_allclose(got.permute(2, 3, 1, 0).numpy(), want, rtol=1e-6)


def test_ste_gradients_pass_inside_unit_interval():
    x = torch.tensor([-2.0, -0.5, 0.0, 0.5, 1.0], requires_grad=True)
    tops.sign_ste(x).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [0, 1, 1, 1, 0])
    x.grad = None
    tops.sign_pm1_ste(x).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [0, 1, 1, 1, 0])


def test_registry_and_bconfig():
    assert tops.resolve("BasicInputBinarizer") is tops.BasicInputBinarizer
    assert tops.resolve("identity") is tops.Identity
    with pytest.raises(KeyError):
        tops.resolve("NoSuchBinarizer")
    with pytest.raises(ValueError, match="instance"):
        bt.BConfig(activation_pre_process=tops.BasicInputBinarizer())


@pytest.mark.parametrize("kind", ["linear", "conv2d", "conv1d"])
def test_binary_layer_forward_matches_jax(kind):
    rng = np.random.RandomState(2)
    jb = bnn_tpu.BConfig(jops.BasicInputBinarizer, jops.BasicScaleBinarizer,
                         jops.XNORWeightBinarizer)
    tb = bt.BConfig(tops.BasicInputBinarizer, tops.BasicScaleBinarizer,
                    tops.XNORWeightBinarizer)
    if kind == "linear":
        jl = jlayers.Linear(12, 6, bconfig=jb, rngs=nnx.Rngs(0))
        tl = tlayers.Linear(12, 6, bconfig=tb)
        x = _with_zeros(rng, (4, 12))
        to_t, from_t = torch.from_numpy, lambda t: t.detach().numpy()
    elif kind == "conv2d":
        jl = jlayers.Conv2d(4, 6, 3, 2, 1, bconfig=jb, rngs=nnx.Rngs(0))
        tl = tlayers.Conv2d(4, 6, 3, 2, 1, bconfig=tb)
        x = _with_zeros(rng, (2, 7, 7, 4))
        to_t = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
        from_t = lambda t: t.detach().permute(0, 2, 3, 1).numpy()
    else:
        jl = jlayers.Conv1d(4, 6, 3, 1, 1, bconfig=jb, rngs=nnx.Rngs(0))
        tl = tlayers.Conv1d(4, 6, 3, 1, 1, bconfig=tb)
        x = _with_zeros(rng, (2, 9, 4))
        to_t = lambda a: torch.from_numpy(a).permute(0, 2, 1)
        from_t = lambda t: t.detach().permute(0, 2, 1).numpy()
    alpha = jl.activation_post_process.alpha
    alpha[...] = jnp.asarray(rng.uniform(0.5, 1.5, alpha[...].shape), jnp.float32)
    load_jax_state(tl, _flat(jl))
    np.testing.assert_allclose(from_t(tl(to_t(x))), np.asarray(jl(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


def _net(lib):
    """conv -> bn -> relu -> conv -> flatten -> linear -> linear, in
    construction order."""
    nn = lib.nn if lib is bnn_tpu else torch.nn
    if lib is bnn_tpu:
        r = nnx.Rngs(0)
        return nn.Sequential(nn.Conv2d(3, 4, 3, rngs=r), nn.BatchNorm2d(4, rngs=r),
                             nn.ReLU(), nn.Conv2d(4, 4, 3, rngs=r),
                             nn.Flatten(), nn.Linear(4, 4, rngs=r),
                             nn.Linear(4, 2, rngs=r))
    return nn.Sequential(nn.Conv2d(3, 4, 3), nn.BatchNorm2d(4), nn.ReLU(),
                         nn.Conv2d(4, 4, 3), nn.Flatten(), nn.Linear(4, 4),
                         nn.Linear(4, 2))


def _binary_names(named_modules, layer_types):
    return sorted(name for name, m in named_modules
                  if isinstance(m, layer_types))


@pytest.mark.parametrize("ignore", [["_first_", "_last_"], ["$^[03]$"], ["5"]])
def test_prepare_binary_model_selects_like_jax(ignore):
    bcfg = dict(activation_pre_process=tops.BasicInputBinarizer,
                weight_pre_process=tops.XNORWeightBinarizer)
    jcfg = dict(activation_pre_process=jops.BasicInputBinarizer,
                weight_pre_process=jops.XNORWeightBinarizer)
    jm = bnn_tpu.prepare_binary_model(_net(bnn_tpu), bnn_tpu.BConfig(**jcfg),
                                      ignore_layers_name=ignore)
    tm = bt.prepare_binary_model(_net(bt), bt.BConfig(**bcfg),
                                 ignore_layers_name=ignore)
    jnames = _binary_names(bnn_tpu.binarize.named_modules(jm),
                           (jlayers.Linear, jlayers.Conv2d))
    tnames = _binary_names(tm.named_modules(), (tlayers.Linear, tlayers.Conv2d))
    assert tnames == jnames and tnames


def test_prepare_binary_model_custom_config_and_tying():
    tm = _net(bt)
    tm.append(tm[6])  # the last linear reached from two paths
    tm = bt.prepare_binary_model(
        tm, bt.BConfig(tops.BasicInputBinarizer),
        custom_config_layers_name={"3": bt.BConfig(tops.BasicInputBinarizer.with_args(
            zero_to_one=True))},
        ignore_layers_name=["0"])
    assert type(tm[0]) is torch.nn.Conv2d
    assert tm[3].activation_pre_process.zero_to_one
    assert not tm[5].activation_pre_process.zero_to_one
    assert isinstance(tm[6], tlayers.Linear) and tm[7] is tm[6]


# the post-activation ResNet-18 is held against JAX in test_torch_serving.py
@pytest.mark.parametrize("depth,block", [(18, "PreBasicBlock"), (50, "Bottleneck")])
def test_resnet_structure_and_qat_forward_match_jax(depth, block):
    jfn = getattr(bnn_tpu.models, f"resnet{depth}")
    tfn = getattr(bt.models, f"resnet{depth}")
    jm = jfn(block_type=getattr(bnn_tpu.models.layers, block), num_classes=5,
             rngs=nnx.Rngs(0))
    tm = tfn(block_type=getattr(bt.models, block), num_classes=5,
             generator=torch.Generator().manual_seed(0))
    flat = _flat(jm)
    load_jax_state(tm, flat)
    jm.eval()
    tm.eval()
    x = np.random.RandomState(3).randn(2, 32, 32, 3).astype(np.float32)
    want = np.asarray(jm(jnp.asarray(x)))
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_dabnn_stem_is_not_ported_yet():
    """The name is historical: the stem it once found missing is ported now,
    so it checks that the DaBNN stem builds (and is held against JAX in
    tests/test_torch_zoo.py) and that an unknown stem type is refused."""
    model = bt.models.resnet18(stem_type="dabnn")
    assert isinstance(model.conv1, bt.models.DaBNNStem)
    with pytest.raises(ValueError, match="stem_type"):
        bt.models.resnet18(stem_type="nope")
