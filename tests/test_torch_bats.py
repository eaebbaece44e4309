"""The port's BATS ops and networks against ``bnn_tpu`` on the CPU: each
``OPS`` entry, ``Cell`` (normal and reduction), ``AuxiliaryHead``, both
networks (C = 8, ``layers=4`` so that normal cells exist, groups 4), their
randomness (drop-path, shake-shake), the binarized layer names, and the
deployment of a binarized BATS CIFAR net (grouped convs in conv mode, the BN
folds, the integer accumulators of a grouped conv).

Weights are made on the JAX side, norm state made random with numpy and
carried with ``load_jax_state``; inputs are numpy draws from a seed.
Forward, input and parameter gradients run in float64 (``assert_matches``
of ``test_torch_zoo``): 1e-5 where no sign is taken, 1e-4 for binarized
models. The binarized cells and networks take imagenet-baseline.yaml's
second step (weights sign(W), no alpha; ``RECIPE_J`` / ``RECIPE_T``): a
grouped 3x3 conv sums 18 signs, so exact zeros are common, and with XNOR's
alpha * sign(W) a zero sum rounds to 0 or not by the summation order,
which then meets PReLU's kink in one package and not the other.
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
from bnn_tpu.models.layers import bats_ops as jbats
from bnn_tpu_torch.models.layers import bats_ops as tbats
from bnn_tpu_torch.utils import load_jax_state
from test_torch_small_batch import _randomized, _write_flat
from test_torch_zoo import (FLAGSHIP_J, FLAGSHIP_T, IGNORE, RECIPE_J, RECIPE_T,
                            assert_matches, eval_forward, jax_model, nchw, rel)

C = 8


def flat_params(module):
    """{dotted path: array} of a JAX module's state, its RNG streams left out."""
    out = {}

    def walk(prefix, d):
        for k, v in d.items():
            key = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, dict):
                walk(key, v)
            else:
                out[key] = np.asarray(v)

    walk("", nnx.to_pure_dict(nnx.state(module, nnx.Not(nnx.RngState))))
    return out


def carry(jm, tm, seed, binarize=False, ignore=IGNORE):
    if binarize:
        jm = bnn_tpu.prepare_binary_model(jm, bnn_tpu.BConfig(*RECIPE_J),
                                          ignore_layers_name=ignore)
        tm = bt.prepare_binary_model(tm, bt.BConfig(*RECIPE_T),
                                     ignore_layers_name=ignore)
    flat = _randomized(flat_params(jm), np.random.RandomState(seed))
    _write_flat(jm, flat)
    load_jax_state(tm, flat)
    return jm, tm


def x_nhwc(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# --- the ops ------------------------------------------------------------------

def test_primitives_and_genotype():
    assert tbats.PRIMITIVES == jbats.PRIMITIVES
    assert tbats.Genotype._fields == jbats.Genotype._fields
    assert tuple(bt.models.BATS_EXAMPLE) == tuple(bnn_tpu.models.BATS_EXAMPLE)
    assert set(tbats.OPS) == set(jbats.OPS)


def test_channel_shuffle_order_matches_jax():
    """NCHW shuffle gives JAX's NHWC channel order, exactly."""
    x = x_nhwc((2, 3, 3, 12))
    want = np.asarray(jbats.channel_shuffle(jnp.asarray(x), 4))
    got = tbats.channel_shuffle(nchw(x), 4).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("name", sorted(jbats.OPS))
def test_op_matches_jax(name, stride):
    """Each OPS entry on (2, 8, 8, 8), float: eval forward in f32 within
    1e-5; at stride 1 also the train-mode forward with input and parameter
    gradients in float64 within 1e-5 ('none' has no gradient). The stride-2
    gradients of the ops a reduction cell uses (FactorizedReduce, the
    pools) are held in ``test_cell_matches_jax``."""
    jm = jax_model(lambda: jbats.OPS[name](C, stride, True, True, 4, nnx.Rngs(0)))
    tm = tbats.OPS[name](C, stride, True, True, 4)
    jm, tm = carry(jm, tm, 3)
    x = x_nhwc((2, 8, 8, C))
    assert rel(eval_forward(tm, x), eval_forward(jm, x)) < 1e-5
    if name != "none" and stride == 1:
        assert_matches(jm, tm, x, tol=1e-5)


def test_zero_op_ceil_stride_and_drop_path_identity():
    x = torch.randn(2, 4, 7, 5)
    assert tuple(tbats.Zero(2)(x).shape) == (2, 4, 4, 3)
    assert not tbats.Zero(2)(x).any()
    assert tbats.drop_path(x, 0.0) is x


# --- cells, the auxiliary head, the networks -----------------------------------

@pytest.mark.parametrize("reduction,reduction_prev", [(False, False), (True, False),
                                                      (False, True)])
def test_cell_matches_jax(reduction, reduction_prev):
    """A binarized cell (normal, reduction, and after a reduction: the
    FactorizedReduce preprocessing), its two inputs from one draw: eval in
    f32 within 1e-4, train-mode gradients in float64 within 1e-4."""
    g = bnn_tpu.models.BATS_EXAMPLE
    c_pp, c_p = (2 * C, 3 * C)
    jm = jax_model(lambda: bnn_tpu.models.Cell(g, c_pp, c_p, C, reduction,
                                               reduction_prev, groups=4,
                                               rngs=nnx.Rngs(0)))
    tm = bt.models.Cell(g, c_pp, c_p, C, reduction, reduction_prev, groups=4)
    jm, tm = carry(jm, tm, 4, binarize=True, ignore=[])
    s = 2 if reduction_prev else 1
    x = x_nhwc((2, 8 * s, 8 * s, c_pp + c_p))

    def call(m, v):
        if isinstance(m, torch.nn.Module):
            s0, s1 = v[:, :c_pp], v[:, c_pp:, ::s, ::s]
        else:
            s0, s1 = v[..., :c_pp], v[:, ::s, ::s, c_pp:]
        return m(s0, s1)

    assert_matches(jm, tm, x, tol=1e-4, call=call)
    jm.eval()
    tm.eval()
    with torch.no_grad():
        got = call(tm, nchw(x)).permute(0, 2, 3, 1).numpy()
    assert rel(got, np.asarray(call(jm, jnp.asarray(x)))) < 1e-4


def test_auxiliary_head_matches_jax():
    jm = jax_model(lambda: bnn_tpu.models.AuxiliaryHead(C, 10, 3, rngs=nnx.Rngs(0)))
    tm = bt.models.AuxiliaryHead(C, 10, 3)
    jm, tm = carry(jm, tm, 5)
    x = x_nhwc((2, 8, 8, C))
    assert rel(eval_forward(tm, x), eval_forward(jm, x)) < 1e-5
    assert_matches(jm, tm, x, tol=1e-5)


@functools.lru_cache(maxsize=None)
def networks(kind, auxiliary, binarize):
    """(JAX, port) BATS network of ``kind``, C = 8, 4 layers, groups 4."""
    g = bnn_tpu.models.BATS_EXAMPLE
    if kind == "cifar":
        jm = jax_model(lambda: bnn_tpu.models.BATSNetworkCIFAR(
            C, 10, 4, auxiliary, g, groups=4, rngs=nnx.Rngs(0)))
        tm = bt.models.BATSNetworkCIFAR(C, 10, 4, auxiliary, bt.models.BATS_EXAMPLE,
                                        groups=4)
    else:
        jm = jax_model(lambda: bnn_tpu.models.BATSNetworkImageNet(
            C, 10, 4, auxiliary, g, groups=4, rngs=nnx.Rngs(0)))
        tm = bt.models.BATSNetworkImageNet(C, 10, 4, auxiliary, bt.models.BATS_EXAMPLE,
                                           groups=4)
    return carry(jm, tm, 6, binarize=binarize)


@pytest.mark.parametrize("kind,size", [("cifar", 32), ("imagenet", 224)])
def test_network_matches_jax(kind, size):
    """Binarized network with its auxiliary head. Eval mode, with drop-path
    probability 0.3 and shake-shake on (eval takes no draw): logits in f32
    within 1e-4, no auxiliary logits. Train mode with drop-path probability
    0: logits and auxiliary logits in float64 within 1e-12 (no draw is
    taken, and the sums are exact), every gradient within 1e-4."""
    jm, tm = networks(kind, True, True)
    x = x_nhwc((1 if kind == "imagenet" else 2, size, size, 3))
    je, te = copy.deepcopy(jm), copy.deepcopy(tm)
    for cell in list(je.cells) + list(te.cells):
        cell.use_shake_shake = True
    je.drop_path_prob = te.drop_path_prob = 0.3
    assert rel(eval_forward(te, x), eval_forward(je, x)) < 1e-4
    assert te(nchw(x))[1] is None

    def call(m, v):
        logits, aux = m(v)
        cat = torch.cat if isinstance(logits, torch.Tensor) else jnp.concatenate
        return cat([logits, aux], 1)

    assert_matches(jm, tm, x, tol=1e-4, out_tol=1e-12, call=call)


def test_binarized_layer_names_match_jax():
    """``_first_`` is the stem's conv and ``_last_`` the classifier in both
    packages: the same layers are binarized in both BATS networks (the DaBNN
    ResNet-18's: ``test_torch_zoo``)."""
    from bnn_tpu.binarize import named_modules

    for kind in ("cifar", "imagenet"):
        jm, tm = networks(kind, True, True)
        want = sorted(n for n, m in named_modules(jm)
                      if isinstance(m, (bnn_tpu.layers.Conv2d, bnn_tpu.layers.Linear)))
        got = sorted(n for n, m in tm.named_modules()
                     if isinstance(m, (bt.layers.Conv2d, bt.layers.Linear)))
        assert got == want and want
        stem = tm.stem[0] if kind == "cifar" else tm.stem0[0]
        assert type(stem) is torch.nn.Conv2d
        assert type(tm.classifier) is torch.nn.Linear


# --- randomness ------------------------------------------------------------------

def test_drop_path_draws():
    """The gate: per sample, rate 1 - p within 3 sigma over many draws,
    kept samples scaled by 1 / (1 - p); the same generator state gives the
    same draws."""
    p, n = 0.2, 20000
    x = torch.ones(n, 2, 3, 3)
    g = torch.Generator().manual_seed(0)
    state = g.get_state()
    y = tbats.drop_path(x, p, g)
    per_sample = y.reshape(n, -1)
    assert bool(((per_sample == 0).all(1) | (per_sample == 1 / (1 - p)).all(1)).all())
    kept = float((per_sample[:, 0] != 0).float().mean())
    assert abs(kept - (1 - p)) < 3 * np.sqrt(p * (1 - p) / n)
    g.set_state(state)
    assert torch.equal(tbats.drop_path(x, p, g), y)


def test_network_stream_is_seeded_and_carried():
    """Drop-path and shake-shake draw from the network's own stream: two
    networks of one seed draw alike, and a restored state_dict draws on
    from where the saved one stopped."""
    def net(seed):
        m = bt.models.BATSNetworkCIFAR(C, 10, 4, False, bt.models.BATS_EXAMPLE,
                                       groups=4, generator=torch.Generator().manual_seed(0),
                                       seed=seed)
        for cell in m.cells:
            cell.use_shake_shake = True
        m.drop_path_prob = 0.3
        return m.train()

    x = torch.randn(4, 3, 16, 16)
    a, b = net(1), net(1)
    torch.testing.assert_close(a(x)[0], b(x)[0], rtol=0, atol=0)
    saved = copy.deepcopy(a.state_dict())
    want = a(x)[0]
    c = net(1)
    c.load_state_dict(saved)
    torch.testing.assert_close(c(x)[0], want, rtol=0, atol=0)
    assert not torch.equal(net(2)(x)[0], net(1)(x)[0])


# --- deployment ---------------------------------------------------------------------

def test_bats_deploys_like_jax():
    """deploy + optimize_deployed on a binarized BATS CIFAR net: the same
    BN folds as JAX's, every grouped conv in conv mode, and logits within
    JAX's own QAT-vs-deployed tolerance (0.15 relative L2) of JAX's deployed
    net and of the port's QAT net."""
    from bnn_tpu.inference import deploy as jdeploy
    from bnn_tpu.inference import optimize_deployed as jopt
    from bnn_tpu_torch.inference import DeployedConv, deploy, optimize_deployed

    jm, tm = networks("cifar", True, True)
    jm, tm = copy.deepcopy(jm), copy.deepcopy(tm)
    jm.eval()
    tm.eval()
    x = x_nhwc((2, 32, 32, 3), seed=8)
    qat = eval_forward(tm, x)
    jd = jdeploy(jm, use_pallas=False)
    td = deploy(tm)
    assert optimize_deployed(td) == jopt(jd) > 0
    grouped = [m for m in td.modules() if isinstance(m, DeployedConv) and m.groups > 1]
    assert grouped and all(m.mode == "conv" for m in grouped)
    got, want = eval_forward(td, x), eval_forward(jd, x)
    for ref in (want, qat):
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 0.15


def test_grouped_conv_accumulators_match_jax_exactly():
    """A grouped deployed conv's int32 sums (scale 1, add 0) equal JAX's,
    with the BN-before fold's weight flips and threshold in place."""
    from bnn_tpu.inference.deploy import DeployedConv as JDeployed
    from bnn_tpu.inference.optimize import fold_bn_before as jfold
    from bnn_tpu_torch.inference import DeployedConv, fold_bn_before

    jop = bnn_tpu.prepare_binary_model(
        jax_model(lambda: jbats.SepConv(12, 12, 3, 1, 1, groups=4, rngs=nnx.Rngs(0))),
        bnn_tpu.BConfig(*FLAGSHIP_J))
    top = bt.prepare_binary_model(tbats.SepConv(12, 12, 3, 1, 1, groups=4),
                                  bt.BConfig(*FLAGSHIP_T))
    jop, top = carry(jop, top, 7)
    jop.eval()
    top.eval()
    jconv = JDeployed(getattr(jop.op, "1"), use_pallas=False)
    tconv = DeployedConv(top.op[1])
    assert tconv.mode == "conv" and tconv.groups == 4
    assert jfold(getattr(jop.op, "0"), jconv) and fold_bn_before(top.op[0], tconv)
    jconv.scale[...] = jnp.ones_like(jconv.scale[...])
    jconv.add[...] = jnp.zeros_like(jconv.add[...])
    tconv.scale = torch.ones_like(tconv.scale)
    tconv.add = torch.zeros_like(tconv.add)
    x = x_nhwc((2, 9, 7, 12), seed=3)
    x[0, 0, :3, :] = 0.0
    with torch.no_grad():
        got = tconv(nchw(x)).permute(0, 2, 3, 1).numpy()
    want = np.asarray(jconv(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(got, np.round(got)) and np.abs(got).max() > 0


def test_remat_redraws_the_same_drop_path_noise():
    """``make_train_step(remat=True)`` recomputes the forward with the
    network's stream put back: with drop-path and shake-shake on, one step
    equals the plain step bit for bit, and both streams end alike."""
    from bnn_tpu_torch.parallel import make_train_step

    def net():
        m = bt.models.BATSNetworkCIFAR(C, 10, 4, True, bt.models.BATS_EXAMPLE,
                                       groups=4, generator=torch.Generator().manual_seed(0),
                                       seed=3)
        for cell in m.cells:
            cell.use_shake_shake = True
        m.drop_path_prob = 0.3
        return m.train()

    x = torch.randn(4, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    y = torch.tensor([0, 1, 2, 3])
    runs = []
    for remat in (False, True):
        m = net()
        opt = torch.optim.SGD(m.parameters(), lr=0.1)
        loss = make_train_step(aux_weight=0.4, remat=remat)(m, opt, x, y)["loss"]
        runs.append((loss, m.state_dict(), m.noise.generator(x.device).get_state()))
    (l0, s0, g0), (l1, s1, g1) = runs
    assert torch.equal(l0, l1) and torch.equal(g0, g1)
    assert all(torch.equal(s0[k], s1[k]) for k in s0 if isinstance(s0[k], torch.Tensor))
