"""QAT training in the port (bnn_tpu_torch.parallel, bnn_tpu_torch.nn's
BatchNorm) against bnn_tpu's on the CPU: the same weights (carried by
load_jax_state), the same batches (numpy, from a seed), the same optimizer.

Tolerances are PARITY.md's: fp32 (all-Identity binarizer) configs are held
step by step; a binary config only at step 0 and at block level, where its
gradients go through the STE boundaries (input gradients 1e-4, each
parameter's 2e-2, both as max |diff| over max |reference|).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

import bnn_tpu
import bnn_tpu_torch as bt
from bnn_tpu.ops import binarizers as jops
from bnn_tpu.parallel import make_eval_step as jax_eval_step
from bnn_tpu.parallel import make_train_step as jax_train_step
from bnn_tpu_torch.ops import binarizers as tops
from bnn_tpu_torch.parallel import make_eval_step, make_train_step
from bnn_tpu_torch.utils import jax_to_port, load_jax_state
from test_torch_small_batch import _randomized, _write_flat

_BCONFIGS = {
    # name -> (pre, post, weight) binarizer names, the same in both packages
    "fp32": ("Identity", "Identity", "Identity"),
    "binary": ("BasicInputBinarizer", "BasicScaleBinarizer",
               "XNORWeightBinarizer"),
}
_OPTIMIZERS = {
    # name -> (optax transform, torch optimizer factory)
    "adam": (lambda: optax.adam(1e-3),
             lambda p: torch.optim.Adam(p, lr=1e-3)),
    "adamw": (lambda: optax.adamw(1e-3, weight_decay=1e-4),
              lambda p: torch.optim.AdamW(p, lr=1e-3, weight_decay=1e-4)),
    "sgd": (lambda: optax.sgd(0.05, momentum=0.9),
            lambda p: torch.optim.SGD(p, lr=0.05, momentum=0.9)),
}


def _flat(state):
    """{dotted path: numpy array} of an nnx State."""
    out = {}

    def walk(prefix, d):
        for k, v in d.items():
            key = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, dict):
                walk(key, v)
            else:
                out[key] = np.asarray(v)

    walk("", nnx.to_pure_dict(state))
    return out


def _pair(config="fp32", seed=0):
    """(JAX model, port model) of a [1, 1, 1, 1] ResNet with 10 classes, in
    train mode, on the same weights. BN scales and biases and output scales
    are random, as after training: at their initial values (scale 1, bias
    0) a binary conv's outputs, multiples of alpha, put whole channels of
    its BN's output within rounding of 0 whenever the channel's batch mean
    falls on one of those multiples, and the sign after it is then noise in
    either package."""
    pre, post, weight = _BCONFIGS[config]
    jm = bnn_tpu.models.ResNet(bnn_tpu.models.layers.BasicBlock, [1, 1, 1, 1],
                               num_classes=10, rngs=nnx.Rngs(seed))
    jm = bnn_tpu.prepare_binary_model(
        jm, bnn_tpu.BConfig(getattr(jops, pre), getattr(jops, post),
                            getattr(jops, weight)),
        ignore_layers_name=["_first_", "_last_"])
    tm = bt.models.ResNet(bt.models.BasicBlock, [1, 1, 1, 1], num_classes=10)
    tm = bt.prepare_binary_model(
        tm, bt.BConfig(getattr(tops, pre), getattr(tops, post),
                       getattr(tops, weight)),
        ignore_layers_name=["_first_", "_last_"])
    flat = _randomized(_flat(nnx.state(jm)), np.random.RandomState(seed))
    _write_flat(jm, flat)
    load_jax_state(tm, flat)
    jm.train()
    tm.train()
    return jm, tm


def _batches(n, batch=8, seed=1):
    rng = np.random.RandomState(seed)
    return [(rng.randn(batch, 32, 32, 3).astype(np.float32),
             rng.randint(0, 10, batch).astype(np.int32)) for _ in range(n)]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _train_both(jm, tm, optimizer, batches, f64=False, **kw):
    """Per-step losses of both packages, each through its make_train_step;
    with ``f64``, both models and batches in float64 (the loss stays f32)."""
    jtx, topt = _OPTIMIZERS[optimizer]
    if f64:
        bnn_tpu.utils.cast_floats(jm, jnp.float64)
        tm.double()
    jopt = nnx.Optimizer(jm, jtx(), wrt=nnx.Param)
    jstep = jax_train_step(**{k: (jnp.bfloat16 if k == "compute_dtype" else v)
                              for k, v in kw.items()})
    tstep = make_train_step(**{k: (torch.bfloat16 if k == "compute_dtype" else v)
                               for k, v in kw.items()})
    opt = topt(tm.parameters())
    jl, tl = [], []
    for x, y in batches:
        xj, xt = jnp.asarray(x), _nchw(x)
        if f64:
            xj, xt = xj.astype(jnp.float64), xt.double()
        jl.append(float(jstep(jm, jopt, xj, jnp.asarray(y))["loss"]))
        tl.append(float(tstep(tm, opt, xt, torch.from_numpy(y).long())["loss"]))
    return np.array(jl), np.array(tl)


def _assert_state_close(jm, tm, tol):
    """Every parameter and BN statistic of the port within ``tol`` of JAX's,
    as the relative L2 distance of the tensor."""
    want = jax_to_port(tm, _flat(nnx.state(jm)))
    got = tm.state_dict()
    assert want.keys() <= got.keys()
    worst = {k: float((got[k].double() - v.double()).norm()
                      / (v.double().norm() + 1e-12)) for k, v in want.items()}
    assert max(worst.values()) < tol, sorted(worst.items(), key=lambda kv: -kv[1])[:3]


@pytest.mark.parametrize("rank", [4, 2])
@pytest.mark.parametrize("forwards", [1, 3])
def test_batchnorm_running_stats_match_jax(forwards, rank):
    """The port's BatchNorm updates its running variance with the biased
    batch variance, as flax does (torch's own layer takes the unbiased one),
    and normalises alike."""
    jbn = bnn_tpu.nn.BatchNorm2d(3, rngs=nnx.Rngs(0))
    tbn = bt.nn.BatchNorm2d(3) if rank == 4 else bt.nn.BatchNorm1d(3)
    rng = np.random.RandomState(forwards + rank)
    for _ in range(forwards):
        shape = (4, 5, 5, 3) if rank == 4 else (6, 3)
        x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)
        want = np.asarray(jbn(jnp.asarray(x)))
        xt = torch.from_numpy(x)
        got = tbn(xt.permute(0, 3, 1, 2) if rank == 4 else xt)
        got = got.permute(0, 2, 3, 1) if rank == 4 else got
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tbn.running_mean.numpy(), np.asarray(jbn.mean[...]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tbn.running_var.numpy(), np.asarray(jbn.var[...]),
                               rtol=1e-6, atol=1e-7)
    assert int(tbn.num_batches_tracked) == forwards


@pytest.mark.parametrize("optimizer", ["adam", "adamw", "sgd"])
def test_fp32_steps_match_jax(optimizer):
    """Three steps of the fp32 (all-Identity) config, held in float64 on
    both sides: in f32 the two packages' gradients differ by rounding
    (layer4's BN sees 8 values a channel at this size), which Adam's
    normalised steps carry past 1e-4 of a tensor within three steps. The
    f32 step is held by test_f32_first_step_matches_jax."""
    jm, tm = _pair("fp32")
    with jax.enable_x64(True):
        jl, tl = _train_both(jm, tm, optimizer, _batches(3), f64=True)
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        _assert_state_close(jm, tm, 1e-4)


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_f32_first_step_matches_jax(optimizer):
    jm, tm = _pair("fp32")
    jl, tl = _train_both(jm, tm, optimizer, _batches(1))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    _assert_state_close(jm, tm, 1e-4)


def test_binary_step0_loss_matches_jax():
    jm, tm = _pair("binary")
    jl, tl = _train_both(jm, tm, "adamw", _batches(1))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def _rel(got, want, scale=None):
    scale = np.abs(want).max() if scale is None else scale
    return float(np.abs(got - want).max() / (scale + 1e-12))


def grad_diffs(got, want):
    """Each parameter's max |gradient difference| over its largest gradient.
    An output scale ``convN...alpha`` is measured against ``bnN.weight``'s
    gradient: the train-mode BN right after the conv makes the loss
    invariant to the scale, so its own gradient is rounding noise around
    0 in either package."""
    want = {k: np.asarray(w) for k, w in want.items()}
    diffs = {}
    for k, w in want.items():
        ref = want.get(k.split(".")[0].replace("conv", "bn") + ".weight")
        scale = (np.abs(ref).max() if k.endswith(".alpha") and ref is not None
                 else None)
        diffs[k] = _rel(np.asarray(got[k]), np.asarray(w), scale)
    return diffs


@pytest.mark.parametrize("block,chans,size", [("layer1", 64, 8), ("layer2", 64, 8)])
def test_binary_block_gradients_match_jax(block, chans, size):
    """Train-mode gradients through a binary basic block (sign STE, XNOR
    weights, learnable scales, BN on batch statistics)."""
    jm, tm = _pair("binary")
    jb, tb = getattr(getattr(jm, block), "0"), getattr(tm, block)[0]
    rng = np.random.RandomState(3)
    x = rng.randn(4, size, size, chans).astype(np.float32)
    xt = _nchw(x).requires_grad_(True)
    out = tb(xt)
    g = rng.randn(*out.shape).astype(np.float32)
    out.backward(torch.from_numpy(g))
    gj = jnp.asarray(g.transpose(0, 2, 3, 1))
    jgrads, jgx = nnx.grad(lambda m, v: (m(v) * gj).sum(), argnums=(0, 1))(
        jb, jnp.asarray(x))
    assert _rel(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jgx)) < 1e-4
    want = jax_to_port(tb, _flat(jgrads))
    got = {k: p.grad for k, p in tb.named_parameters()}
    assert want and want.keys() == got.keys()
    worst = grad_diffs(got, want)
    assert max(worst.values()) < 2e-2, sorted(worst.items(), key=lambda kv: -kv[1])[:3]


def test_bf16_compute_matches_jax():
    """Mixed precision: bf16 compute over f32 masters; the BN statistics
    stay f32 and are updated."""
    jm, tm = _pair("fp32")
    start = copy.deepcopy(tm.state_dict())
    jl, tl = _train_both(jm, tm, "adam", _batches(3), compute_dtype=True)
    np.testing.assert_allclose(tl, jl, rtol=1e-2)
    for k, v in tm.state_dict().items():
        if v.is_floating_point():
            assert v.dtype == torch.float32, k
            assert not torch.equal(v, start[k]), k
    assert all(p.grad.dtype == torch.float32 for p in tm.parameters())


def test_accum_steps_match_jax():
    """Two microbatches a step, BN statistics per microbatch, one Adam
    step over the averaged gradients; float64, as above."""
    jm, tm = _pair("fp32")
    with jax.enable_x64(True):
        jl, tl = _train_both(jm, tm, "adam", _batches(3, batch=16), f64=True,
                             accum_steps=2)
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        _assert_state_close(jm, tm, 1e-4)


def test_accum_steps_refuse_a_batch_that_does_not_split():
    _, tm = _pair("fp32")
    step = make_train_step(accum_steps=3)
    x, y = _batches(1)[0]
    with pytest.raises(ValueError, match="equal microbatches"):
        step(tm, torch.optim.SGD(tm.parameters(), lr=0.1), _nchw(x),
             torch.from_numpy(y).long())


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_remat_is_bitwise_the_plain_step(compute_dtype):
    """remat recomputes the forward in the backward: BN statistics are
    written once and a stochastic binarizer draws the same noise again, so
    the step equals the plain one bit for bit on the CPU."""
    tm = bt.models.ResNet(bt.models.BasicBlock, [1, 1, 1, 1], num_classes=10,
                          generator=torch.Generator().manual_seed(0))
    tm = bt.prepare_binary_model(
        tm, bt.BConfig(tops.StochasticInputBinarizer.with_args(seed=5),
                       tops.BasicScaleBinarizer, tops.XNORWeightBinarizer),
        ignore_layers_name=["_first_", "_last_"]).train()
    runs = []
    for remat in (False, True):
        m = copy.deepcopy(tm)
        opt = torch.optim.AdamW(m.parameters(), lr=1e-3, weight_decay=1e-4)
        step = make_train_step(remat=remat, compute_dtype=compute_dtype)
        losses = [step(m, opt, _nchw(x), torch.from_numpy(y).long())["loss"]
                  for x, y in _batches(2)]
        draws = [b.generator("cpu").get_state() for b in m.modules()
                 if isinstance(b, tops.StochasticInputBinarizer)]
        runs.append((losses, m.state_dict(), draws))
    (l0, s0, d0), (l1, s1, d1) = runs
    assert [float(v) for v in l0] == [float(v) for v in l1]
    assert s0.keys() == s1.keys()
    for k in s0:
        if k.endswith("._extra_state"):  # a binarizer's seed and streams
            assert s0[k]["seed"] == s1[k]["seed"], k
            assert s0[k]["states"].keys() == s1[k]["states"].keys(), k
            assert all(torch.equal(v, s1[k]["states"][d])
                       for d, v in s0[k]["states"].items()), k
        else:
            assert torch.equal(s0[k], s1[k]), k
    assert len(d0) > 1 and all(torch.equal(a, b) for a, b in zip(d0, d1))
    assert int(s1["layer1.0.bn1.num_batches_tracked"]) == 2


class _AuxJ(nnx.Module):
    def __init__(self, rngs):
        self.body = bnn_tpu.nn.Linear(6, 5, rngs=rngs)
        self.aux = bnn_tpu.nn.Linear(6, 5, rngs=rngs)

    def __call__(self, x):
        return self.body(x), self.aux(jnp.tanh(x))


class _AuxT(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.body = torch.nn.Linear(6, 5)
        self.aux = torch.nn.Linear(6, 5)

    def forward(self, x):
        return self.body(x), self.aux(torch.tanh(x))


@pytest.mark.parametrize("aux_weight", [0.0, 0.4])
def test_aux_weight_matches_jax(aux_weight):
    """A model returning (logits, aux) adds aux_weight * loss(aux)."""
    jm, tm = _AuxJ(nnx.Rngs(0)), _AuxT()
    load_jax_state(tm, _flat(nnx.state(jm)))
    rng = np.random.RandomState(4)
    x, y = rng.randn(8, 6).astype(np.float32), rng.randint(0, 5, 8)
    jopt = nnx.Optimizer(jm, optax.sgd(0.1), wrt=nnx.Param)
    jl = jax_train_step(aux_weight=aux_weight)(jm, jopt, jnp.asarray(x),
                                               jnp.asarray(y))
    opt = torch.optim.SGD(tm.parameters(), lr=0.1)
    tl = make_train_step(aux_weight=aux_weight)(tm, opt, torch.from_numpy(x),
                                                torch.from_numpy(y).long())
    np.testing.assert_allclose(float(tl["loss"]), float(jl["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tl["top1"]), float(jl["top1"]))
    _assert_state_close(jm, tm, 1e-5)
    assert (tm.aux.weight.grad is not None) == bool(aux_weight)


def test_eval_step_sums_match_jax():
    jm, tm = _pair("fp32")
    jm.eval()
    tm.eval()
    x, y = _batches(1, batch=16, seed=6)[0]
    want = jax_eval_step()(jm, jnp.asarray(x), jnp.asarray(y))
    got = make_eval_step()(tm, _nchw(x), torch.from_numpy(y).long())
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    assert float(got["count"]) == 16
