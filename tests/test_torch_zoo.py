"""The port's model zoo beyond the basic-stem ResNets against ``bnn_tpu`` on
the CPU: the DaBNN stem and its ResNet-18 (float and binarized, basic and
pre-activation PReLU blocks), HBlock, ``MultiheadAttention`` and
``LayerNorm``; the serving passes on the DaBNN stem (``space_to_depth_stem``,
the BN folds) and the fused ``Predictor``'s module tree after each recipe's
two steps, against JAX's passes.

Weights are made on the JAX side, BN statistics, scales and slopes made
random with numpy (``_randomized``), and carried with ``load_jax_state``;
inputs are numpy draws from a seed. Tolerances are stated per check, as the
largest difference over the largest reference value of each tensor.
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import bnn_tpu
import bnn_tpu_torch as bt
from bnn_tpu.ops import binarizers as jops
from bnn_tpu_torch.ops import binarizers as tops
from bnn_tpu_torch.utils import jax_to_port, load_jax_state
from test_torch_small_batch import _flat, _randomized, _write_flat

FLAGSHIP_J = (jops.BasicInputBinarizer, jops.BasicScaleBinarizer,
              jops.XNORWeightBinarizer)
FLAGSHIP_T = (tops.BasicInputBinarizer, tops.BasicScaleBinarizer,
              tops.XNORWeightBinarizer)
IGNORE = ["_first_", "_last_"]


def _construction_order(module, traced) -> None:
    """Put ``module``'s attributes (and its children's) in the order of
    ``traced``'s, a module built by the same constructor."""
    d, order = vars(module), list(vars(traced))
    items = ([(k, d[k]) for k in order if k in d]
             + [(k, v) for k, v in d.items() if k not in order])
    d.clear()
    d.update(items)
    for k, v in items:
        t = vars(traced).get(k)
        if isinstance(v, nnx.Module) and isinstance(t, nnx.Module):
            _construction_order(v, t)


def jax_model(build, seed=0):
    """``build()``'s JAX module, its state drawn with numpy (kernels normal
    over fan-in, norms at identity, PReLU slopes 0.25, RNG keys from
    ``seed``) instead of by its initializers: ``nnx.eval_shape`` builds it
    without tracing and compiling each initializer, which costs seconds a
    shape on the CPU. ``nnx.eval_shape`` lists a module's attributes sorted;
    they are put back in construction order (a constructor run under
    ``jax.eval_shape``), which ``_first_`` and ``_last_`` follow."""
    traced = []
    jax.eval_shape(lambda: (traced.append(build()), jnp.zeros(()))[1])
    module = nnx.eval_shape(build)
    _construction_order(module, traced[0])
    state = nnx.state(module)
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if jax.dtypes.issubdtype(leaf.dtype, jax.dtypes.prng_key):
            return jax.random.key(seed)
        if not jnp.issubdtype(leaf.dtype, jnp.floating):
            return jnp.zeros(leaf.shape, leaf.dtype)
        if name == "kernel":
            v = rng.randn(*leaf.shape) / np.sqrt(max(1, np.prod(leaf.shape[:-1])))
        elif name in ("scale", "var", "alpha"):
            v = np.ones(leaf.shape)
        elif name == "weight":
            v = np.full(leaf.shape, 0.25)
        else:
            v = np.zeros(leaf.shape)
        return jnp.asarray(v, leaf.dtype)

    nnx.replace_by_pure_dict(state, jax.tree_util.tree_map_with_path(
        fill, nnx.to_pure_dict(state)))
    nnx.update(module, state)
    return module


def rel(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def to_jax_layout(t: torch.Tensor):
    a = t.detach().numpy()
    return jnp.asarray(a.transpose(0, 2, 3, 1) if a.ndim == 4 else a)


def first(out):
    return out[0] if isinstance(out, tuple) else out


# imagenet-baseline.yaml's second step: weights sign(W), no alpha
RECIPE_J = (jops.BasicInputBinarizer, jops.BasicScaleBinarizer,
            jops.XNORWeightBinarizer.with_args(compute_alpha=False))
RECIPE_T = (tops.BasicInputBinarizer, tops.BasicScaleBinarizer,
            tops.XNORWeightBinarizer.with_args(compute_alpha=False))


def carry(jm, tm, seed, *, binarize, config=(FLAGSHIP_J, FLAGSHIP_T)):
    """Binarize both with ``config`` (the flagship BConfig by default,
    ``_first_``/``_last_`` float) when asked, randomize JAX's norm state
    and carry it over."""
    if binarize:
        jm = bnn_tpu.prepare_binary_model(jm, bnn_tpu.BConfig(*config[0]),
                                          ignore_layers_name=IGNORE)
        tm = bt.prepare_binary_model(tm, bt.BConfig(*config[1]),
                                     ignore_layers_name=IGNORE)
    flat = _randomized(_flat(jm), np.random.RandomState(seed))
    _write_flat(jm, flat)
    load_jax_state(tm, flat)
    return jm, tm


def forward_and_grads(jm, tm, x, *, train, layout_4d=True, seed=7, call=None,
                      f64=True):
    """Both models' outputs on ``x`` (numpy, JAX's layout) and the gradients
    of ``sum(out * g)`` for a random ``g``: ``(out_t, out_j, gx_t, gx_j,
    grads_t, grads_j)``, the port's in its own layout, JAX's carried into
    it. With ``f64`` (the default) both run on float64 copies: in f32 a
    train-mode BN over few values a channel (ResNet-18's layer4 at 32x32
    sees 2) turns rounding into differences past 1e-4."""
    if f64:
        with jax.enable_x64(True):
            jm = copy.deepcopy(jm)
            bnn_tpu.utils.cast_floats(jm, jnp.float64)
            return forward_and_grads(jm, copy.deepcopy(tm).double(),
                                     x.astype(np.float64), train=train,
                                     layout_4d=layout_4d, seed=seed, call=call,
                                     f64=False)
    jm.train() if train else jm.eval()
    tm.train(train)
    call = call or (lambda m, v: first(m(v)))
    xt = (nchw(x) if layout_4d else torch.from_numpy(x.copy())).requires_grad_(True)
    out_t = call(tm, xt)
    g = np.random.RandomState(seed).randn(*out_t.shape).astype(x.dtype)
    gt = torch.from_numpy(g)
    (out_t * gt).sum().backward()
    gj = to_jax_layout(gt)

    def loss(m, v):
        o = call(m, v)
        return (o * gj).sum(), o

    (_, out_j), (jgrads, gx_j) = nnx.jit(nnx.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jm, jnp.asarray(x))
    gx_t = xt.grad
    if layout_4d:
        gx_t = gx_t.permute(0, 2, 3, 1)
        out_t = out_t.permute(0, 2, 3, 1) if out_t.ndim == 4 else out_t
    grads_j = jax_to_port(tm, _flat(jgrads))
    grads_t = {k: p.grad for k, p in tm.named_parameters() if p.grad is not None}
    return (out_t.detach().numpy(), np.asarray(out_j), gx_t.numpy(),
            np.asarray(gx_j), grads_t, grads_j)


def eval_forward(m, x):
    """``m``'s eval-mode f32 output on ``x`` (JAX's layout), as numpy."""
    m.eval()
    if isinstance(m, torch.nn.Module):
        with torch.no_grad():
            out = first(m(nchw(x) if x.ndim == 4 else torch.from_numpy(x)))
        return (out.permute(0, 2, 3, 1) if out.ndim == 4 else out).numpy()
    return np.asarray(first(nnx.jit(lambda mm, v: mm(v))(m, jnp.asarray(x))))


def assert_matches(jm, tm, x, *, tol, out_tol=None, train=True, **kw):
    """Forward, input gradient and every parameter gradient within ``tol``.
    A parameter gradient is measured against the larger of its own largest
    value and 1e-3 of the model's largest gradient: where the loss is
    invariant to a parameter (a BN bias or an output scale's alpha under a
    later train-mode BN) its gradient is rounding noise around 0 in either
    package. The outputs are held to ``out_tol`` where it is given."""
    out_t, out_j, gx_t, gx_j, gt, gj = forward_and_grads(jm, tm, x, train=train, **kw)
    assert rel(out_t, out_j) < (tol if out_tol is None else out_tol), rel(out_t, out_j)
    assert rel(gx_t, gx_j) < tol, rel(gx_t, gx_j)
    assert gj.keys() == gt.keys() == {k for k, _ in tm.named_parameters()}, \
        sorted(set(gj) ^ set(gt))[:5]
    if not gj:
        return
    floor = 1e-3 * max(float(v.abs().max()) for v in gj.values())
    worst = {k: float((gt[k].double() - v.double()).abs().max())
             / max(float(v.abs().max()), floor) for k, v in gj.items()}
    assert max(worst.values()) < tol, sorted(worst.items(), key=lambda kv: -kv[1])[:3]


# --- the DaBNN stem and its ResNet-18 ------------------------------------------

_DABNN = {
    # name -> (pre-activation blocks and PReLU, binarized)
    "float": (False, False),
    "float_pre_prelu": (True, False),
    "binary": (False, True),
    "binary_pre_prelu": (True, True),
}


def dabnn_pair(name, seed=0):
    """The reference's ImageNet configuration (pre-activation blocks, PReLU)
    binarizes with imagenet-baseline.yaml's second step: its conv outputs
    are integer sums times a scale, exact in either package, where XNOR's
    alpha * sign(W) sums round by the summation order, and a sum of exactly
    0 meets PReLU's kink (slope or 1) in one package but not the other."""
    pre, binary = _DABNN[name]
    jkw, tkw = {}, {}
    if pre:
        jkw = dict(block_type=bnn_tpu.models.layers.PreBasicBlock,
                   activation=bnn_tpu.nn.PReLU)
        tkw = dict(block_type=bt.models.PreBasicBlock, activation=torch.nn.PReLU)
    jm = jax_model(lambda: bnn_tpu.models.resnet18(
        num_classes=10, stem_type="dabnn", rngs=nnx.Rngs(0), **jkw), seed)
    tm = bt.models.resnet18(num_classes=10, stem_type="dabnn", **tkw)
    config = (RECIPE_J, RECIPE_T) if pre else (FLAGSHIP_J, FLAGSHIP_T)
    return carry(jm, tm, seed + 11, binarize=binary, config=config)


_X32 = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)


@pytest.mark.parametrize("name", list(_DABNN))
def test_dabnn_resnet18_matches_jax(name):
    """Eval forward in f32, then the train-mode forward with the input and
    every parameter gradient in float64: 1e-5 for the float models, 1e-4 for
    the binarized ones."""
    jm, tm = dabnn_pair(name)
    binary = _DABNN[name][1]
    tol = 1e-4 if binary else 1e-5
    assert rel(eval_forward(tm, _X32), eval_forward(jm, _X32)) < tol
    assert_matches(jm, tm, _X32, tol=tol)


def test_dabnn_stem_structure_and_first_layer():
    """The stem registers in JAX's order (``conv1.conv1.0`` is ``_first_``),
    takes the requested activation, and the forward skips bn1/maxpool."""
    jm, tm = dabnn_pair("binary_pre_prelu")
    names_j = [n for n, m in bnn_tpu.named_modules(jm)
               if isinstance(m, bnn_tpu.layers.Conv2d)]
    names_t = [n for n, m in tm.named_modules() if isinstance(m, bt.layers.Conv2d)]
    assert names_t == names_j
    assert "conv1.conv1.0" not in names_t and "conv1.conv2_1.0" in names_t
    assert type(tm.conv1.conv1[0]) is torch.nn.Conv2d
    assert isinstance(tm.conv1.conv3[2], torch.nn.PReLU)
    assert not hasattr(tm, "bn1")
    with pytest.raises(ValueError, match="stem_type"):
        bt.models.resnet18(stem_type="nope")


def test_space_to_depth_and_folds_on_dabnn_stem():
    """On the float DaBNN ResNet-18, ``space_to_depth_stem`` rewrites what
    JAX's does (2 convs: conv1.conv1.0 and conv2_2) and the BN folds remove
    as many norms, none of them a bn1; the port's folded and rewritten
    model is within 1e-4 of JAX's QAT model. The binarized stem (conv2_2 binary: 1 rewrite) is
    checked through the ``Predictor`` in
    ``test_fused_predictor_tree_matches_jax``."""
    from bnn_tpu.inference import deploy as jdeploy
    from bnn_tpu.inference import optimize_deployed as jopt
    from bnn_tpu.inference.stem import space_to_depth_stem as js2d
    from bnn_tpu_torch.inference import deploy, optimize_deployed, space_to_depth_stem

    jm, tm = dabnn_pair("float")
    jm.eval()
    tm.eval()
    jd = jdeploy(copy.deepcopy(jm), use_pallas=False)
    td = deploy(copy.deepcopy(tm))
    assert jopt(jd) == optimize_deployed(td) > 0
    assert not hasattr(td, "bn1")
    assert js2d(jd) == space_to_depth_stem(td) == 2
    assert rel(eval_forward(td, _X32), eval_forward(jm, _X32)) < 1e-4


# --- HBlock ------------------------------------------------------------------------

def test_hblock_matches_jax():
    """Two stacked binarized HBlocks (32 -> 32, ReLU), eval forward and
    train-mode gradients within 1e-4."""
    jblk = bnn_tpu.models.layers.HBlock
    jm = jax_model(lambda: bnn_tpu.nn.Sequential(jblk(32, 32, rngs=nnx.Rngs(0)),
                                                 jblk(32, 32, rngs=nnx.Rngs(1))))
    tm = torch.nn.Sequential(bt.models.layers.HBlock(32, 32),
                             bt.models.layers.HBlock(32, 32))
    jm = bnn_tpu.prepare_binary_model(jm, bnn_tpu.BConfig(*FLAGSHIP_J))
    tm = bt.prepare_binary_model(tm, bt.BConfig(*FLAGSHIP_T))
    flat = _randomized(_flat(jm), np.random.RandomState(5))
    _write_flat(jm, flat)
    load_jax_state(tm, flat)
    x = np.random.RandomState(2).randn(2, 8, 8, 32).astype(np.float32)
    assert rel(eval_forward(tm, x), eval_forward(jm, x)) < 1e-4
    assert_matches(jm, tm, x, tol=1e-4)
    with pytest.raises(NotImplementedError, match="Stride"):
        bt.models.layers.HBlock(8, 8, stride=2)
    assert bt.models.layers.HBlock.expansion == 1


def test_hblock_bns_are_not_folded():
    """An activation sits between each HBlock BN and its conv, so the BN
    folds leave all three (``bnn_tpu``'s ``optimize_deployed`` skips HBlock
    by type, ``bnn_tpu/inference/optimize.py:193-195``), and the deployed
    block equals the QAT one (BN statistics random, so that a conv sum of
    exactly 0 does not land on the next sign's 0)."""
    from bnn_tpu_torch.inference import deploy, optimize_deployed

    tm = bt.prepare_binary_model(bt.models.layers.HBlock(16, 16),
                                 bt.BConfig(*FLAGSHIP_T)).eval()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for i in (1, 2, 3):
            bn = getattr(tm, f"bn{i}")
            bn.running_mean.copy_(0.3 * torch.randn(bn.num_features, generator=g))
            bn.running_var.copy_(0.5 + torch.rand(bn.num_features, generator=g))
    x = torch.randn(2, 16, 6, 6, generator=g)
    with torch.no_grad():
        want = tm(x)
        td = deploy(copy.deepcopy(tm))
        assert optimize_deployed(td) == 0
        assert all(isinstance(getattr(td, f"bn{i}"), torch.nn.BatchNorm2d)
                   for i in (1, 2, 3))
        torch.testing.assert_close(td(x), want, rtol=1e-5, atol=1e-5)


# --- attention and layer norm ------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("binary", [False, True])
def test_multihead_attention_matches_jax(masked, binary):
    """MHA on (N, L, E) with and without an additive mask: forward, input
    and parameter gradients, 1e-5 float and 1e-4 binarized (all four
    projections binary, no scale binarizer)."""
    jm = jax_model(lambda: bnn_tpu.nn.MultiheadAttention(16, 4, rngs=nnx.Rngs(0)))
    tm = bt.nn.MultiheadAttention(16, 4)
    if binary:
        cfg = (jops.BasicInputBinarizer, jops.Identity, jops.XNORWeightBinarizer)
        jm = bnn_tpu.prepare_binary_model(jm, bnn_tpu.BConfig(*cfg))
        tm = bt.prepare_binary_model(tm, bt.BConfig(
            tops.BasicInputBinarizer, tops.Identity, tops.XNORWeightBinarizer))
        assert all(isinstance(getattr(tm, p), bt.layers.Linear)
                   for p in ("q_proj", "k_proj", "v_proj", "out_proj"))
    load_jax_state(tm, _flat(jm))
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 16).astype(np.float32)
    mask = (np.where(rng.rand(1, 1, 5, 5) < 0.3, -1e9, 0.0).astype(np.float32)
            if masked else None)

    def call(m, v):
        if mask is None:
            return m(v)
        if isinstance(v, torch.Tensor):
            return m(v, mask=torch.from_numpy(mask).to(v.dtype))
        return m(v, mask=jnp.asarray(mask, v.dtype))

    assert_matches(jm, tm, x, tol=1e-4 if binary else 1e-5, layout_4d=False,
                   call=call)


@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_matches_jax(affine):
    """LayerNorm with flax's fast variance: forward and gradients within
    1e-5, on inputs with a large mean (where the fast form differs from the
    two-pass one)."""
    jm = bnn_tpu.nn.LayerNorm(24, elementwise_affine=affine, rngs=nnx.Rngs(0))
    tm = bt.nn.LayerNorm(24, elementwise_affine=affine)
    if affine:
        rng = np.random.RandomState(4)
        flat = {"scale": rng.randn(24).astype(np.float32),
                "bias": rng.randn(24).astype(np.float32)}
        _write_flat(jm, flat)
        load_jax_state(tm, flat)
    x = (np.random.RandomState(5).randn(3, 7, 24) + 20.0).astype(np.float32)
    out_t, out_j, gx_t, gx_j, gt, gj = forward_and_grads(jm, tm, x, train=True,
                                                         layout_4d=False)
    assert rel(out_t, out_j) < 1e-5
    assert rel(gx_t, gx_j) < 1e-5
    assert gj.keys() == gt.keys()
    for k in gj:
        assert rel(gt[k], gj[k]) < 1e-5, k


# --- the fused Predictor's module tree ---------------------------------------------

_KINDS = ("FusedStage", "FusedBlock", "FusedDownBlock", "FusedBottleneck",
          "FusedStem", "SpaceToDepthConv", "DeployedConv", "DeployedLinear")


def _tree(named):
    return sorted((n, type(m).__name__) for n, m in named
                  if type(m).__name__ in _KINDS)


@functools.lru_cache(maxsize=None)
def _recipe_models(recipe):
    """(JAX, port) DaBNN pre-act PReLU ResNet-18 after both recipe steps."""
    path = f"examples/recipes/{recipe}.yaml"
    jchef = bnn_tpu.BinaryChef(path)
    tchef = bt.BinaryChef(path)
    jm = jax_model(lambda: bnn_tpu.models.resnet18(
        num_classes=10, stem_type="dabnn", rngs=nnx.Rngs(0),
        block_type=bnn_tpu.models.layers.PreBasicBlock, activation=bnn_tpu.nn.PReLU))
    tm = bt.models.resnet18(num_classes=10, stem_type="dabnn",
                            block_type=bt.models.PreBasicBlock,
                            activation=torch.nn.PReLU)
    for step in range(len(jchef)):
        jm = jchef.run_step(jm, step, update=step > 0)
        tm = tchef.run_step(tm, step, update=step > 0)
    return jm, tm


@pytest.mark.parametrize("recipe", ["imagenet-baseline", "xnor-net-plus"])
def test_fused_predictor_tree_matches_jax(recipe):
    """The port's Predictor replaces the same modules with the same fused
    kinds as JAX's passes (interpret mode); no kernel runs. The binarized
    DaBNN stem: one space-to-depth conv (conv1.conv1.0; conv2_2 is binary)
    and the same BNs folded (the same ones left) as in JAX."""
    from bnn_tpu.inference import Predictor as JPredictor
    from bnn_tpu.binarize import named_modules as jnamed
    from bnn_tpu_torch.inference import Predictor

    jm, tm = _recipe_models(recipe)
    jp = JPredictor(copy.deepcopy(jm), batch_size=1, use_pallas=False, fuse=True,
                    dtype=None)
    tp = Predictor(copy.deepcopy(tm), batch_size=1, device="cpu", dtype=None)
    want = _tree(jnamed(jp.served_model()))
    got = _tree(tp.served_model().named_modules())
    fused = [(n, k) for n, k in got if k.startswith("Fused")]
    assert fused == [(n, k) for n, k in want if k.startswith("Fused")]
    assert ("layer1", "FusedStage") in fused
    assert ([n for n, k in got if k == "SpaceToDepthConv"]
            == [n for n, k in want if k == "SpaceToDepthConv"] == ["conv1.conv1.0"])
    assert (sorted(n for n, k in got if k == "DeployedConv")
            == sorted(n for n, k in want if k == "DeployedConv"))
    assert (sorted(n for n, m in tp.served_model().named_modules()
                   if isinstance(m, torch.nn.BatchNorm2d))
            == sorted(n for n, m in jnamed(jp.served_model())
                      if isinstance(m, bnn_tpu.nn.BatchNorm2d)))
