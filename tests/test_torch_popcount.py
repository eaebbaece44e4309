"""The port's popcount serving (``popcount_gemm``, ``set_gemm_impl``,
``Predictor(binary_gemm_impl='popcount')``) against the JAX package's.

The JAX kernel runs in interpret mode, as tests/test_kernels.py runs it; the
port takes its plain version, as its wrapper does for CPU tensors. Mismatch
counts are exact integers on both sides; the f32 epilogue is the same two
operations, but XLA may contract them into one rounding, so outputs are held
to 1e-6 (equal with unit epilogues). The packed words are held equal bit
for bit. Whole models are held to 1e-4, as in
tests/test_torch_small_batch.py (the stem sums in another order than XLA's).
"""
import copy
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_tpu.inference import Predictor as JPredictor
from bnn_tpu.inference import optimize as joptimize
from bnn_tpu.kernels import gemm as jgemm
from bnn_tpu.kernels import pack_bits as jpack_bits
from bnn_tpu_torch.inference import Predictor
from bnn_tpu_torch.inference import optimize as toptimize
from bnn_tpu_torch.kernels import (pack_bits, popcount_gemm,
                                   popcount_gemm_reference)
from bnn_tpu_torch.kernels.gemm import (POPCOUNT_KWC, POPCOUNT_MIN_CHUNKS,
                                        POPCOUNT_SPLITS, POPCOUNT_TILES,
                                        popcount_gemm_planned, popcount_plan)
from test_torch_deploy import _bn_pair, _conv_pair, _flat, _nchw, _nhwc
from test_torch_pallas_conv import z1_prelu_models
from test_torch_small_batch import _models

jdeploy = importlib.import_module("bnn_tpu.inference.deploy")
tdeploy = importlib.import_module("bnn_tpu_torch.inference.deploy")


# tests/test_kernels.py's shapes (M, K, N)
@pytest.mark.parametrize("m,k,n", [(8, 64, 16), (17, 100, 33),
                                   (64, 512, 128), (5, 33, 7)])
def test_popcount_gemm_matches_jax(m, k, n):
    rng = np.random.RandomState(m + k + n)
    x = rng.randn(m, k).astype(np.float32)
    x[rng.rand(m, k) < 0.1] = 0.0  # exact zeros pack as +1
    w = np.where(rng.randn(k, n) >= 0, 1.0, -1.0).astype(np.float32)
    scale = np.linspace(0.5, 2.0, n).astype(np.float32)
    add = np.linspace(-1.0, 1.0, n).astype(np.float32)
    jwp, jxp = jpack_bits(jnp.asarray(w), axis=-2), jpack_bits(jnp.asarray(x), axis=-1)
    twp, txp = pack_bits(torch.from_numpy(w), axis=-2), pack_bits(torch.from_numpy(x), axis=-1)
    np.testing.assert_array_equal(txp.numpy().view(np.uint32), np.asarray(jxp))
    ts, ta = torch.from_numpy(scale), torch.from_numpy(add)
    kernel = np.asarray(jgemm.popcount_gemm(jxp, jwp, k, jnp.asarray(scale),
                                            jnp.asarray(add), interpret=True))
    reference = np.asarray(jgemm.popcount_gemm_reference(
        jnp.asarray(x), jwp, k, jnp.asarray(scale), jnp.asarray(add)))
    before = popcount_gemm.launches
    got = popcount_gemm(txp, twp, k, ts, ta).numpy()
    assert popcount_gemm.launches == before  # the plain version on the CPU
    assert got.shape == (m, n) and got.dtype == np.float32
    for want in (kernel, reference):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        popcount_gemm_reference(txp, twp, k, ts, ta).numpy(), got)
    # the dot itself: K - 2 * mismatches, exact
    np.testing.assert_array_equal(
        popcount_gemm(txp, twp, k).numpy(),
        np.asarray(jgemm.popcount_gemm(jxp, jwp, k, interpret=True)))


@pytest.mark.parametrize("bad", ["words", "width", "scale"])
def test_popcount_gemm_rejects(bad):
    xp, wp, k, scale = torch.zeros(4, 2, dtype=torch.int32), \
        torch.zeros(2, 8, dtype=torch.int32), 64, None
    if bad == "words":
        k = 100
    elif bad == "width":
        xp = torch.zeros(4, 3, dtype=torch.int32)
    else:
        scale = torch.ones(7)
    with pytest.raises(ValueError):
        popcount_gemm(xp, wp, k, scale)


# (M, K, N) of path C's calls (a ResNet-50's 36 pointwise convs at 224x224)
# at batch 8 and 1, with the plan (tile, loader, split) and the grid's blocks
_PATH_C_PLANS = [
    ((392, 512, 2048), (64, "vector", 1), 224),
    ((392, 1024, 2048), (64, "vector", 1), 224),
    ((392, 2048, 512), (32, "vector", 2), 208),
    ((1568, 256, 1024), (64, "vector", 1), 400),
    ((1568, 512, 1024), (64, "vector", 1), 400),
    ((1568, 1024, 256), (64, "vector", 1), 100),
    ((1568, 1024, 512), (64, "vector", 1), 200),
    ((6272, 128, 512), (64, "vector", 1), 784),
    ((6272, 256, 512), (64, "vector", 1), 784),
    ((6272, 512, 128), (64, "vector", 1), 196),
    ((6272, 512, 256), (64, "vector", 1), 392),
    ((25088, 64, 64), (64, "vector", 1), 392),
    ((25088, 64, 256), (64, "vector", 1), 1568),
    ((25088, 256, 64), (64, "vector", 1), 392),
    ((25088, 256, 128), (64, "vector", 1), 784),
    ((49, 512, 2048), (32, "vector", 1), 128),
    ((49, 1024, 2048), (32, "vector", 2), 128),
    ((49, 2048, 512), (32, "vector", 4), 32),
    ((196, 256, 1024), (32, "vector", 1), 224),
    ((196, 512, 1024), (32, "vector", 1), 224),
    ((196, 1024, 256), (32, "vector", 2), 56),
    ((196, 1024, 512), (32, "vector", 2), 112),
    ((784, 128, 512), (64, "vector", 1), 104),
    ((784, 256, 512), (64, "vector", 1), 104),
    ((784, 512, 128), (32, "vector", 1), 100),
    ((784, 512, 256), (32, "vector", 1), 200),
    ((3136, 64, 64), (32, "vector", 1), 196),
    ((3136, 64, 256), (64, "vector", 1), 196),
    ((3136, 256, 64), (32, "vector", 1), 196),
    ((3136, 256, 128), (64, "vector", 1), 98),
]


@pytest.mark.parametrize("mkn,plan,blocks", _PATH_C_PLANS, ids=str)
def test_popcount_plan_at_path_c_shapes(mkn, plan, blocks):
    """The tile by the half-wave rule of the H100's 132 SMs (66 blocks); the
    K split only on 32x32 tiles, each warp group left at least two chunks of
    8 words, at most four groups per SM."""
    m, k, n = mkn
    kw = -(-k // 32)
    got = popcount_plan(m, kw, n, 0, 0)
    assert got == plan
    tile, _, split = got
    assert -(-m // tile) * -(-n // tile) == blocks
    big = POPCOUNT_TILES[0]
    assert (blocks >= 66) if tile == big else (-(-m // big) * -(-n // big) < 66)
    assert split in POPCOUNT_SPLITS
    if split > 1:
        assert tile == POPCOUNT_TILES[-1]
        assert -(-kw // POPCOUNT_KWC) >= POPCOUNT_MIN_CHUNKS * split
        assert blocks * split <= 4 * 132
    # one more group would break a rule (or there is none)
    more = [s for s in POPCOUNT_SPLITS if s > split]
    assert not more or tile == big or \
        -(-kw // POPCOUNT_KWC) < POPCOUNT_MIN_CHUNKS * min(more) or \
        blocks * min(more) > 4 * 132


def test_popcount_plan_takes_the_smallest_tile_on_a_huge_card():
    for (m, k, n), _, _ in _PATH_C_PLANS:
        kw = -(-k // 32)
        tile, _, split = popcount_plan(m, kw, n, 0, 0, sms=10 ** 9)
        assert tile == POPCOUNT_TILES[-1]
        chunks = -(-kw // POPCOUNT_KWC)
        assert split == max(s for s in POPCOUNT_SPLITS
                            if s == 1 or chunks >= POPCOUNT_MIN_CHUNKS * s)


@pytest.mark.parametrize("kw,n,x_off,w_off,loader", [
    (16, 512, 0, 0, "vector"),
    (2, 64, 0, 0, "vector"),      # K = 64: word pairs
    (1, 64, 0, 0, "scalar"),      # K <= 32: one word a row
    (3, 64, 0, 0, "scalar"),      # KW odd
    (16, 70, 0, 0, "scalar"),     # N % 4 != 0
    (16, 7, 0, 0, "scalar"),
    (16, 512, 4, 0, "scalar"),    # x = buf[1:]: off 8 bytes
    (16, 512, 8, 0, "vector"),    # x = buf[2:]: off 16, on 8 bytes
    (16, 512, 0, 8, "scalar"),    # weight words off 16 bytes
    (16, 512, 0, 16, "vector"),
])
def test_popcount_plan_vector_loader_only_where_whole_copies_fit(kw, n, x_off, w_off,
                                                                 loader):
    base = 1 << 20
    assert popcount_plan(392, kw, n, base + x_off, base + w_off)[1] == loader


@pytest.mark.parametrize("plan,match", [
    ((64, "vector", 1), "CUDA"),      # a valid plan, but CPU tensors
    ((32, "scalar", 4), "CUDA"),
    (None, "CUDA"),
    ((48, "vector", 1), "no launch plan"),
    ((64, "vector", 3), "no launch plan"),
    ((64, "tma", 1), "no launch plan"),
])
def test_popcount_gemm_planned_launches_only_on_the_card(plan, match):
    xp = torch.zeros(9, 4, dtype=torch.int32)
    wp = torch.zeros(4, 16, dtype=torch.int32)
    before = popcount_gemm.launches
    with pytest.raises(ValueError, match=match):
        popcount_gemm_planned(xp, wp, 100, plan=plan)
    assert popcount_gemm.launches == before


@pytest.mark.parametrize("bad", ["kw_odd", "n_off_4", "x_offset", "shape"])
def test_popcount_gemm_planned_refuses_what_does_not_fit(bad):
    xp, wp, k = torch.zeros(9, 4, dtype=torch.int32), \
        torch.zeros(4, 16, dtype=torch.int32), 100
    if bad == "kw_odd":
        xp, wp, k = torch.zeros(9, 3, dtype=torch.int32), \
            torch.zeros(3, 16, dtype=torch.int32), 70
    elif bad == "n_off_4":
        wp = torch.zeros(4, 18, dtype=torch.int32)
    elif bad == "x_offset":
        xp = torch.zeros(1 + 9 * 4, dtype=torch.int32)[1:].view(9, 4)
    else:
        k = 200  # 7 words, not 4
    with pytest.raises(ValueError, match="no launch plan|shape mismatch"):
        popcount_gemm_planned(xp, wp, k, plan=(32, "vector", 1))


def _bit_count(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit value held in an int64 tensor, bit by bit."""
    return ((v.unsqueeze(-1) >> torch.arange(32)) & 1).sum(-1)


@pytest.mark.parametrize("k", [1, 31, 32, 33, 64, 100, 257, 2048])
def test_and_popc_mismatches_equal_jax_reference(k):
    """The kernel's arithmetic in plain torch: the words zero-padded to whole
    256-bit mma steps, the mismatches as popc(x & ~w) + popc(~x & w) (two
    AND-popcount products, the complements of all 32 bits of a word, pad
    bits included). They equal JAX's XOR mismatch counts exactly: the pad
    bits past K and the pad words add nothing."""
    m, n = 13, 9
    rng = np.random.RandomState(k)
    x = rng.randn(m, k).astype(np.float32)
    x[rng.rand(m, k) < 0.1] = 0.0  # exact zeros pack as +1
    w = np.where(rng.randn(k, n) >= 0, 1.0, -1.0).astype(np.float32)
    jwp = jpack_bits(jnp.asarray(w), axis=-2)
    out = np.asarray(jgemm.popcount_gemm_reference(jnp.asarray(x), jwp, k))
    want = (k - out.astype(np.int64)) // 2

    mask = 0xFFFFFFFF
    xp = pack_bits(torch.from_numpy(x), axis=-1).to(torch.int64) & mask
    wp = pack_bits(torch.from_numpy(w), axis=-2).to(torch.int64) & mask
    kw = xp.shape[1]
    pad = -(-kw // POPCOUNT_KWC) * POPCOUNT_KWC - kw
    xp = torch.cat([xp, xp.new_zeros(m, pad)], dim=1)
    wp = torch.cat([wp, wp.new_zeros(pad, n)], dim=0)
    nx, nw = ~xp & mask, ~wp & mask
    got = torch.zeros(m, n, dtype=torch.int64)
    for q in range(xp.shape[1]):
        got += _bit_count(xp[:, q, None] & nw[None, q, :])
        got += _bit_count(nx[:, q, None] & wp[None, q, :])
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got <= k).all()


@pytest.mark.parametrize("fmt", ["int8", "packed"])
def test_set_gemm_impl_matches_jax_on_resnet50(fmt):
    """The 36 pointwise convs of the Z1-PReLU ResNet-50 switch (16 conv1, 16
    conv3, 4 shortcuts), in JAX's order, and the conv-layout weights become
    the GEMM words JAX makes, bit for bit."""
    jq, tq = z1_prelu_models(50)
    jm = jdeploy.deploy(copy.deepcopy(jq), weight_format=fmt, use_pallas=False)
    tm = tdeploy.deploy(copy.deepcopy(tq), weight_format=fmt)
    joptimize.optimize_deployed(jm)
    toptimize.optimize_deployed(tm)
    jnames = jdeploy.set_gemm_impl(jm, "popcount")
    tnames = tdeploy.set_gemm_impl(tm, "popcount")
    assert tnames == jnames and len(tnames) == 36
    assert sum(n.endswith("downsample.1") for n in tnames) == 4
    mods = dict(tm.named_modules())
    jmods = dict(jdeploy.named_modules(jm))
    for name in tnames:
        t, j = mods[name], jmods[name]
        assert t.mode == j.mode == "gemm" and t.gemm_impl == "popcount"
        np.testing.assert_array_equal(t.w_packed.numpy().view(np.uint32),
                                      np.asarray(j.w_packed[...]))
    # the 3x3 convs stay on the int8 conv mode
    assert all(m.gemm_impl == "mxu" and m.mode == "conv"
               for n, m in mods.items()
               if isinstance(m, tdeploy.DeployedConv) and n.endswith("conv2"))
    assert tdeploy.set_gemm_impl(tm, "mxu") == tnames


def test_set_gemm_impl_leaves_ternary_and_padded_layers():
    _, tm, _ = _models("flagship")  # torch-parity ternary signs
    model = tdeploy.deploy(copy.deepcopy(tm))
    assert tdeploy.set_gemm_impl(model, "popcount") == []
    _, padded = _conv_pair(8, 16, 1, 1, 1, True, seed=81)   # 1x1, padding 1
    _, spatial = _conv_pair(8, 16, 3, 1, 1, True, seed=82)  # 3x3
    seq = tdeploy.deploy(torch.nn.Sequential(padded, spatial))
    assert tdeploy.set_gemm_impl(seq, "popcount") == []
    assert [m.mode for m in seq] == ["conv", "conv"]


def test_set_gemm_impl_unknown_raises_and_keeps_mxu():
    _, tl = _conv_pair(64, 16, 1, 1, 0, True, seed=83)
    model = tdeploy.deploy(torch.nn.Sequential(tl))
    with pytest.raises(ValueError, match="unknown gemm impl"):
        tdeploy.set_gemm_impl(model, "xnor")
    assert model[0].gemm_impl == "mxu" and model[0].mode == "conv"


@pytest.mark.parametrize("fmt,mode", [("int8", "conv"), ("packed", "conv"),
                                      ("packed", "gemm")])
def test_popcount_pointwise_conv_matches_mxu_and_jax(fmt, mode):
    """A pointwise conv behind a folded BN (a sign threshold and weight
    flips) gives the same result in popcount as in mxu, and as JAX's."""
    cin = 256 if mode == "gemm" else 40
    jl, tl = _conv_pair(cin, 24, 1, 1, 0, True, seed=84)
    jbn, tbn = _bn_pair(cin, seed=85)
    jd = jdeploy.DeployedConv(jl, use_pallas=mode != "conv", interpret=True,
                              mode=mode, weight_format=fmt)
    td = tdeploy.DeployedConv(tl, mode=mode, weight_format=fmt)
    assert joptimize.fold_bn_before(jbn, jd) and toptimize.fold_bn_before(tbn, td)
    x = np.random.RandomState(86).randn(2, 5, 5, cin).astype(np.float32)
    mxu = _nhwc(td(_nchw(x)))
    assert jdeploy.set_gemm_impl(jd, "popcount") == [""]
    assert tdeploy.set_gemm_impl(td, "popcount") == [""]
    got = _nhwc(td(_nchw(x)))
    np.testing.assert_array_equal(got, mxu)
    np.testing.assert_allclose(got, np.asarray(jd(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-6)


def test_popcount_linear_matches_mxu_and_jax():
    from bnn_tpu import layers as jlayers
    from bnn_tpu_torch import layers as tlayers
    from bnn_tpu_torch.utils import load_jax_state
    from flax import nnx
    from test_torch_deploy import _bconfigs

    jb, tb = _bconfigs(True)
    jl = jlayers.Linear(70, 24, bconfig=jb, rngs=nnx.Rngs(3))
    tl = tlayers.Linear(70, 24, bconfig=tb)
    load_jax_state(tl, _flat(jl))
    jd = jdeploy.DeployedLinear(jl, use_pallas=True, interpret=True)
    td = tdeploy.DeployedLinear(tl)
    x = np.random.RandomState(87).randn(5, 70).astype(np.float32)
    mxu = td(torch.from_numpy(x)).detach().numpy()
    assert jdeploy.set_gemm_impl(jd, "popcount") == [""]
    assert tdeploy.set_gemm_impl(td, "popcount") == [""]
    got = td(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_array_equal(got, mxu)
    np.testing.assert_allclose(got, np.asarray(jd(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-6)


def test_popcount_predictor_resnet50_matches_jax():
    jq, tq = z1_prelu_models(50)
    x = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)
    jpred = JPredictor(copy.deepcopy(jq), use_pallas=False, dtype=None,
                       batch_size=2, binary_gemm_impl="popcount")
    tpred = Predictor(copy.deepcopy(tq), batch_size=2, device="cpu", dtype=None,
                      binary_gemm_impl="popcount")
    assert tpred.popcount_layers == jpred.popcount_layers
    assert len(tpred.popcount_layers) == 36
    # popcount serves unfused: no stem, stage or block kernel module
    assert type(tpred.model.layer1[0]).__name__ == "Bottleneck"
    want = np.asarray(jpred(jnp.asarray(x)))
    got = tpred(_nchw(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    mxu = Predictor(copy.deepcopy(tq), batch_size=2, device="cpu", dtype=None,
                    fuse=False)(_nchw(x)).numpy()
    np.testing.assert_allclose(got, mxu, rtol=1e-5, atol=1e-5)
