"""The port's stride-1 binary convolution (``binary_conv2d_s1``, mode
``pallas-conv`` of ``DeployedConv``) against the JAX package's.

The JAX kernel runs in interpret mode, as tests/test_kernels.py runs it; the
port takes its plain version, as its wrapper does for CPU tensors. The
integer sums are exact on both sides, so they must be equal (unit
epilogues). The f32 epilogue ``acc * scale + add`` is the same two
operations, but XLA may contract them into one rounding, so f32 outputs are
held to 1e-6; a layer or block in bf16 computes in f32 after its first
``pallas-conv`` (the kernel's output is f32), so bf16 blocks are held to
1e-5. Whole models are held to 1e-4, as in tests/test_torch_small_batch.py
(the stem sums in another order than XLA's), in f32 and in bf16.
"""
import copy
import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import bnn_tpu
import bnn_tpu_torch as bt
from bnn_tpu.binarize import named_modules as jnamed_modules
from bnn_tpu.binarize import set_module_by_name as jset_module
from bnn_tpu.inference import optimize as joptimize
from bnn_tpu.inference import stem as jstem
from bnn_tpu.kernels import conv as jconv
from bnn_tpu.ops import binarizers as jops
from bnn_tpu.utils.precision import cast_floats as jcast_floats
from bnn_tpu_torch.binarize import set_module_by_name as tset_module
from bnn_tpu_torch.inference import optimize as toptimize
from bnn_tpu_torch.inference import stem as tstem
from bnn_tpu_torch.kernels import binary_conv2d_s1, binary_conv2d_s1_reference
from bnn_tpu_torch.kernels.conv import (CONV_KC, CONV_SPLITS, CONV_TILES,
                                        MIN_CHUNKS, SMEM_PER_BLOCK, SMEM_PER_SM,
                                        binary_conv2d_s1_planned, conv_plan,
                                        conv_smem_bytes, conv_weight_operand)
from bnn_tpu_torch.ops import binarizers as tops
from bnn_tpu_torch.utils import cast_floats, load_jax_state
from test_torch_deploy import _conv_pair, _nchw, _nhwc
from test_torch_small_batch import _flat, _randomized, _write_flat

jdeploy = importlib.import_module("bnn_tpu.inference.deploy")
tdeploy = importlib.import_module("bnn_tpu_torch.inference.deploy")


def _x_with_zeros(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    x[rng.rand(*shape) < 0.2] = 0.0  # exact zeros: sign(0) = +1 here
    return x


# tests/test_kernels.py's three shapes: (H, C, O, k), batch 2
@pytest.mark.parametrize("h,c,o,k", [(8, 32, 16, 3), (8, 32, 16, 1),
                                     (10, 64, 128, 5)])
def test_binary_conv2d_s1_matches_jax(h, c, o, k):
    rng = np.random.RandomState(h + c + o + k)
    x = _x_with_zeros(rng, (2, h, h, c))
    w = np.where(rng.randn(k, k, c, o) >= 0, 1, -1).astype(np.int8)
    s = np.abs(rng.randn(o)).astype(np.float32)
    b = rng.randn(o).astype(np.float32)
    want = np.asarray(jconv.binary_conv2d_s1(jnp.asarray(x), jnp.asarray(w),
                                             jnp.asarray(s), jnp.asarray(b),
                                             interpret=True))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = binary_conv2d_s1_reference(tx, tw, torch.from_numpy(s),
                                     torch.from_numpy(b)).numpy()
    assert got.shape == (2, h, h, o) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the integer sums, with sign(0) = +1, are equal
    want_acc = np.asarray(jconv.binary_conv2d_s1(jnp.asarray(x), jnp.asarray(w),
                                                 interpret=True))
    np.testing.assert_array_equal(binary_conv2d_s1_reference(tx, tw).numpy(),
                                  want_acc)
    # the wrapper takes the plain version on the CPU, launching nothing
    before = binary_conv2d_s1.launches
    np.testing.assert_array_equal(
        binary_conv2d_s1(tx, tw, torch.from_numpy(s), torch.from_numpy(b)).numpy(),
        got)
    assert binary_conv2d_s1.launches == before


def test_binary_conv2d_s1_bf16_input():
    """bf16 x is signed as it is; the output stays f32."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(_x_with_zeros(rng, (1, 7, 9, 12))).to(torch.bfloat16)
    w = torch.from_numpy(np.where(rng.randn(3, 3, 12, 10) >= 0, 1, -1).astype(np.int8))
    got = binary_conv2d_s1(x, w)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, binary_conv2d_s1_reference(x.float(), w),
                               rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["even", "rect", "channels", "scale"])
def test_binary_conv2d_s1_rejects(bad):
    x, w = torch.zeros(1, 4, 4, 8), torch.ones(3, 3, 8, 4, dtype=torch.int8)
    scale = None
    if bad == "even":
        w = torch.ones(2, 2, 8, 4, dtype=torch.int8)
    elif bad == "rect":
        w = torch.ones(3, 1, 8, 4, dtype=torch.int8)
    elif bad == "channels":
        w = torch.ones(3, 3, 6, 4, dtype=torch.int8)
    else:
        scale = torch.ones(5)
    with pytest.raises(ValueError):
        binary_conv2d_s1(x, w, scale)


# --- the kernel's host plan and weight operand ------------------------------


# path B's four layer shapes at batch 8 (a ResNet-18's stride-1 3x3 convs),
# in both x dtypes: (x shape, itemsize, plan, blocks of the plan's tile)
_PATH_B_PLANS = [
    ((8, 56, 56, 64), 2, (64, "vector", 1), 392),
    ((8, 56, 56, 64), 4, (64, "vector", 1), 392),
    ((8, 28, 28, 128), 2, (64, "vector", 2), 196),
    ((8, 28, 28, 128), 4, (64, "vector", 1), 196),
    ((8, 14, 14, 256), 2, (64, "vector", 4), 100),
    ((8, 14, 14, 256), 4, (64, "vector", 2), 100),
    ((8, 7, 7, 512), 2, (32, "vector", 4), 208),
    ((8, 7, 7, 512), 4, (32, "vector", 2), 208),
]


@pytest.mark.parametrize("shape,itemsize,plan,blocks", _PATH_B_PLANS, ids=str)
def test_conv_plan_at_path_b_shapes(shape, itemsize, plan, blocks):
    """The tile by the half-wave rule of the H100's 132 SMs (66 blocks), the
    K split on where K is long, off at (8,56,56,64), and a grid whose blocks
    the split's shared memory lets the card hold at once."""
    c = o = shape[-1]
    got = conv_plan(*shape, 3, o, itemsize, 0)
    assert got == plan
    tile, _, split = got
    m = shape[0] * shape[1] * shape[2]
    assert -(-m // tile) * -(-o // tile) == blocks
    big = CONV_TILES[0]
    assert (blocks >= 66) if tile == big else (-(-m // big) * -(-o // big) < 66)
    if c == 64:
        assert split == 1
    if c >= 256:
        assert split > 1
    smem = conv_smem_bytes(tile, split, itemsize, 3)
    assert smem <= SMEM_PER_BLOCK
    assert blocks <= SMEM_PER_SM // (smem + 1024) * 132
    assert 3 * -(-c // CONV_KC) >= MIN_CHUNKS * split


def test_conv_plan_takes_the_smallest_tile_on_a_huge_card():
    for shape in [s for s, *_ in _PATH_B_PLANS]:
        assert conv_plan(*shape, 3, shape[-1], 2, 0, sms=10 ** 9)[0] == CONV_TILES[-1]


@pytest.mark.parametrize("c,k,itemsize,x_off,loader", [
    (64, 3, 2, 0, "vector"),
    (64, 3, 4, 0, "vector"),
    (32, 1, 2, 0, "vector"),     # k = 1
    (40, 3, 2, 0, "vector"),     # 80 bytes a pixel
    (132, 3, 4, 0, "vector"),
    (6, 3, 4, 0, "scalar"),      # 24 bytes a pixel
    (6, 3, 2, 0, "scalar"),
    (12, 3, 2, 0, "scalar"),     # 24 bytes
    (10, 1, 4, 0, "scalar"),     # 40 bytes
    (256, 3, 2, 2, "scalar"),    # x off 16 bytes (an odd element offset)
    (256, 3, 4, 4, "scalar"),
    (256, 3, 2, 16, "vector"),
])
def test_conv_plan_vector_loader_only_where_16_byte_copies_fit(c, k, itemsize, x_off,
                                                               loader):
    assert conv_plan(2, 9, 11, c, k, 16, itemsize, (1 << 20) + x_off)[1] == loader


@pytest.mark.parametrize("c,view", [(64, False), (64, True), (6, False), (6, True),
                                    (130, True)])
def test_conv_weight_operand_is_one_k_contiguous_row_per_output(c, view):
    """(O, k*k*Cp): w.permute(3, 0, 1, 2).reshape(O, k*k*C) with each tap's
    channels zero-padded to Cp, a multiple of the kernel's chunk, for a
    contiguous w and for the permuted view DeployedConv passes."""
    k, o = 3, 10
    g = torch.Generator().manual_seed(c)
    w_oihw = torch.where(torch.randn(o, c, k, k, generator=g) >= 0, 1, -1).to(torch.int8)
    w = w_oihw.permute(2, 3, 1, 0)  # (k, k, C, O)
    if not view:
        w = w.contiguous()
    op = conv_weight_operand(w)
    cp = -(-c // CONV_KC) * CONV_KC
    assert op.shape == (o, k * k * cp) and op.dtype == torch.int8
    assert op.is_contiguous() and op.data_ptr() % 16 == 0
    taps = op.reshape(o, k * k, cp)
    assert torch.equal(taps[..., :c], w.permute(3, 0, 1, 2).reshape(o, k * k, c))
    assert not taps[..., c:].any()
    if cp == c:
        assert torch.equal(op, w.permute(3, 0, 1, 2).reshape(o, k * k * c))


def test_pallas_conv_passes_its_weights_as_a_view(monkeypatch):
    """DeployedConv hands the wrapper a (k, k, I, O) view of its stored
    weights; the wrapper's operand is then the one copy of a forward."""
    _, tl = _conv_pair(8, 16, 3, 1, 1, False, seed=73)
    td = tdeploy.DeployedConv(tl, mode="pallas-conv", weight_format="int8")
    seen = []
    real = tdeploy.binary_conv2d_s1

    def spy(x, w, *args):
        seen.append(w)
        return real(x, w, *args)

    monkeypatch.setattr(tdeploy, "binary_conv2d_s1", spy)
    td(torch.randn(1, 8, 5, 5))
    (w,) = seen
    assert w.shape == (3, 3, 8, 16) and not w.is_contiguous()
    assert w.untyped_storage().data_ptr() == td.w_packed.untyped_storage().data_ptr()


@pytest.mark.parametrize("plan,match", [
    ((64, "vector", 1), "CUDA"),      # a valid plan, but CPU tensors
    (None, "CUDA"),
    ((48, "vector", 1), "no launch plan"),
    ((64, "vector", 3), "no launch plan"),
    ((64, "tma", 1), "no launch plan"),
    ((64, "vector", 4), "no launch plan"),  # four f32 64x64 rings: 259 KB
])
def test_binary_conv2d_s1_planned_launches_only_on_the_card(plan, match):
    x, w = torch.zeros(1, 4, 4, 64), torch.ones(3, 3, 64, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match=match):
        binary_conv2d_s1_planned(x, w, plan=plan)


@pytest.mark.parametrize("bad", ["vector_c6", "offset", "shape"])
def test_binary_conv2d_s1_planned_refuses_what_does_not_fit(bad):
    x, w = torch.zeros(1, 4, 4, 6), torch.ones(3, 3, 6, 8, dtype=torch.int8)
    plan = (32, "vector", 1)
    if bad == "offset":
        x = torch.zeros(1 + 4 * 4 * 64)[1:].view(1, 4, 4, 64)
        w = torch.ones(3, 3, 64, 8, dtype=torch.int8)
    elif bad == "shape":
        w, plan = torch.ones(3, 3, 5, 8, dtype=torch.int8), (32, "scalar", 1)
    with pytest.raises(ValueError, match="no launch plan|odd square"):
        binary_conv2d_s1_planned(x, w, plan=plan)


def test_conv_splits_fit_the_card():
    """Every instance the plan may pick fits one block's shared memory, but
    the four-group f32 64x64 one, which the plan never picks."""
    too_big = {(t, s, i) for t in CONV_TILES for s in CONV_SPLITS for i in (2, 4)
               if conv_smem_bytes(t, s, i, 3) > SMEM_PER_BLOCK}
    assert too_big == {(64, 4, 4)}


def test_pallas_conv_sign_of_zero_is_plus_one():
    """The decision for pallas-conv's sign(0): the port reproduces the JAX
    kernel, ``x >= 0`` gives +1 whatever the layer's convention. On a
    ternary (torch-parity) layer, port and JAX agree, and both differ from
    the conv mode exactly where a patch holds an exact zero: the conv mode
    on x with its zeros made positive equals pallas-conv everywhere."""
    jl, tl = _conv_pair(8, 16, 3, 1, 1, False, seed=71)
    rng = np.random.RandomState(72)
    x = np.maximum(rng.randn(2, 6, 6, 8), 0.0).astype(np.float32)  # ReLU-like
    jd = jdeploy.DeployedConv(jl, mode="pallas-conv", interpret=True)
    td = tdeploy.DeployedConv(tl, mode="pallas-conv")
    got = _nhwc(td(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(jd(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-6)
    conv = tdeploy.DeployedConv(tl, mode="conv")
    plain = _nhwc(conv(_nchw(x)))
    lifted = _nhwc(conv(_nchw(np.where(x == 0, 1e-3, x).astype(np.float32))))
    np.testing.assert_array_equal(got, lifted)
    # an output differs from the conv mode iff its 3x3 patch holds a zero
    has_zero = torch.nn.functional.max_pool2d(
        torch.from_numpy((x == 0).astype(np.float32)).permute(0, 3, 1, 2)
        .amax(1, keepdim=True), 3, 1, 1)[:, 0].numpy() > 0
    differs = (got != plain).any(-1)
    assert differs.any()
    assert not (differs & ~has_zero).any()


@pytest.mark.parametrize("kw,error", [
    (dict(stride=2), ValueError),
    (dict(padding=0), ValueError),
    (dict(k=4, padding=2), ValueError),
    (dict(dilation=2, padding=2), ValueError),
])
def test_pallas_conv_geometry_is_checked_at_construction(kw, error):
    """Checked when the layer is built, not when it is first called."""
    k, stride = kw.get("k", 3), kw.get("stride", 1)
    padding, dilation = kw.get("padding", 1), kw.get("dilation", 1)
    tb = bt.BConfig(tops.BasicInputBinarizer, tops.BasicScaleBinarizer,
                    tops.XNORWeightBinarizer)
    tl = bt.layers.Conv2d(8, 16, k, stride, padding, dilation=dilation, bconfig=tb)
    with pytest.raises(error, match="stride-1"):
        tdeploy.DeployedConv(tl, mode="pallas-conv")


def test_pallas_conv_grouped_takes_conv_mode_only():
    tb = bt.BConfig(tops.BasicInputBinarizer, tops.BasicScaleBinarizer,
                    tops.XNORWeightBinarizer)
    tl = bt.layers.Conv2d(8, 16, 3, 1, 1, groups=2, bconfig=tb)
    with pytest.raises(NotImplementedError, match="grouped"):
        tdeploy.DeployedConv(tl, mode="pallas-conv")


# --- blocks and whole models ------------------------------------------------


def _z1_bconfigs():
    jb = bnn_tpu.BConfig(jops.BasicInputBinarizer.with_args(zero_to_one=True),
                         jops.BasicScaleBinarizer, jops.XNORWeightBinarizer)
    tb = bt.BConfig(tops.BasicInputBinarizer.with_args(zero_to_one=True),
                    tops.BasicScaleBinarizer, tops.XNORWeightBinarizer)
    return jb, tb


@functools.lru_cache(maxsize=None)
def z1_prelu_models(depth, pre=False):
    """(JAX QAT model, port QAT model) of the Z1-PReLU binary ResNet of
    ``depth`` (zero_to_one signs, PReLU activations, 10 classes), with the
    same random weights, BN statistics, alphas and slopes."""
    jb, tb = _z1_bconfigs()
    jkw = dict(activation=bnn_tpu.nn.PReLU)
    tkw = dict(activation=torch.nn.PReLU)
    if pre:
        jkw["block_type"] = bnn_tpu.models.layers.PreBasicBlock
        tkw["block_type"] = bt.models.layers.PreBasicBlock
    jm = getattr(bnn_tpu.models, f"resnet{depth}")(num_classes=10,
                                                   rngs=nnx.Rngs(depth), **jkw)
    jm = bnn_tpu.prepare_binary_model(jm, jb, ignore_layers_name=["_first_", "_last_"])
    flat = _randomized(_flat(jm), np.random.RandomState(500 + depth + pre))
    _write_flat(jm, flat)
    tm = getattr(bt.models, f"resnet{depth}")(num_classes=10, **tkw)
    tm = bt.prepare_binary_model(tm, tb, ignore_layers_name=["_first_", "_last_"])
    load_jax_state(tm, flat)
    jm.eval()
    return jm, tm.eval()


def _is_s1_3x3(m, layers):
    return (isinstance(m, layers.Conv2d) and tuple(m.kernel_size) == (3, 3)
            and tuple(m.stride) == (1, 1))


def pallas_conv_model_pair(depth=18, fmt="int8", dtype=None, pre=False):
    """Both packages' path-B models: deployed (int8 weights), every stride-1
    3x3 binary conv replaced by a pallas-conv DeployedConv, BN folds,
    space-to-depth stem, floats cast to ``dtype``; no stage or block pass."""
    jq, tq = z1_prelu_models(depth, pre)
    jm = jdeploy.deploy(copy.deepcopy(jq), weight_format=fmt, use_pallas=False)
    tm = tdeploy.deploy(copy.deepcopy(tq), weight_format=fmt)
    for name, m in tq.named_modules():
        if _is_s1_3x3(m, bt.layers):
            tset_module(tm, name, tdeploy.DeployedConv(m, mode="pallas-conv",
                                                       weight_format=fmt))
    names = []
    for name, m in jnamed_modules(jq):
        if _is_s1_3x3(m, bnn_tpu.layers):
            names.append(name)
            jset_module(jm, name, jdeploy.DeployedConv(
                m, mode="pallas-conv", weight_format=fmt, interpret=True))
    joptimize.optimize_deployed(jm)
    toptimize.optimize_deployed(tm)
    jstem.space_to_depth_stem(jm)
    tstem.space_to_depth_stem(tm)
    if dtype is not None:
        jcast_floats(jm, dtype[0])
        cast_floats(tm, dtype[1])
    return jm, tm.eval(), names


def test_pallas_conv_model_has_13_kernel_layers():
    _, tm, names = pallas_conv_model_pair()
    got = [n for n, m in tm.named_modules()
           if isinstance(m, tdeploy.DeployedConv) and m.mode == "pallas-conv"]
    assert got == names and len(got) == 13
    assert [n for n, m in tm.named_modules()
            if isinstance(m, tdeploy.DeployedConv) and m.mode == "gemm"] == \
        ["layer4.0.downsample.1"]


_BLOCKS = [
    # (pre-activation, weight format, bf16): the pre-activation blocks fold
    # their BNs into sign thresholds and weight flips
    (False, "int8", False),
    (True, "int8", False),
    (True, "packed", False),
    (False, "packed", True),
    (True, "int8", True),
]


@pytest.mark.parametrize("case", _BLOCKS, ids=str)
def test_pallas_conv_block_matches_jax(case):
    pre, fmt, bf16 = case
    dtype = (jnp.bfloat16, torch.bfloat16) if bf16 else None
    jm, tm, _ = pallas_conv_model_pair(fmt=fmt, dtype=dtype, pre=pre)
    jblk, tblk = jm.layer1[0], tm.layer1[0]
    assert tblk.conv1.mode == "pallas-conv"
    assert (tblk.conv1.threshold is not None) == pre
    if pre:
        np.testing.assert_allclose(tblk.conv1.threshold.float().numpy(),
                                   np.asarray(jblk.conv1.threshold[...], np.float32),
                                   rtol=1e-6, atol=1e-6)
    x = np.random.RandomState(9).randn(2, 8, 8, 64).astype(np.float32)
    jx, tx = jnp.asarray(x), _nchw(x)
    if bf16:
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    want = np.asarray(jblk(jx))
    with torch.no_grad():
        got = tblk(tx)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-5)


def _images(n=4, size=32):
    return np.random.RandomState(1).randn(n, size, size, 3).astype(np.float32)


@pytest.mark.parametrize("bf16", [False, True])
def test_pallas_conv_model_matches_jax(bf16):
    dtype = (jnp.bfloat16, torch.bfloat16) if bf16 else None
    jm, tm, _ = pallas_conv_model_pair(dtype=dtype)
    x = _images()
    jx, tx = jnp.asarray(x), _nchw(x)
    if bf16:
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    want = np.asarray(jm(jx))
    with torch.no_grad():
        got = tm(tx)
    # JAX promotes the f32 kernel outputs through the bf16 layers after
    # them; the port's promote_call does the same
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.numpy().argmax(1), want.argmax(1))


def test_pallas_conv_model_equals_conv_mode_in_f32():
    """With zero_to_one signs, pallas-conv computes the conv mode's
    function: in f32 both give the same logits."""
    _, tm, _ = pallas_conv_model_pair()
    _, tq = z1_prelu_models(18)
    ref = tdeploy.deploy(copy.deepcopy(tq), weight_format="int8")
    toptimize.optimize_deployed(ref)
    tstem.space_to_depth_stem(ref)
    x = _nchw(_images())
    with torch.no_grad():
        torch.testing.assert_close(tm(x), ref.eval()(x), rtol=1e-5, atol=1e-5)


def test_promote_call_widens_like_jnp():
    """An f32 activation reaching a bf16 layer computes in f32 (the JAX
    package's promotion); one type calls the layer as it is."""
    from bnn_tpu_torch.utils.precision import promote_call

    x = torch.randn(2, 8, 3, 3, generator=torch.Generator().manual_seed(0))
    act = torch.nn.PReLU(8)
    with torch.no_grad():
        act.weight.uniform_(0.05, 0.5)
    wide = copy.deepcopy(act).to(torch.bfloat16).float()  # the rounded slopes
    act.to(torch.bfloat16)
    with torch.no_grad():
        got = promote_call(act, x)
        assert got.dtype == torch.float32
        assert torch.equal(got, wide(x))
        assert promote_call(act, x.to(torch.bfloat16)).dtype == torch.bfloat16
        fc = torch.nn.Linear(8, 4).to(torch.bfloat16)
        assert promote_call(fc, x[:, :, 0, 0]).dtype == torch.float32
        # in training mode the module runs as it is and keeps its statistics
        bn = torch.nn.BatchNorm2d(8).train()
        promote_call(bn, x.to(torch.bfloat16))
        assert bn.num_batches_tracked.item() == 1
        assert bn.running_mean.abs().sum() > 0
