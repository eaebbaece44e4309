"""What ``fused_downsample_block`` and ``fused_bottleneck`` need from the host
now that every block kernel reads kept K-major weight copies, against the
JAX kernels.

``csrc/fused_downsample_block.cu`` runs its convs on ``bnn_common.cuh``'s
MmaTile, as ``fused_basic_block`` does: it reads the K-major copies that a
block descriptor (``kernels.strided_block.downsample_block_desc``) makes once
per device, conv1 as its 9*C_in taps, and loads A rows as 16-byte copies
when C % 16 == 0 and word by word otherwise. A descriptor is good only for
the tensors it was made from: its ``key`` (``kernels._blocks.tensor_key``)
records each tensor's pointer, version, shape, strides, dtype and device,
a wrapper refuses a descriptor whose key differs, and the modules that keep
one (``FusedDownBlock``, ``FusedBottleneck``) build a new one. The kernels
run only on the card, where chip_smoke.py holds them against their plain
versions; here the plain versions are held against the JAX Pallas kernel in
interpret mode, and the kept descriptors against the live weights.

Tolerances: weights and keys are exact. The downsample cases use unit
epilogues and identity activations, so both sides compute the same integer
sums plus one f32 add: exact in f32. The modules are held to their plain
versions on the same tensors, exactly.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bnn_tpu_torch as bt
from bnn_tpu.kernels import strided_block as jstrided
from bnn_tpu_torch.inference import FusedBottleneck, FusedDownBlock, Predictor
from bnn_tpu_torch.inference.megablock import _act_kind, _nhwc, _z21
from bnn_tpu_torch.kernels import (_blocks, fused_bottleneck_reference,
                                   fused_downsample_block,
                                   fused_downsample_block_reference)
from bnn_tpu_torch.kernels.stem import stem_key
from bnn_tpu_torch.kernels import bottleneck as tbn
from bnn_tpu_torch.kernels import strided_block as tstrided
from bnn_tpu_torch.kernels.strided_block import (_transform_w1,
                                                 downsample_block_desc)
from bnn_tpu_torch.ops import binarizers as tops


def _pm1(rng, *shape):
    return np.where(rng.randn(*shape) >= 0, 1, -1).astype(np.int8)


def _x(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    x[rng.rand(*shape) < 0.1] = 0.0  # exact zeros, where sign(0) conventions differ
    return x


@pytest.mark.parametrize("z21", [True, False], ids=["zero_to_one", "torch_sign"])
@pytest.mark.parametrize("ci", [20, 32], ids=["C20-word-loader", "C32-16-byte-loader"])
def test_fused_downsample_block_with_kept_desc_matches_jax_kernel(ci, z21):
    """C_in -> 2 C_in at a width the kernel loads word by word (C % 16 != 0)
    and at one it loads in 16-byte rows: the port's fused_downsample_block
    with a kept descriptor, on CPU tensors (its plain version, launching
    nothing), equals the JAX kernel in interpret mode, exactly; the
    descriptor's K-major copies are the transposed taps."""
    co = 2 * ci
    rng = np.random.RandomState(80 + ci)
    x = _x(rng, (2, 8, 10, ci))
    w1, w2, wd = _pm1(rng, 3, 3, ci, co), _pm1(rng, 3, 3, co, co), _pm1(rng, ci, co)
    ones, zeros = np.ones(co, np.float32), np.zeros(co, np.float32)
    rows = (ones, zeros, ones, zeros, ones, zeros)
    want = np.asarray(jstrided.fused_downsample_block(
        jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(wd), *rows,
        act="identity", zero_to_one=z21, interpret=True))
    targs = [torch.from_numpy(a) for a in (x, w1, w2, wd) + rows]
    desc = downsample_block_desc(*targs[1:])
    w1t, w2t, wdt = desc.kmajor(torch.device("cpu"))
    np.testing.assert_array_equal(w1t.numpy(), w1.reshape(9 * ci, co).T)
    np.testing.assert_array_equal(w2t.numpy(), w2.reshape(9 * co, co).T)
    np.testing.assert_array_equal(wdt.numpy(), wd.T)
    before = fused_downsample_block.launches
    got = fused_downsample_block(*targs, act="identity", zero_to_one=z21, desc=desc)
    assert fused_downsample_block.launches == before  # no kernel on the CPU
    assert got.shape == (2, 4, 5, co)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        fused_downsample_block_reference(*targs, act="identity",
                                         zero_to_one=z21).numpy(), want)


def _call_args(rng, ci=8, co=16):
    x = torch.from_numpy(_x(rng, (1, 4, 4, ci)))
    ws = [torch.from_numpy(_pm1(rng, *s)) for s in ((3, 3, ci, co), (3, 3, co, co),
                                                    (ci, co))]
    rows = [torch.from_numpy((1.0 + 0.1 * rng.randn(co)).astype(np.float32))
            for _ in range(6)]
    return x, ws, rows


@pytest.mark.parametrize("stale", ["w1", "wd", "row", "w1_in_place",
                                   "wd_in_place", "row_in_place"])
def test_downsample_block_desc_refuses_a_desc_of_other_tensors(stale):
    """A kept descriptor holds its own weights' K-major copies: a call with
    other weights or rows, or with its own changed in place since, refuses
    it, on the CPU too."""
    x, (w1, w2, wd), rows = _call_args(np.random.RandomState(9))
    desc = downsample_block_desc(w1, w2, wd, *rows)
    np.testing.assert_array_equal(
        fused_downsample_block(x, w1, w2, wd, *rows, desc=desc).numpy(),
        fused_downsample_block(x, w1, w2, wd, *rows).numpy())
    if stale == "w1":
        w1 = w1.clone()
    elif stale == "wd":
        wd = wd.clone()
    elif stale == "row":
        rows = rows[:4] + [rows[4].clone()] + rows[5:]
    elif stale == "w1_in_place":
        w1.neg_()
    elif stale == "wd_in_place":
        wd.neg_()
    else:
        rows[1].add_(1.0)
    with pytest.raises(ValueError, match="descriptor"):
        fused_downsample_block(x, w1, w2, wd, *rows, desc=desc)


@pytest.mark.parametrize("form", ["taps", "s2d"])
def test_downsample_block_desc_takes_both_conv1_forms(form):
    """conv1 as its (3, 3, C_in, C_out) taps or in the JAX kernel's s2d form:
    the same K-major copies, and the descriptor's key is the one a call with
    that form computes."""
    x, (w1, w2, wd), rows = _call_args(np.random.RandomState(10))
    w = w1 if form == "taps" else _transform_w1(w1)
    desc = downsample_block_desc(w, w2, wd, *rows)
    assert tuple(desc.w1.shape) == (16 * 8, 16)  # the flat arrays' s2d form
    np.testing.assert_array_equal(desc.kmajor("cpu")[0].numpy(),
                                  w1.reshape(9 * 8, 16).t().numpy())
    np.testing.assert_array_equal(
        fused_downsample_block(x, w, w2, wd, *rows, desc=desc).numpy(),
        fused_downsample_block_reference(x, w1, w2, wd, *rows).numpy())


@pytest.mark.parametrize("change", ["in_place", "clone", "view", "cast"])
def test_tensor_key_sees_what_a_descriptor_depends_on(change):
    """tensor_key differs after an in-place update, for another tensor of
    the same values, for a view of other strides over the same memory and
    for a cast; other values are kept as given. The stem's key is the same
    helper's."""
    t = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    key = _blocks.tensor_key((t, None, 0.5))
    assert key == _blocks.tensor_key((t, None, 0.5)) and key[1:] == (None, 0.5)
    if change == "in_place":
        t.mul_(1.0)
        other = t
    elif change == "clone":
        other = t.clone()
    elif change == "view":
        other = t.t()
    else:
        other = t.double()
    assert _blocks.tensor_key((other,))[0] != key[0]
    assert stem_key(other, None) == _blocks.tensor_key((other, None))


def _binary(model):
    return bt.prepare_binary_model(
        model, bt.BConfig(tops.BasicInputBinarizer, tops.BasicScaleBinarizer,
                          tops.XNORWeightBinarizer),
        ignore_layers_name=["_first_", "_last_"]).eval()


@pytest.fixture(scope="module")
def r34_layer4():
    """ResNet-34's fused layer4 (256 -> 512 channels) as the batch-1
    Predictor wraps it: a FusedDownBlock, then two FusedBlocks."""
    model = _binary(bt.models.resnet34(num_classes=10,
                                       generator=torch.Generator().manual_seed(0)))
    return Predictor(model, batch_size=1, device="cpu", dtype=None).model.layer4


def _down_reference(fb, x):
    """fused_downsample_block_reference on the module's live tensors."""
    b = fb.block
    dconv = b.downsample[1]
    a1, p1 = _act_kind(b.act1)
    a2, p2 = _act_kind(b.act2)
    y = fused_downsample_block_reference(
        _nhwc(x), fb.w1, fb.w2, fb.wd, b.conv1.scale, b.conv1.add, b.conv2.scale,
        b.conv2.add, dconv.scale, dconv.add, act=(a1, a2), prelu1=p1, prelu2=p2,
        threshold1=b.conv1.threshold, threshold2=b.conv2.threshold,
        thresholdd=dconv.threshold, pre=fb.pre, zero_to_one=_z21(b.conv1))
    return y.permute(0, 3, 1, 2)


def _kept_down(fb):
    """The kernel arguments the operator's CUDA implementation keeps for the
    tensors FusedDownBlock passes it (made on the CPU here)."""
    b = fb.block
    dconv = b.downsample[1]
    return tstrided.kept_args(
        fb.w1, fb.w2, fb.wd, b.conv1.scale, b.conv1.add, b.conv2.scale,
        b.conv2.add, dconv.scale, dconv.add, _act_kind(b.act1)[1],
        _act_kind(b.act2)[1], b.conv1.threshold, b.conv2.threshold,
        dconv.threshold, torch.device("cpu"))


@pytest.mark.parametrize("how", ["keep", "in_place", "load_state_dict"])
def test_fused_down_block_keeps_its_desc_until_its_weights_change(
        r34_layer4, monkeypatch, how):
    """The kernel arguments of FusedDownBlock's tensors are made once and
    serve every later forward; a weight changed in place since (by hand or
    by load_state_dict) makes the operator build new ones, whose K-major
    copies are the new weights', and the next forward computes with them."""
    monkeypatch.setattr(_blocks, "_check_cuda", lambda name, device: None)
    fb = copy.deepcopy(r34_layer4[0])
    assert isinstance(fb, FusedDownBlock) and not hasattr(fb, "_desc")
    x = torch.randn(1, 256, 4, 4, generator=torch.Generator().manual_seed(4))
    first = fb(x)
    kept = _kept_down(fb)
    old_w1t = kept.derived[0]  # conv1's K-major copy, its 9 * C_in taps
    assert kept.ptrs[3] == old_w1t.data_ptr()
    torch.testing.assert_close(first, _down_reference(fb, x), rtol=0, atol=0)
    if how == "keep":
        torch.testing.assert_close(fb(x), first, rtol=0, atol=0)
        assert _kept_down(fb) is kept and _kept_down(fb).derived[0] is old_w1t
        return
    if how == "in_place":
        fb.wd.neg_()
        fb.w1.neg_()
    else:
        state = fb.state_dict()
        state["w1"], state["wd"] = -state["w1"], -state["wd"]
        fb.load_state_dict(state)
    again = fb(x)
    new = _kept_down(fb)
    assert new is not kept
    np.testing.assert_array_equal(new.derived[0].numpy(), -old_w1t.numpy())
    assert not torch.equal(again, first)
    torch.testing.assert_close(again, _down_reference(fb, x), rtol=0, atol=0)


def _fused_bottleneck():
    from bnn_tpu_torch.models.layers import Bottleneck
    from bnn_tpu_torch.models.resnet import ResNet
    model = _binary(ResNet(Bottleneck, [1, 1, 1, 1], num_classes=10,
                           generator=torch.Generator().manual_seed(0)))
    fb = Predictor(model, batch_size=1, device="cpu", dtype=None).model.layer1[0]
    assert isinstance(fb, FusedBottleneck) and not hasattr(fb, "_desc")
    return fb


def _kept_bottleneck(fb):
    rows = fb._rows()
    return tbn.kept_args(fb.w1, fb.w2, fb.w3, fb.wd, [rows.get(r) for r in tbn.ROWS],
                         torch.device("cpu"))


@pytest.mark.parametrize("how", ["in_place", "load_state_dict", "cast"])
def test_fused_bottleneck_rebuilds_its_desc_after_its_weights_change(monkeypatch, how):
    """The kernel arguments of FusedBottleneck's tensors are kept across
    forwards; after w1 changes in place (by hand or by load_state_dict) the
    operator builds new ones, whose K-major copies are the new weights', and
    the forward equals fused_bottleneck_reference on them; a cast that
    replaces tensors they were made from rebuilds them too."""
    monkeypatch.setattr(_blocks, "_check_cuda", lambda name, device: None)
    fb = _fused_bottleneck()
    c = fb.w1.shape[0]
    x = torch.randn(1, c, 8, 8, generator=torch.Generator().manual_seed(5))
    first = fb(x)
    kept = _kept_bottleneck(fb)
    old_w1t = kept.derived[0]
    torch.testing.assert_close(fb(x), first, rtol=0, atol=0)
    assert _kept_bottleneck(fb) is kept
    if how == "in_place":
        fb.w1.neg_()
    elif how == "load_state_dict":
        state = fb.state_dict()
        state["w1"] = -state["w1"]
        fb.load_state_dict(state)
    else:
        fb.double().float()
    again = fb(x)
    new = _kept_bottleneck(fb)
    assert new is not kept
    w1t = new.derived[0]
    np.testing.assert_array_equal(w1t.numpy(), fb.w1.t().numpy())
    if how == "cast":
        torch.testing.assert_close(again, first, rtol=0, atol=0)
        return
    np.testing.assert_array_equal(w1t.numpy(), -old_w1t.numpy())
    rows = fb._rows()
    want = fused_bottleneck_reference(
        _nhwc(x), fb.w1, fb.w2, fb.w3, wd=fb.wd, act=fb._acts,
        zero_to_one=_z21(fb.block.conv1), **rows)
    assert not torch.equal(again, first)
    torch.testing.assert_close(again, want.permute(0, 3, 1, 2), rtol=0, atol=0)
