"""What ``fused_basic_block`` and ``fused_stem_chain``'s block phases need
from the host now that they run the tensor-core tile, against the JAX
kernels.

``csrc/fused_basic_block.cu`` and ``csrc/fused_stem_chain.cu`` run their
convs on ``bnn_common.cuh``'s MmaTile, as ``fused_chain`` does: it reads the
K-major ``(C_out, K)`` int8 copies that a block descriptor makes once per
device (``kernels/_blocks.Desc.kmajor``), loads A rows as 16-byte copies when
C % 16 == 0 and word by word otherwise, and its entry points refuse null
copies. ``fused_downsample_block`` runs the same tile, so every kernel on
the block descriptors takes one kept layout. The kernels run only on the card, where
chip_smoke.py holds them against their plain versions; here the plain
versions are held against the JAX Pallas kernels in interpret mode at a
width of each loader.

Tolerances: pointer layouts are exact. The basic block uses unit epilogues
and identity activations, so both sides compute the same integer sums plus
one f32 residual add: exact in f32. The entry's stem sums its float
convolution in another order than XLA's, so it is held to 1e-4, as
tests/test_torch_entry.py holds it in f32.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bnn_tpu_torch as bt
from bnn_tpu.kernels import block as jblock
from bnn_tpu.kernels import model as jmodel
from bnn_tpu_torch.inference import FusedBlock, Predictor
from bnn_tpu_torch.inference.megablock import _act_kind, _z21
from bnn_tpu_torch.kernels import (BlockParams, _blocks, fused_basic_block,
                                   fused_basic_block_reference,
                                   fused_stem_chain, fused_stem_chain_reference)
from bnn_tpu_torch.kernels import block
from bnn_tpu_torch.kernels.block import basic_block_desc
from bnn_tpu_torch.ops import binarizers as tops

CSRC = Path(__file__).resolve().parent.parent / "bnn_tpu_torch" / "csrc"
MMA_KERNELS = ("fused_chain", "fused_stem_chain", "fused_basic_block",
               "fused_downsample_block")


def _pm1(rng, *shape):
    return np.where(rng.randn(*shape) >= 0, 1, -1).astype(np.int8)


def _unit_pair(rng, c):
    """One basic block on both sides: random weights, unit epilogues (scale
    1, add 0) and zero thresholds."""
    ones, zeros = np.ones(c, np.float32), np.zeros(c, np.float32)
    raw = dict(w1=_pm1(rng, 3, 3, c, c), w2=_pm1(rng, 3, 3, c, c), scale1=ones,
               add1=zeros, scale2=ones, add2=zeros, threshold=zeros,
               threshold2=zeros)
    jbp = jmodel.BlockParams("basic", **{k: jnp.asarray(v) for k, v in raw.items()})
    tbp = BlockParams("basic", **{k: torch.from_numpy(v) for k, v in raw.items()})
    return jbp, tbp


def _x(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    x[rng.rand(*shape) < 0.1] = 0.0  # exact zeros, where sign(0) conventions differ
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_tensor_core_kernels_share_one_kept_layout(monkeypatch, dtype):
    """Every kernel's flat arrays carry the K-major pointers (a basic block
    has no shortcut copy): the four tensor-core kernels share one kept
    layout per dtype and device, built once."""
    monkeypatch.setattr(_blocks, "_check_cuda", lambda name, device: None)
    _, tbp = _unit_pair(np.random.RandomState(3), 8)
    arrays = [a if a.dtype == torch.int8 else a.to(dtype) for a in tbp.arrays()]
    desc = BlockParams.from_arrays(("basic", 8, 8), arrays).desc()
    cpu = torch.device("cpu")
    w1t, w2t, wdt = desc.kmajor(cpu)
    assert wdt is None
    kept = [desc.flat(name, dtype, cpu) for name in MMA_KERNELS]
    assert all(k is kept[0] for k in kept)
    ptrs, ints, copies = kept[0]
    assert ptrs[3:6] == [w1t.data_ptr(), w2t.data_ptr(), 0] and not copies
    assert ints[:3] == [0, 8, 8]
    other = torch.bfloat16 if dtype == torch.float32 else torch.float32
    assert desc.flat("fused_basic_block", other, cpu) is not kept[0]


@pytest.mark.parametrize("z21", [True, False], ids=["zero_to_one", "torch_sign"])
@pytest.mark.parametrize("c", [20, 32], ids=["C20-word-loader", "C32-16-byte-loader"])
def test_fused_basic_block_loader_widths_match_jax_kernel(c, z21):
    """At a width the kernel loads word by word (C % 16 != 0) and at one it
    loads in 16-byte rows: the port's fused_basic_block on CPU tensors (its
    plain version, launching nothing) equals the JAX kernel in interpret
    mode, exactly."""
    rng = np.random.RandomState(60 + c)
    x = _x(rng, (2, 7, 9, c))
    w1, w2 = _pm1(rng, 3, 3, c, c), _pm1(rng, 3, 3, c, c)
    ones, zeros = np.ones(c, np.float32), np.zeros(c, np.float32)
    want = np.asarray(jblock.fused_basic_block(
        jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2), ones, zeros, ones,
        zeros, act="identity", zero_to_one=z21, interpret=True))
    targs = [torch.from_numpy(a) for a in (x, w1, w2, ones, zeros, ones, zeros)]
    before = fused_basic_block.launches
    got = fused_basic_block(*targs, act="identity", zero_to_one=z21)
    assert fused_basic_block.launches == before  # no kernel on the CPU
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        fused_basic_block_reference(*targs, act="identity", zero_to_one=z21).numpy(),
        want)


@pytest.mark.parametrize("z21", [True, False], ids=["zero_to_one", "torch_sign"])
def test_fused_stem_chain_word_loader_width_matches_jax(z21):
    """A layer1 width of 20, which the block phases load word by word: the
    port's fused_stem_chain on CPU tensors (its plain version) against the
    JAX plain version and the JAX kernel in interpret mode, in f32."""
    rng = np.random.RandomState(70 + z21)
    x = rng.randn(1, 64, 64, 3).astype(np.float32)
    w = (0.2 * rng.randn(7, 7, 3, 20)).astype(np.float32)
    b = (0.2 * rng.randn(20)).astype(np.float32)
    pairs = [_unit_pair(rng, 20) for _ in range(2)]
    kw = dict(act="identity", zero_to_one=z21)
    jargs = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), [j for j, _ in pairs])
    wants = [jmodel.fused_stem_chain_reference(*jargs, **kw),
             jmodel.fused_stem_chain(*jargs, interpret=True, **kw)]
    targs = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
             [t for _, t in pairs])
    before = fused_stem_chain.launches
    got = fused_stem_chain(*targs, **kw)
    assert fused_stem_chain.launches == before
    assert got.shape == (1, 16, 16, 20) and got.dtype == torch.float32
    np.testing.assert_array_equal(
        fused_stem_chain_reference(*targs, **kw).numpy(), got.numpy())
    for want in wants:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


def test_sources_run_the_tensor_core_tile():
    """The block kernels instantiate run_block on MmaTile and refuse null
    K-major copies (a down block's shortcut copy too); the entry's
    shared-memory union holds MmaTile's ring; no source keeps the __dp4a
    tile or what only it used."""
    for name, down in (("fused_stem_chain", "false"), ("fused_basic_block", "false"),
                       ("fused_downsample_block", "true")):
        src = (CSRC / f"{name}.cu").read_text()
        assert f"run_block<bnn::MmaTile, {down}>" in src
        assert re.search(r"!b\.wt\[0\] \|\|\s*!b\.wt\[1\]", src), name
    assert re.search(r"!b\.wt\[1\] \|\| !b\.wt\[2\]",
                     (CSRC / "fused_downsample_block.cu").read_text())
    union = re.search(r"union Shared \{([^}]*)\}",
                      (CSRC / "fused_stem_chain.cu").read_text()).group(1)
    assert "bnn::MmaSmem gemm;" in union
    for name in ("fused_basic_block", "fused_downsample_block"):
        assert "__shared__ bnn::MmaSmem sm;" in (CSRC / f"{name}.cu").read_text()
    for src in CSRC.glob("*.cu*"):
        text = src.read_text()
        for gone in ("Dp4aTile", "bnn::Smem ", "gemm_item", "gemm_tile",
                     "struct Conv3x3S2 {", "__dp4a("):
            assert gone not in text, (src.name, gone)


def _call_args(rng, c=8):
    x = torch.from_numpy(_x(rng, (1, 4, 4, c)))
    ws = [torch.from_numpy(_pm1(rng, 3, 3, c, c)) for _ in range(2)]
    rows = [torch.from_numpy((1.0 + 0.1 * rng.randn(c)).astype(np.float32))
            for _ in range(4)]
    return x, ws, rows


@pytest.mark.parametrize("stale", ["w1", "w2", "row", "w1_in_place", "row_in_place"])
def test_fused_basic_block_refuses_a_desc_of_other_tensors(stale):
    """A kept descriptor holds its own weights' K-major copies: a call with
    other weights or rows, or with its own changed in place since, refuses
    it, on the CPU too."""
    x, (w1, w2), rows = _call_args(np.random.RandomState(8))
    desc = basic_block_desc(w1, w2, *rows)
    np.testing.assert_array_equal(
        fused_basic_block(x, w1, w2, *rows, desc=desc).numpy(),
        fused_basic_block(x, w1, w2, *rows).numpy())
    if stale == "w1":
        w1 = w1.clone()
    elif stale == "w2":
        w2 = w2.clone()
    elif stale == "row":
        rows = [rows[0].clone()] + rows[1:]
    elif stale == "w1_in_place":
        w1.neg_()
    else:
        rows[2].mul_(2.0)
    with pytest.raises(ValueError, match="descriptor"):
        fused_basic_block(x, w1, w2, *rows, desc=desc)


def _fused_block():
    model = bt.models.resnet18(num_classes=10,
                               generator=torch.Generator().manual_seed(0))
    model = bt.prepare_binary_model(
        model, bt.BConfig(tops.BasicInputBinarizer, tops.BasicScaleBinarizer,
                          tops.XNORWeightBinarizer),
        ignore_layers_name=["_first_", "_last_"]).eval()
    m = Predictor(model, batch_size=1, device="cpu", dtype=None).model
    fb = m.layer1.stage[0]
    assert isinstance(fb, FusedBlock) and not hasattr(fb, "_desc")
    return fb


def _kept(fb):
    """The kernel arguments the operator's CUDA implementation keeps for
    the tensors FusedBlock passes it (made on the CPU here)."""
    b = fb.block
    return block.kept_args(fb.w1, fb.w2, b.conv1.scale, b.conv1.add,
                           b.conv2.scale, b.conv2.add, _act_kind(b.act1)[1],
                           _act_kind(b.act2)[1], b.conv1.threshold,
                           b.conv2.threshold, torch.device("cpu"))


def test_fused_block_keeps_its_desc(monkeypatch):
    """The kernel arguments of FusedBlock's tensors (K-major copies, flat
    arrays) are made once and serve every later forward, until a cast
    replaces the tensors."""
    monkeypatch.setattr(_blocks, "_check_cuda", lambda name, device: None)
    fb = _fused_block()
    x = torch.randn(1, 64, 8, 8, generator=torch.Generator().manual_seed(1))
    first = fb(x)
    kept = _kept(fb)
    assert kept.ptrs[0] == fb.w1.data_ptr()
    torch.testing.assert_close(fb(x), first, rtol=0, atol=0)
    assert _kept(fb) is kept
    torch.testing.assert_close(first, fb.block(x), rtol=1e-5, atol=1e-5)
    fb.double().float()
    torch.testing.assert_close(fb(x), first, rtol=0, atol=0)
    assert _kept(fb) is not kept


@pytest.mark.parametrize("how", ["in_place", "load_state_dict"])
def test_fused_block_rebuilds_its_desc_after_an_in_place_update(monkeypatch, how):
    """A weight changed in place after the first fused forward (by hand or
    by load_state_dict) makes the operator build new kernel arguments, whose
    K-major copy is the new weights', and the next forward computes with the
    new weights, as the original block."""
    monkeypatch.setattr(_blocks, "_check_cuda", lambda name, device: None)
    fb = _fused_block()
    x = torch.randn(1, 64, 8, 8, generator=torch.Generator().manual_seed(2))
    first = fb(x)
    kept = _kept(fb)
    if how == "in_place":
        fb.w1.neg_()
    else:
        state = fb.state_dict()
        state["w1"] = -state["w1"]
        fb.load_state_dict(state)
    again = fb(x)
    new = _kept(fb)
    assert new is not kept and new.ptrs[3] == new.derived[0].data_ptr()
    assert torch.equal(new.derived[0], -kept.derived[0])  # w1's K-major copy
    assert not torch.equal(again, first)
    b = fb.block
    a1, p1 = _act_kind(b.act1)
    a2, p2 = _act_kind(b.act2)
    want = fused_basic_block_reference(
        x.permute(0, 2, 3, 1), fb.w1, fb.w2, b.conv1.scale, b.conv1.add,
        b.conv2.scale, b.conv2.add, act=(a1, a2), prelu1=p1, prelu2=p2,
        threshold=b.conv1.threshold, threshold2=b.conv2.threshold,
        pre=fb.pre, zero_to_one=_z21(b.conv1))
    torch.testing.assert_close(again, want.permute(0, 3, 1, 2), rtol=0, atol=0)
