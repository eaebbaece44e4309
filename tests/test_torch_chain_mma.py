"""What ``fused_chain``'s tensor-core tile needs from the host, against the
JAX kernels' layouts.

``csrc/fused_chain.cu`` runs its GEMM phases on ``bnn_common.cuh``'s
MmaTile, which reads K-major ``(C_out, K)`` int8 copies of each block's
weights that the block descriptor makes once per device
(``kernels/_blocks.Desc.kmajor``), and loads A rows as 16-byte copies when
C % 16 == 0, word by word otherwise. The copies are derived data: the
descriptor's own arrays stay the JAX layout, bit for bit. The kernel itself
runs only on the card, where chip_smoke.py holds it against its plain
version; here its plain version is held against the JAX Pallas kernel in
interpret mode at a width whose loader is the word gather.

Tolerances: weights and pointer layouts are exact. The chain cases use unit
epilogues and identity activations, so both sides compute the same integer
sums plus one f32 residual add per block: exact in f32.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_tpu.kernels import model as jmodel
from bnn_tpu_torch.kernels import (BlockParams, _blocks, fused_chain,
                                   fused_chain_reference)

CSRC = Path(__file__).resolve().parent.parent / "bnn_tpu_torch" / "csrc"


def _pm1(rng, *shape):
    return np.where(rng.randn(*shape) >= 0, 1, -1).astype(np.int8)


def _pair(rng, kind, ci, co, unit=False):
    """The same block on both sides from numpy arrays: random epilogues, or
    unit ones (scale 1, add 0) with zero thresholds."""
    def vec(c, loc):
        return np.full(c, loc, np.float32) if unit else (
            loc + 0.1 * rng.randn(c)).astype(np.float32)

    raw = dict(w1=_pm1(rng, 3, 3, ci, co), w2=_pm1(rng, 3, 3, co, co),
               scale1=vec(co, 1.0), add1=vec(co, 0.0), scale2=vec(co, 1.0),
               add2=vec(co, 0.0), threshold=vec(ci, 0.0), threshold2=vec(co, 0.0))
    if kind == "down":
        raw.update(wd=_pm1(rng, ci, co), scaled=vec(co, 1.0), addd=vec(co, 0.0),
                   thresholdd=vec(ci, 0.0))
    jbp = jmodel.BlockParams(kind, **{k: jnp.asarray(v) for k, v in raw.items()})
    tbp = BlockParams(kind, **{k: torch.from_numpy(v) for k, v in raw.items()})
    return raw, jbp, tbp


@pytest.mark.parametrize("kind,ci,co", [("basic", 8, 8), ("basic", 20, 20),
                                        ("down", 8, 16), ("down", 12, 20)])
def test_kmajor_copies_are_the_transposed_jax_arrays(kind, ci, co):
    """conv1, conv2 and the shortcut as (C_out, K): the transpose of the JAX
    arrays, a down block's conv1 as its 9*C_in taps (the JAX array is the
    s2d form, whose other 7*C_in rows are zero weights). The descriptor's
    arrays stay the JAX ones bit for bit, and the copies are made once per
    device."""
    raw, jbp, tbp = _pair(np.random.RandomState(ci + co), kind, ci, co)
    for j, t in zip(jbp.arrays(), tbp.arrays()):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    desc = tbp.desc()
    w1t, w2t, wdt = desc.kmajor(torch.device("cpu"))
    taps = raw["w1"].reshape(9 * ci, co)
    np.testing.assert_array_equal(w1t.numpy(), taps.T)
    np.testing.assert_array_equal(w2t.numpy(), np.asarray(jbp.w2).T)
    if kind == "down":
        np.testing.assert_array_equal(wdt.numpy(), np.asarray(jbp.wd).T)
        s2d = np.asarray(jbp.w1).reshape(2, 2, 2, 2, ci, co)  # (ki, kj, di, dj)
        dense = s2d.transpose(0, 2, 1, 3, 4, 5).reshape(4, 4, ci, co)
        np.testing.assert_array_equal(dense[1:, 1:].reshape(9 * ci, co).T,
                                      w1t.numpy())
        assert not dense[0].any() and not dense[:, 0].any()  # the zero taps
    else:
        assert wdt is None
        np.testing.assert_array_equal(w1t.numpy(), np.asarray(jbp.w1).T)
    for t in (w1t, w2t) + ((wdt,) if wdt is not None else ()):
        assert t.dtype == torch.int8 and t.is_contiguous()
    again = desc.kmajor("cpu")
    assert all(a is b for a, b in zip(again, (w1t, w2t, wdt)))
    assert tbp.desc().kmajor(torch.device("cpu"))[0] is w1t


def _header_constant(text: str, name: str, nrows: int) -> int:
    expr = re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)
    return eval(expr, {"NROWS": nrows})


def test_flat_layout_matches_what_setup_reads():
    """Desc's flat arrays hold, per block, bnn_common.cuh's BLOCK_PTRS
    pointers and BLOCK_INTS ints, with the rows where setup() reads them;
    every kernel on them gets the K-major copies (a down block's shortcut
    too); fused_stem_chain.cu finds its own arguments past the blocks' by
    the same constants."""
    common = (CSRC / "bnn_common.cuh").read_text()
    rows = re.search(r"enum Row \{([^}]*)\}", common).group(1)
    names = [r.strip() for r in rows.split(",")]
    assert names[-1] == "NROWS" and len(names) - 1 == len(_blocks.ROWS)
    nrows = len(_blocks.ROWS)
    assert _header_constant(common, "BLOCK_PTRS", nrows) == _blocks.BLOCK_PTRS
    assert _header_constant(common, "BLOCK_INTS", nrows) == _blocks.BLOCK_INTS
    assert "ptrs[6 + r]" in common and "ints[3 + r]" in common
    assert "ptrs[3 + j]" in common
    stem_chain = (CSRC / "fused_stem_chain.cu").read_text()
    assert "nblocks * bnn::BLOCK_PTRS" in stem_chain
    assert "nblocks * bnn::BLOCK_INTS" in stem_chain

    _, _, tbp = _pair(np.random.RandomState(1), "down", 8, 16)
    desc = tbp.desc()
    cpu = torch.device("cpu")
    for name in ("fused_chain", "fused_stem_chain", "fused_basic_block",
                 "fused_downsample_block"):
        ptrs, ints, keep = desc._layout(name, torch.float32, cpu)
        assert len(ptrs) == _blocks.BLOCK_PTRS and len(ints) == _blocks.BLOCK_INTS
        assert ptrs[:3] == [tbp.w1.data_ptr(), tbp.w2.data_ptr(), tbp.wd.data_ptr()]
        assert ptrs[3:6] == [t.data_ptr() for t in desc.kmajor(cpu)]
        assert 0 not in ptrs[3:6]
        assert ints[:3] == [1, 8, 16] and not keep
        assert ptrs[6 + _blocks.ROWS.index("scale1")] == tbp.po[0].data_ptr()
        assert ints[3 + _blocks.ROWS.index("threshold1")] == 8
    assert not hasattr(_blocks, "KMAJOR_KERNELS")  # no kernel takes nulls


def test_flat_arrays_are_kept_per_weight_layout(monkeypatch):
    """There is one weight layout: a descriptor that served
    fused_downsample_block first hands fused_chain, fused_stem_chain and
    fused_basic_block the same kept flat arrays, built once per dtype and
    device, with every K-major copy (a down block's shortcut too)."""
    monkeypatch.setattr(_blocks, "_check_cuda", lambda name, device: None)
    _, _, tbp = _pair(np.random.RandomState(2), "down", 8, 16)
    desc, cpu = tbp.desc(), torch.device("cpu")
    down = desc.flat("fused_downsample_block", torch.float32, cpu)
    assert down[0][3:6] == [t.data_ptr() for t in desc.kmajor(cpu)]
    assert 0 not in down[0][3:6]  # a down block's shortcut has its copy too
    for name in ("fused_chain", "fused_stem_chain", "fused_basic_block",
                 "fused_downsample_block"):
        assert desc.flat(name, torch.float32, cpu) is down
    assert desc.flat("fused_chain", torch.bfloat16, cpu) is not down


@pytest.mark.parametrize("plan,c", [(("basic", "basic"), 20),
                                    (("down", "basic"), 12)],
                         ids=["pair-C20", "down-C12-to-24"])
def test_fused_chain_word_loader_widths_match_jax_kernel(plan, c):
    """Channel counts with C % 16 != 0, which the kernel loads word by word:
    the port's fused_chain on CPU tensors (its plain version) equals the JAX
    kernel in interpret mode, exactly."""
    rng = np.random.RandomState(40 + c)
    pairs, ci = [], c
    for kind in plan:
        co = 2 * ci if kind == "down" else ci
        raw, jbp, tbp = _pair(rng, kind, ci, co, unit=True)
        pairs.append((jbp, tbp))
        ci = co
    x = rng.randn(2, 8, 8, c).astype(np.float32)
    x[rng.rand(*x.shape) < 0.1] = 0.0
    for z21 in (True, False):
        want = np.asarray(jmodel.fused_chain(
            jnp.asarray(x), [j for j, _ in pairs], act="identity",
            zero_to_one=z21, interpret=True))
        before = fused_chain.launches
        got = fused_chain(torch.from_numpy(x), [t for _, t in pairs],
                          act="identity", zero_to_one=z21)
        assert fused_chain.launches == before  # no kernel on the CPU
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            fused_chain_reference(torch.from_numpy(x), [t for _, t in pairs],
                                  act="identity", zero_to_one=z21).numpy(), want)
