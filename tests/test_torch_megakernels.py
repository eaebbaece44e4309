"""The port's residual-block kernel modules against the JAX kernels.

The JAX Pallas kernels run in interpret mode, as tests/test_block_kernel.py,
tests/test_strided_block.py and tests/test_stage_kernels.py run them; the
port takes its plain versions, as its wrappers do for CPU tensors. The CUDA
kernels themselves are held against the plain versions on the card by
chip_smoke.py.

Tolerances: the integer parts (unit epilogues, identity activations) are
exact sums on both sides, so they must be equal. The f32 epilogues and the
residual adds are the same operations in both, but XLA may contract a
multiply and an add into one rounding, so f32 outputs are held to 1e-5. The
head's pooled mean and fc dot are summed in another order, so logits are
held to 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_tpu.kernels import block as jblock
from bnn_tpu.kernels import model as jmodel
from bnn_tpu.kernels import strided_block as jstrided
from bnn_tpu_torch.kernels import (BlockParams, fused_basic_block,
                                   fused_basic_block_reference, fused_chain,
                                   fused_chain_reference, fused_down_stage,
                                   fused_downsample_block,
                                   fused_downsample_block_reference, fused_pair,
                                   fused_pair_reference)
from bnn_tpu_torch.kernels import strided_block as tstrided
from bnn_tpu_torch.kernels.block import fused_basic_block_cuda
from bnn_tpu_torch.kernels.model import flatten, fused_chain_cuda
from bnn_tpu_torch.kernels.strided_block import fused_downsample_block_cuda


def _pm1(rng, *shape):
    return np.where(rng.randn(*shape) >= 0, 1, -1).astype(np.int8)


def _x(rng, shape, zeros):
    x = rng.randn(*shape).astype(np.float32)
    if zeros:  # ReLU-like input: exact zeros, where sign(0) conventions differ
        x = np.maximum(x, 0.0)
    return x + (0.0 if zeros else 0.01)


def _vec(rng, c, loc=0.0, scale=0.1):
    return (loc + scale * rng.randn(c)).astype(np.float32)


def _j(v):
    return None if v is None else jnp.asarray(v)


def _t(v):
    return None if v is None else torch.from_numpy(np.asarray(v))


_OPTIONS = [
    # (act, pre, zero_to_one, thresholds)
    ("relu", False, False, False),
    ("relu", False, True, True),
    ("prelu", True, True, True),
    ("prelu", False, False, True),
    ("identity", True, False, False),
    (("prelu", "relu"), False, True, False),
]


def _basic_case(rng, n, h, w, c, act, thresholds, zeros):
    x = _x(rng, (n, h, w, c), zeros)
    args = [x, _pm1(rng, 3, 3, c, c), _pm1(rng, 3, 3, c, c),
            _vec(rng, c, 1.0), _vec(rng, c), _vec(rng, c, 1.0), _vec(rng, c)]
    kw = {}
    if "prelu" in act:
        kw.update(prelu1=_vec(rng, c, 0.25), prelu2=_vec(rng, c, 0.25))
    if thresholds:
        kw.update(threshold=_vec(rng, c, 0.0, 0.05),
                  threshold2=_vec(rng, c, 0.0, 0.05))
    return args, kw


@pytest.mark.parametrize("opts", _OPTIONS, ids=str)
def test_fused_basic_block_matches_jax_kernel(opts):
    act, pre, z21, thresholds = opts
    rng = np.random.RandomState(len(str(opts)))
    args, kw = _basic_case(rng, 2, 8, 8, 8, act, thresholds, zeros=not z21)
    want = np.asarray(jblock.fused_basic_block(
        *map(_j, args), act=act, pre=pre, zero_to_one=z21, interpret=True,
        **{k: _j(v) for k, v in kw.items()}))
    targs, tkw = list(map(_t, args)), {k: _t(v) for k, v in kw.items()}
    got = fused_basic_block_reference(*targs, act=act, pre=pre,
                                      zero_to_one=z21, **tkw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    before = fused_basic_block.launches
    np.testing.assert_array_equal(
        fused_basic_block(*targs, act=act, pre=pre, zero_to_one=z21, **tkw).numpy(),
        got)
    assert fused_basic_block.launches == before  # no kernel on the CPU


@pytest.mark.parametrize("z21", [True, False])
def test_fused_basic_block_integer_part_is_exact(z21):
    rng = np.random.RandomState(5)
    x, w1, w2 = _x(rng, (1, 6, 10, 12), zeros=True), _pm1(rng, 3, 3, 12, 12), \
        _pm1(rng, 3, 3, 12, 12)
    ones, zeros = np.ones(12, np.float32), np.zeros(12, np.float32)
    want = np.asarray(jblock.fused_basic_block(
        jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2), ones, zeros, ones,
        zeros, act="identity", zero_to_one=z21, interpret=True))
    got = fused_basic_block_reference(
        torch.from_numpy(x), torch.from_numpy(w1), torch.from_numpy(w2),
        torch.ones(12), torch.zeros(12), torch.ones(12), torch.zeros(12),
        act="identity", zero_to_one=z21).numpy()
    np.testing.assert_array_equal(got, want)


def _down_case(rng, n, h, w, ci, co, act, thresholds, zeros):
    x = _x(rng, (n, h, w, ci), zeros)
    args = [x, _pm1(rng, 3, 3, ci, co), _pm1(rng, 3, 3, co, co),
            _pm1(rng, ci, co)]
    args += [_vec(rng, co, 1.0), _vec(rng, co), _vec(rng, co, 1.0),
             _vec(rng, co), _vec(rng, co, 1.0), _vec(rng, co)]
    kw = {}
    if "prelu" in act:
        kw.update(prelu1=_vec(rng, co, 0.25), prelu2=_vec(rng, co, 0.25))
    if thresholds:
        kw.update(threshold1=_vec(rng, ci, 0.0, 0.1),
                  threshold2=_vec(rng, co, 0.0, 0.05),
                  thresholdd=_vec(rng, ci, 0.0, 0.05))
    return args, kw


@pytest.mark.parametrize("opts", _OPTIONS, ids=str)
def test_fused_downsample_block_matches_jax_kernel(opts):
    act, pre, z21, thresholds = opts
    rng = np.random.RandomState(100 + len(str(opts)))
    args, kw = _down_case(rng, 2, 8, 12, 8, 16, act, thresholds, zeros=not z21)
    want = np.asarray(jstrided.fused_downsample_block(
        *map(_j, args), act=act, pre=pre, zero_to_one=z21, interpret=True,
        **{k: _j(v) for k, v in kw.items()}))
    targs, tkw = list(map(_t, args)), {k: _t(v) for k, v in kw.items()}
    got = fused_downsample_block_reference(*targs, act=act, pre=pre,
                                           zero_to_one=z21, **tkw).numpy()
    assert got.shape == (2, 4, 6, 16)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the s2d weight form gives the same function, and the wrapper takes
    # the plain version on the CPU
    targs[1] = tstrided._transform_w1(targs[1])
    before = fused_downsample_block.launches
    np.testing.assert_array_equal(
        fused_downsample_block(*targs, act=act, pre=pre, zero_to_one=z21,
                               **tkw).numpy(), got)
    assert fused_downsample_block.launches == before


def test_transform_w1_matches_jax():
    w = _pm1(np.random.RandomState(9), 3, 3, 8, 16)
    ws = tstrided._transform_w1(torch.from_numpy(w))
    np.testing.assert_array_equal(ws.numpy(),
                                  np.asarray(jstrided._transform_w1(jnp.asarray(w))))
    np.testing.assert_array_equal(tstrided._untransform_w1(ws, 8).numpy(), w)


def test_avgpool_order_is_the_kernels():
    """The 2x2 mean adds the four phases left to right, then scales."""
    x = torch.tensor([1.0, 2.0 ** -24, 2.0 ** -24, 2.0 ** -24]).reshape(1, 2, 2, 1)
    from bnn_tpu_torch.kernels import _blocks
    got = _blocks.avgpool2x2(x).item()
    # (((1 + e) + e) + e) rounds each e away; another order would not
    assert got == 0.25


def _block_pair(rng, kind, ci, co, act, thresholds):
    """The same BlockParams on both sides, built from numpy arrays."""
    raw = dict(w1=_pm1(rng, 3, 3, ci, co), w2=_pm1(rng, 3, 3, co, co),
               scale1=np.abs(_vec(rng, co, 0.0, 1.0)) + 0.1, add1=_vec(rng, co),
               scale2=np.abs(_vec(rng, co, 0.0, 1.0)) + 0.1, add2=_vec(rng, co))
    if kind == "down":
        raw.update(wd=_pm1(rng, ci, co),
                   scaled=np.abs(_vec(rng, co, 0.0, 1.0)) + 0.1,
                   addd=_vec(rng, co))
    if "prelu" in act:
        raw.update(prelu1=_vec(rng, co, 0.25), prelu2=_vec(rng, co, 0.25))
    if thresholds:
        raw.update(threshold=_vec(rng, ci, 0.0, 0.05),
                   threshold2=_vec(rng, co, 0.0, 0.05))
        if kind == "down":
            raw["thresholdd"] = _vec(rng, ci, 0.0, 0.05)
    jbp = jmodel.BlockParams(kind, **{k: jnp.asarray(v) for k, v in raw.items()})
    tbp = BlockParams(kind, **{k: torch.from_numpy(v) for k, v in raw.items()})
    return jbp, tbp


@pytest.mark.parametrize("kind", ["basic", "down"])
@pytest.mark.parametrize("full", [True, False])
def test_block_params_arrays_equal_jax(kind, full):
    rng = np.random.RandomState(3 + full)
    jbp, tbp = _block_pair(rng, kind, 8, 8 if kind == "basic" else 16,
                           "prelu" if full else "relu", full)
    ja, ta = jbp.arrays(), tbp.arrays()
    assert len(ja) == len(ta)
    for j, t in zip(ja, ta):
        assert t.dtype == {np.dtype(np.int8): torch.int8,
                           np.dtype(np.float32): torch.float32}[np.asarray(j).dtype]
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    meta = (tbp.kind, tbp.ci, tbp.co)
    back = BlockParams.from_arrays(meta, ta)
    assert all(a is b for a, b in zip(back.arrays(), ta))


_CHAINS = [
    # (plan, act, pre, zero_to_one, thresholds, head)
    (("basic", "basic"), "relu", False, False, False, False),
    (("basic", "basic", "basic"), "prelu", True, True, True, False),
    (("down", "basic"), "relu", False, False, True, True),
    (("down", "basic"), "prelu", False, True, True, False),
    (("down", "basic", "basic"), "identity", True, False, False, True),
]


@pytest.mark.parametrize("case", _CHAINS, ids=str)
def test_fused_chain_matches_jax_kernel(case):
    plan, act, pre, z21, thresholds, with_head = case
    rng = np.random.RandomState(200 + len(str(case)))
    c = 8
    pairs, ci = [], c
    for kind in plan:
        co = 2 * ci if kind == "down" else ci
        pairs.append(_block_pair(rng, kind, ci, co, act, thresholds))
        ci = co
    n = 2
    x = _x(rng, (n, 8, 8, c), zeros=not z21)
    head = ()
    if with_head:
        head = (rng.randn(ci, 10).astype(np.float32), _vec(rng, 10, 0.0, 1.0))
    want = np.asarray(jmodel.fused_chain(
        jnp.asarray(x), [j for j, _ in pairs], *map(jnp.asarray, head),
        act=act, pre=pre, zero_to_one=z21, interpret=True))
    tblocks = [t for _, t in pairs]
    thead = tuple(map(torch.from_numpy, head))
    got = fused_chain_reference(torch.from_numpy(x), tblocks, *thead, act=act,
                                pre=pre, zero_to_one=z21).numpy()
    if with_head:
        assert got.shape == (n, 10) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    entry = fused_down_stage if plan[0] == "down" else fused_pair
    before = fused_chain.launches
    np.testing.assert_array_equal(
        entry(torch.from_numpy(x), tblocks, *thead, act=act, pre=pre,
              zero_to_one=z21).numpy(), got)
    assert fused_chain.launches == before


def test_fused_chain_bf16_io():
    """bf16 in, bf16 out; the blocks in between stay f32."""
    rng = np.random.RandomState(17)
    _, b0 = _block_pair(rng, "basic", 8, 8, "relu", True)
    _, b1 = _block_pair(rng, "basic", 8, 8, "relu", True)
    x = torch.from_numpy(_x(rng, (1, 6, 6, 8), zeros=False)).to(torch.bfloat16)
    got = fused_pair_reference(x, [b0, b1])
    assert got.dtype == torch.bfloat16
    want = fused_pair_reference(x.float(), [b0, b1], out_dtype=torch.float32)
    torch.testing.assert_close(got, want.to(torch.bfloat16), rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["plan", "batch", "width"])
def test_fused_chain_rejects(bad):
    rng = np.random.RandomState(23)
    _, basic = _block_pair(rng, "basic", 8, 8, "relu", False)
    _, down = _block_pair(rng, "down", 8, 16, "relu", False)
    x = torch.zeros(1, 8, 8, 8)
    with pytest.raises(ValueError):
        if bad == "plan":
            fused_chain(x, [basic, down])
        elif bad == "batch":
            fused_chain(torch.zeros(9, 8, 8, 8), [basic])
        else:
            fused_chain(torch.zeros(1, 8, 8, 4), [basic])


def test_block_kernels_reject_bad_shapes():
    w = torch.ones(3, 3, 8, 8, dtype=torch.int8)
    one = torch.ones(8)
    with pytest.raises(ValueError):
        fused_basic_block(torch.zeros(1, 4, 4, 6), w, w, one, one, one, one)
    with pytest.raises(ValueError):  # odd H
        fused_downsample_block(torch.zeros(1, 5, 4, 8), w, w, torch.ones(8, 8),
                               one, one, one, one, one, one)
    with pytest.raises(ValueError):
        fused_basic_block(torch.zeros(1, 4, 4, 8), w, w, one, one, one, one,
                          act="gelu")


def _wrapper_call(kernel, x, w, one):
    """The operator's CUDA implementation, called as the dispatcher calls it
    on CUDA tensors (without a card, the meta device stands in)."""
    tail = ("relu", "relu", False, True, None)
    if kernel == "basic":
        return fused_basic_block_cuda(x, w, w, one, one, one, one, *[None] * 4,
                                      *tail)
    if kernel == "down":
        return fused_downsample_block_cuda(x, w, w, w[0, 0], *[one] * 6,
                                           *[None] * 5, *tail)
    arrays, kinds = flatten([BlockParams("basic", w, w, scale1=one)])
    return fused_chain_cuda(x, arrays, kinds, None, None, *tail)


@pytest.mark.parametrize("kernel", ["basic", "down", "chain"])
def test_cuda_wrappers_refuse_mixed_devices(kernel):
    """Off the CPU an operator launches its kernel or raises: its CUDA
    implementation refuses weights on another device than x before anything
    is built, and a device that is not CUDA. Without a card here, the meta
    device stands in for it (through the dispatcher, meta tensors take the
    fake implementation: shapes only)."""
    x = torch.zeros(1, 4, 4, 8, device="meta")
    w = torch.ones(3, 3, 8, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="every tensor on meta"):
        _wrapper_call(kernel, x, w, torch.ones(8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        _wrapper_call(kernel, x, w.to("meta"), torch.ones(8, device="meta"))


@pytest.mark.parametrize("kind", ["basic", "down"])
def test_block_params_desc_rows_follow_the_kernel_order(kind):
    """BlockParams.desc() hands the kernel each epilogue row at its place in
    csrc/bnn_common.cuh's order (_blocks.ROWS), read from the stored arrays
    (thresholds of the input channels from the tiled rows); rows a basic
    block has not are absent. The descriptor is made once."""
    from bnn_tpu_torch.kernels import _blocks

    ci, co = 8, (16 if kind == "down" else 8)
    outs = ["scale1", "add1", "prelu1", "scale2", "add2", "prelu2", "threshold2"]
    ins = ["threshold"]
    if kind == "down":
        outs += ["scaled", "addd"]
        ins += ["thresholdd"]
    kw = {n: torch.full((co,), float(i + 1)) for i, n in enumerate(outs)}
    kw.update({n: torch.full((ci,), float(-1 - i)) for i, n in enumerate(ins)})
    wd = torch.ones(ci, co, dtype=torch.int8) if kind == "down" else None
    bp = BlockParams(kind, torch.ones(3, 3, ci, co, dtype=torch.int8),
                     torch.ones(3, 3, co, co, dtype=torch.int8), wd=wd, **kw)
    desc = bp.desc()
    assert bp.desc() is desc
    assert (desc.down, desc.ci, desc.co) == (kind == "down", ci, co)
    assert desc.w1 is bp.w1 and desc.w2 is bp.w2 and desc.wd is getattr(bp, "wd", None)
    assert len(desc.rows) == len(_blocks.ROWS)
    for r, v in zip(_blocks.ROWS, desc.rows):
        name = "threshold" if r == "threshold1" else r
        if name not in kw:
            assert v is None, r
            continue
        mat, i = v
        width = ci if r in _blocks._IN_ROWS else co
        torch.testing.assert_close(mat[i, :width], kw[name], rtol=0, atol=0)
