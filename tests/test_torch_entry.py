"""The network entry in one launch: the port's fused_stem_chain and
fuse_entry against the JAX package's.

The port takes its plain version, as its wrapper does for CPU tensors. It is
held against the JAX plain version, and in f32 also against the JAX kernel
in interpret mode, as tests/test_stage_kernels.py runs it. The stem's float
convolution sums in another order than XLA's, so f32 outputs are held to
1e-4 (tests/test_torch_small_batch.py). In bf16 the stem output rounds to
bf16 on both sides, and a sum that differs in its last f32 bit can round to
the neighbouring bf16 value: bf16 outputs are held to two bf16 ulps of the
output, and all but 1% of the values must be equal. The JAX kernel itself
sums the stem in a third order (selector matmuls), so in bf16 it is held
only to the split JAX pipeline, by the JAX package's own tests. Inside the
port, the merged entry equals the split pipeline bit for bit.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_tpu.kernels import model as jmodel
from bnn_tpu_torch.inference import (FusedEntry, FusedStage, FusedStem,
                                     Predictor, fuse_entry)
from bnn_tpu_torch.inference import stages as tstages
from bnn_tpu_torch.kernels import (StemDesc, fused_stem_chain,
                                   fused_stem_chain_reference)
from test_torch_megakernels import _block_pair, _vec
from test_torch_small_batch import _IMAGES, _jax_logits, _models, _nchw

_CASES = [
    # (batch, bf16, act, zero_to_one, thresholds, interpret the JAX kernel)
    (1, False, "relu", False, False, True),
    (2, False, "prelu", True, True, True),
    (1, True, "prelu", False, True, False),
    (2, True, "relu", True, False, False),
    (2, False, "relu", True, True, False),
    (1, False, "prelu", False, False, True),
    (1, True, "relu", False, True, False),
    (2, True, "prelu", True, True, False),
]


def _case(rng, n, act, thresholds):
    x = rng.randn(n, 64, 64, 3).astype(np.float32)
    w = (0.2 * rng.randn(7, 7, 3, 16)).astype(np.float32)
    b = _vec(rng, 16, 0.0, 0.2)
    pairs = [_block_pair(rng, "basic", 16, 16, act, thresholds) for _ in range(2)]
    return x, w, b, pairs


@pytest.mark.parametrize("case", _CASES, ids=str)
def test_fused_stem_chain_matches_jax(case):
    n, bf16, act, z21, thresholds, interpret = case
    rng = np.random.RandomState(300 + len(str(case)))
    x, w, b, pairs = _case(rng, n, act, thresholds)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    jx = jnp.asarray(x).astype(jdt)
    kw = dict(act=act, zero_to_one=z21)
    want = [jmodel.fused_stem_chain_reference(
        jx, jnp.asarray(w), jnp.asarray(b), [j for j, _ in pairs], **kw)]
    if interpret:
        want.append(jmodel.fused_stem_chain(
            jx, jnp.asarray(w), jnp.asarray(b), [j for j, _ in pairs],
            interpret=True, **kw))
    tx = torch.from_numpy(x).to(tdt)
    tw, tb, tblocks = torch.from_numpy(w), torch.from_numpy(b), [t for _, t in pairs]
    got = fused_stem_chain_reference(tx, tw, tb, tblocks, **kw)
    assert got.dtype == tdt and got.shape == (n, 16, 16, 16)
    got = got.float().numpy()
    for wnt in want:
        wnt = np.asarray(wnt, np.float32)
        if bf16:
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(wnt), 2.0 ** -126))) - 7)
            assert (np.abs(got - wnt) <= 2 * ulp + 1e-6).all()
            assert (got != wnt).mean() < 0.01
        else:
            np.testing.assert_allclose(got, wnt, rtol=1e-4, atol=1e-4)
    # the wrapper takes the plain version on the CPU, launching nothing
    before = fused_stem_chain.launches
    np.testing.assert_array_equal(
        fused_stem_chain(tx, tw, tb, tblocks, **kw).float().numpy(), got)
    assert fused_stem_chain.launches == before


def test_fused_stem_chain_is_the_split_pair():
    """The plain version is the stem's plain version rounded to the IO dtype,
    then the chain's: the split pipeline, bit for bit."""
    from bnn_tpu_torch.kernels import fused_chain, fused_stem

    rng = np.random.RandomState(7)
    x, w, b, pairs = _case(rng, 2, "prelu", True)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tw, tb, tblocks = torch.from_numpy(w), torch.from_numpy(b), [t for _, t in pairs]
    split = fused_chain(fused_stem(tx, tw, tb), tblocks, act="prelu",
                        zero_to_one=True)
    merged = fused_stem_chain(tx, tw, tb, tblocks, act="prelu", zero_to_one=True)
    assert merged.dtype == torch.bfloat16
    assert torch.equal(merged, split)


@pytest.mark.parametrize("bad", ["batch", "height", "width", "channels",
                                 "down", "kernel", "stale_desc"])
def test_fused_stem_chain_rejects(bad):
    rng = np.random.RandomState(11)
    _, basic = _block_pair(rng, "basic", 16, 16, "relu", False)
    _, down = _block_pair(rng, "down", 16, 32, "relu", False)
    x, w, blocks = torch.zeros(1, 64, 64, 3), torch.zeros(7, 7, 3, 16), [basic]
    kw = {}
    if bad == "batch":
        x = torch.zeros(9, 64, 64, 3)
    elif bad == "height":
        x = torch.zeros(1, 72, 64, 3)
    elif bad == "width":
        x = torch.zeros(1, 64, 60, 3)
    elif bad == "channels":
        w = torch.zeros(7, 7, 3, 8)
    elif bad == "down":
        blocks = [down]
    elif bad == "stale_desc":  # a descriptor of other weights than w
        kw["stem"] = StemDesc(torch.zeros(7, 7, 3, 16))
    else:
        w = torch.zeros(5, 5, 3, 16)
    with pytest.raises(ValueError):
        fused_stem_chain(x, w, None, blocks, **kw)


def _predictor(batch, dtype=torch.bfloat16):
    _, tm, _ = _models("flagship")
    return Predictor(copy.deepcopy(tm), batch_size=batch, device="cpu",
                     dtype=dtype)


def test_fuse_entry_structure():
    pred = _predictor(1)
    m = pred.model
    stem, stage = m.conv1, m.layer1
    assert isinstance(stem, FusedStem) and isinstance(stage, FusedStage)
    assert fuse_entry(m) == 1
    assert isinstance(m.conv1, FusedEntry)
    assert m.conv1.stem is stem and m.conv1.stage is stage
    assert isinstance(m.layer1, torch.nn.Identity)
    assert fuse_entry(m) == 0  # idempotent


def test_fuse_entry_needs_the_fused_passes():
    """Without a fused stem and a fused layer1 there is nothing to merge."""
    _, tm, _ = _models("flagship")
    pred = Predictor(copy.deepcopy(tm), batch_size=1, device="cpu", fuse=False)
    assert fuse_entry(pred.model) == 0


@pytest.mark.parametrize("batch", [1, 4])
def test_fuse_entry_predictor_equals_split_bit_for_bit(batch):
    split, merged = _predictor(batch), _predictor(batch)
    assert fuse_entry(merged.model) == 1
    x = _nchw(_IMAGES)
    out = merged(x)
    assert torch.equal(out, split(x))
    assert out.dtype == torch.float32 and out.shape == (4, 10)


def test_fuse_entry_predictor_matches_jax():
    pred = _predictor(4, dtype=None)
    assert fuse_entry(pred.model) == 1
    got = pred(_nchw(_IMAGES)).numpy()
    want = _jax_logits("flagship")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


@pytest.mark.parametrize("shape", [(2, 3, 72, 72), (5, 3, 32, 32),
                                   (1, 3, 32, 36)])
def test_fuse_entry_falls_back(shape, monkeypatch):
    """At H % 16, W % 8 or a batch above the stage's cap the entry runs the
    held stem and stage, and equals the split model."""
    calls = []
    real = tstages.fused_stem_chain

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(tstages, "fused_stem_chain", spy)
    split, merged = _predictor(8), _predictor(8)
    assert fuse_entry(merged.model) == 1
    x = torch.from_numpy(np.random.RandomState(5).randn(*shape).astype(np.float32))
    with torch.no_grad():
        want = split.model(x.to(torch.bfloat16))
        got = merged.model(x.to(torch.bfloat16))
    assert torch.equal(got, want)
    assert calls == []
    with torch.no_grad():
        merged.model(x[:1, :, :32, :32].to(torch.bfloat16))
    assert calls == [(1, 32, 32, 3)]
