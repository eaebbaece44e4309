"""What ``fused_bottleneck``'s tensor-core tile needs from the host, against
the JAX kernel's layouts.

``csrc/fused_bottleneck.cu`` runs its four GEMMs on ``bnn_common.cuh``'s
MmaTile, which reads K-major ``(N, K)`` int8 copies of the weights that
``kernels/bottleneck.BottleneckDesc.kmajor`` makes once per device, and loads
A rows as 16-byte copies where the GEMM's channel count is a multiple of 16,
word by word otherwise. The copies are derived data: the descriptor's own
arrays stay the JAX layout, bit for bit. The kernel itself runs only on the
card, where chip_smoke.py holds it against its plain version; here its plain
version is held against the JAX Pallas kernel in interpret mode at widths
whose GEMMs take the word loader.

Tolerances: weights and pointer layouts are exact. The f32 outputs are held
to 1e-5 and bf16 outputs to one bf16 ulp, as in tests/test_torch_bottleneck.py
(XLA may contract an epilogue's multiply and add into one rounding).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_tpu.kernels import bottleneck as jbn
from bnn_tpu_torch.kernels import (BottleneckDesc, _blocks, fused_bottleneck,
                                   fused_bottleneck_reference)
from bnn_tpu_torch.kernels import bottleneck as tbn

CU = Path(__file__).resolve().parent.parent / "bnn_tpu_torch" / "csrc" / "fused_bottleneck.cu"


def _pm1(rng, *shape):
    return np.where(rng.randn(*shape) >= 0, 1, -1).astype(np.int8)


def _vec(rng, c, loc=0.0, scale=0.1):
    return (loc + scale * rng.randn(c)).astype(np.float32)


def _block(rng, c, width, cout, projection):
    """(w1, w2, w3, wd or None, rows) as numpy arrays."""
    rows = dict(scale1=_vec(rng, width, 1.0), add1=_vec(rng, width),
                scale2=_vec(rng, width, 1.0), add2=_vec(rng, width),
                scale3=_vec(rng, cout, 1.0), add3=_vec(rng, cout))
    wd = None
    if projection:
        wd = _pm1(rng, c, cout)
        rows.update(scaled=_vec(rng, cout, 1.0), addd=_vec(rng, cout))
    return (_pm1(rng, c, width), _pm1(rng, 3, 3, width, width),
            _pm1(rng, width, cout), wd, rows)


def _t(v):
    return None if v is None else torch.from_numpy(np.asarray(v))


@pytest.mark.parametrize("c,width,cout,projection",
                         [(16, 8, 16, False), (24, 12, 48, True)],
                         ids=["identity", "projection"])
def test_kmajor_copies_are_the_transposed_jax_arrays(c, width, cout, projection):
    """w1, w2, w3 and the projection as (N, K): the transposes of the arrays
    that the JAX kernel multiplies (w2 as its (9 * width, width) taps in
    (dy, dx, c) order); the descriptor's JAX-layout weights stay as they
    were, bit for bit."""
    w1, w2, w3, wd, rows = _block(np.random.RandomState(c + width), c, width,
                                  cout, projection)
    before = [a.copy() for a in (w1, w2, w3) + ((wd,) if projection else ())]
    desc = BottleneckDesc(c, _t(w1), _t(w2), _t(w3), _t(wd),
                          {k: _t(v) for k, v in rows.items()})
    w1t, w2t, w3t, wdt = desc.kmajor(torch.device("cpu"))
    jw2 = np.asarray(jnp.asarray(w2).reshape(9 * width, width))  # the kernel's taps
    np.testing.assert_array_equal(jw2.reshape(3, 3, width, width), w2)
    np.testing.assert_array_equal(w1t.numpy(), np.asarray(jnp.asarray(w1)).T)
    np.testing.assert_array_equal(w2t.numpy(), jw2.T)
    np.testing.assert_array_equal(w3t.numpy(), np.asarray(jnp.asarray(w3)).T)
    assert w1t.shape == (width, c) and w2t.shape == (width, 9 * width)
    assert w3t.shape == (cout, width)
    if projection:
        np.testing.assert_array_equal(wdt.numpy(), np.asarray(jnp.asarray(wd)).T)
        assert wdt.shape == (cout, c)
    else:
        assert wdt is None
    for t in (w1t, w2t, w3t) + ((wdt,) if projection else ()):
        assert t.dtype == torch.int8 and t.is_contiguous()
    kept = [desc.w1, desc.w2.reshape(3, 3, width, width), desc.w3]
    kept += [desc.wd] if projection else []
    for t, a in zip(kept, before):
        np.testing.assert_array_equal(t.numpy(), a)


def test_kmajor_copies_are_made_once_per_device():
    w1, w2, w3, wd, rows = _block(np.random.RandomState(3), 16, 8, 32, True)
    desc = BottleneckDesc(16, _t(w1), _t(w2), _t(w3), _t(wd), rows)
    first = desc.kmajor(torch.device("cpu"))
    again = desc.kmajor("cpu")
    assert all(a is b for a, b in zip(first, again))
    # a new descriptor of the same weights makes its own
    other = BottleneckDesc(16, _t(w1), _t(w2), _t(w3), _t(wd), rows).kmajor("cpu")
    assert other[0] is not first[0] and torch.equal(other[0], first[0])


def _cu_constants() -> dict:
    """The flat layout's constants of fused_bottleneck.cu, and its Row enum."""
    text = CU.read_text()
    rows = re.search(r"enum Row \{([^}]*)\}", text).group(1)
    names = [r.strip() for r in rows.split(",")]
    assert names[-1] == "NROWS"
    env = {"NROWS": len(names) - 1, "rows": names[:-1]}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", text):
        env[name] = eval(expr, {}, dict(env))
    return env, text


@pytest.mark.parametrize("projection", [False, True], ids=["identity", "projection"])
def test_flat_layout_matches_what_the_kernel_reads(monkeypatch, projection):
    """The wrapper's pointers and ints are where bnn_fused_bottleneck reads
    them: the four JAX-layout weights, their K-major copies at PTR_WT, the
    rows at PTR_ROWS in the kernel's Row order, seven scratch pointers; the
    14 ints, then the row lengths at INT_ROWS."""
    cu, text = _cu_constants()
    assert len(cu["rows"]) == len(tbn.ROWS)
    for r in ("ptrs[PTR_ROWS + r]", "ints[INT_ROWS + r]", "ptrs[PTR_WT + 3]",
              "ptrs + PTR_SCRATCH", "ints[13]"):
        assert r in text
    scratch_read = {int(i) for i in re.findall(r"\bs\[(\d+)\]", text)}
    assert scratch_read == set(range(7))  # s = ptrs + PTR_SCRATCH
    nptrs, nints = cu["PTR_SCRATCH"] + 7, cu["INT_ROWS"] + cu["NROWS"]
    # the enum names the rows in ROWS order
    short = {"scale": "S", "add": "A", "prelu": "P", "threshold": "THR"}
    for name, enum in zip(tbn.ROWS, cu["rows"]):
        stem, suffix = re.fullmatch(r"(scale|add|prelu|threshold)(\w)", name).groups()
        assert enum == short[stem] + suffix.upper(), (name, enum)

    monkeypatch.setattr(_blocks, "_check_cuda", lambda name, device: None)
    c, width = 24, 12
    cout = 48 if projection else c
    w1, w2, w3, wd, rows = _block(np.random.RandomState(5), c, width, cout, projection)
    rows = {k: _t(v) for k, v in rows.items()}
    desc = BottleneckDesc(c, _t(w1), _t(w2), _t(w3), _t(wd), rows)
    x = torch.zeros((2, 5, 3, c))
    out = torch.empty((2, 5, 3, cout))
    ptrs, ints, keep = desc._args(x, out, ("relu", "prelu", "identity"), False)
    assert len(ptrs) == nptrs and len(ints) == nints
    assert ptrs[:2] == [x.data_ptr(), out.data_ptr()]
    assert ptrs[2:5] == [desc.w1.data_ptr(), desc.w2.data_ptr(), desc.w3.data_ptr()]
    assert ptrs[5] == (desc.wd.data_ptr() if projection else 0)
    assert ptrs[cu["PTR_WT"]:cu["PTR_ROWS"]] == [
        0 if t is None else t.data_ptr() for t in desc.kmajor("cpu")]
    for i, r in enumerate(tbn.ROWS):
        want = rows[r].data_ptr() if r in rows else 0
        assert ptrs[cu["PTR_ROWS"] + i] == want, r
        assert ints[cu["INT_ROWS"] + i] == (rows[r].numel() if r in rows else 0), r
    scratch = ptrs[cu["PTR_SCRATCH"]:]
    assert len(scratch) == 7 and all((p - scratch[0]) % 256 == 0 for p in scratch)
    assert ints[:cu["INT_ROWS"]] == [2, 5, 3, c, width, cout, int(projection),
                                     0, 1, 2, 0, 0, 0, 0]


_WORD_CASES = [
    # (C, width, C_out, act, zero_to_one, thresholds, bf16)
    (24, 12, 48, "prelu", False, True, False),
    (24, 12, 48, "relu", True, False, True),
    (20, 20, 20, ("prelu", "identity", "relu"), True, True, False),
    (20, 20, 20, "identity", False, False, True),
]


@pytest.mark.parametrize("case", _WORD_CASES, ids=str)
def test_word_loader_widths_match_jax_kernel(case):
    """Channel counts with C % 16 != 0, which the kernel's GEMMs load word by
    word: the port's fused_bottleneck on CPU tensors (its plain version)
    equals the JAX kernel in interpret mode."""
    c, width, cout, act, z21, thresholds, bf16 = case
    rng = np.random.RandomState(c + width + cout + len(str(act)))
    w1, w2, w3, wd, rows = _block(rng, c, width, cout, cout != c)
    if "prelu" in act:
        rows.update(prelu1=_vec(rng, width, 0.25), prelu2=_vec(rng, width, 0.25),
                    prelu3=_vec(rng, cout, 0.25))
    if thresholds:
        rows.update(threshold1=_vec(rng, c, 0.0, 0.05),
                    threshold2=_vec(rng, width, 0.0, 0.05),
                    threshold3=_vec(rng, width, 0.0, 0.05))
        if wd is not None:
            rows["thresholdd"] = _vec(rng, c, 0.0, 0.05)
    x = rng.randn(2, 6, 5, c).astype(np.float32)
    x[rng.rand(*x.shape) < 0.1] = 0.0
    pos = ("scale1", "add1", "scale2", "add2", "scale3", "add3")
    kw = {k: v for k, v in rows.items() if k not in pos}
    jx = jnp.asarray(x).astype(jnp.bfloat16) if bf16 else jnp.asarray(x)
    tx = torch.from_numpy(x).to(torch.bfloat16) if bf16 else torch.from_numpy(x)
    want = np.asarray(jbn.fused_bottleneck(
        jx, jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(w3),
        *[jnp.asarray(rows[k]) for k in pos],
        wd=None if wd is None else jnp.asarray(wd), act=act, zero_to_one=z21,
        interpret=True, **{k: jnp.asarray(v) for k, v in kw.items()}
    ).astype(jnp.float32))
    targs = [tx, _t(w1), _t(w2), _t(w3)] + [_t(rows[k]) for k in pos]
    tkw = dict(wd=_t(wd), act=act, zero_to_one=z21,
               **{k: _t(v) for k, v in kw.items()})
    before = fused_bottleneck.launches
    got = fused_bottleneck(*targs, **tkw)
    assert fused_bottleneck.launches == before  # no kernel on the CPU
    assert got.shape == (2, 6, 5, cout)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    tol = dict(rtol=2.0 ** -8, atol=1e-5) if bf16 else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    np.testing.assert_array_equal(
        fused_bottleneck_reference(*targs, **tkw).float().numpy(),
        got.float().numpy())
