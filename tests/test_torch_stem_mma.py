"""The tensor-core stem's host side on the CPU: the exact three-piece split of
f32 operands, ``StemDesc``'s K-major weight pieces, the pass list (and its
mirror in ``csrc/stem_common.cuh``), the descriptor kept by ``FusedStem``,
the window layout's bank conflicts, and the plain version against the JAX
kernels in interpret mode in bf16 and f32. The CUDA kernels themselves are
held against the plain version on the card by chip_smoke.py."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from bnn_tpu.kernels import stem as jstem
from bnn_tpu_torch.inference.stem import FusedStem
from bnn_tpu_torch.kernels import StemDesc, fused_stem, fused_stem_reference
from bnn_tpu_torch.kernels.stem import (KP, PASSES, k_tap_channel, kept_stem,
                                        split_pieces, stem_passes)

_HEADER = (Path(__file__).resolve().parent.parent / "bnn_tpu_torch" / "csrc"
           / "stem_common.cuh").read_text()


def _header_const(name):
    return re.search(rf"constexpr int {name} = ([^;]+);", _HEADER).group(1)


_VALUES = {
    "normal": np.random.RandomState(0).randn(4096).astype(np.float32),
    "zeros_and_ones": np.array([0.0, -0.0, 1.0, -1.0], np.float32),
    "near_1e30": (np.random.RandomState(1).uniform(0.5, 2.0, 512) * 1e30
                  * np.where(np.arange(512) % 2, 1, -1)).astype(np.float32),
    "near_1e-30": (np.random.RandomState(2).uniform(0.5, 2.0, 512) * 1e-30
                   * np.where(np.arange(512) % 2, 1, -1)).astype(np.float32),
}


@pytest.mark.parametrize("family", sorted(_VALUES))
def test_split_pieces_sum_back_exactly(family):
    v = torch.from_numpy(_VALUES[family])
    p = split_pieces(v)
    assert p.dtype == torch.bfloat16 and p.shape == (3,) + tuple(v.shape)
    # in f64 the three bf16 pieces sum to the f32 value exactly ...
    np.testing.assert_array_equal(p.double().sum(0).numpy(), v.double().numpy())
    # ... and so do the f32 sums hi + mid, then + lo
    back = (p[0].float() + p[1].float()) + p[2].float()
    np.testing.assert_array_equal(back.numpy(), v.numpy())
    # a bf16 value is its own first piece, with zero residues
    vb = v.to(torch.bfloat16)
    pb = split_pieces(vb)
    assert torch.equal(pb[0], vb) and not pb[1:].float().any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,o", [(3, 64), (1, 40), (4, 64), (2, 130)])
def test_stem_desc_k_major_pieces(c, o, dtype):
    rng = np.random.RandomState(c * o)
    w = torch.from_numpy((0.1 * rng.randn(7, 7, c, o)).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.randn(o).astype(np.float32))
    d = StemDesc(w, b)
    pieces = 1 if dtype == torch.bfloat16 else 3
    o_pad = -(-o // 64) * 64
    assert d.wk.shape == (pieces, o_pad, KP) and d.wk.dtype == torch.bfloat16
    assert d.wk.is_contiguous() and (d.o, d.o_pad, d.c) == (o, o_pad, c)
    want = split_pieces(w)[:pieces]
    back = torch.zeros((7, 7, c, o), dtype=torch.float64)
    seen = set()
    for k in range(KP):
        tap, ch = k_tap_channel(k)
        seen.add((tap, ch))
        if tap >= 49 or ch >= c:
            assert not d.wk[:, :, k].float().any(), k  # padding is zero
        else:
            ky, kx = divmod(tap, 7)
            assert torch.equal(d.wk[:, :o, k], want[:, ky, kx, ch, :]), k
            back[ky, kx, ch] = d.wk[:, :o, k].double().sum(0)
    assert seen == {(t, ch) for t in range(52) for ch in range(4)}
    assert not d.wk[:, o:].float().any()
    # the pieces sum back to the weights
    np.testing.assert_array_equal(back.numpy(), w.double().numpy())
    assert d.bias_f32.dtype == torch.float32 and d.bias_f32.shape == (o_pad,)
    assert torch.equal(d.bias_f32[:o], b) and not d.bias_f32[o:].any()


@pytest.mark.parametrize("x_dtype,w_dtype,n", [
    (torch.bfloat16, torch.bfloat16, 1), (torch.bfloat16, torch.float32, 3),
    (torch.float32, torch.bfloat16, 3), (torch.float32, torch.float32, 6)])
def test_pass_list_by_dtype(x_dtype, w_dtype, n):
    passes = stem_passes(x_dtype, w_dtype)
    assert len(passes) == n and passes[0] == (0, 0)
    assert passes == tuple(p for p in PASSES if p in passes)  # fixed order
    assert all(i + j <= 2 for i, j in passes)                 # i + j <= 4, 1-based
    # the header's STEM_PASSES is the same list
    pairs = re.search(r"#define STEM_PASSES (.*)", _HEADER).group(1)
    assert tuple((int(a), int(b)) for a, b in
                 re.findall(r"\{(\d), (\d)\}", pairs)) == PASSES


def _emulated(x, desc):
    """The kernel's GEMM in float64: the window's 4-channel pixels in the
    kernel's K order (padding taps read tap 48), times the descriptor's
    pieces, over the pass list; then bias, relu and the pool."""
    n, h, w, c = x.shape
    xp = torch.zeros((n, h + 6, w + 6, 4), dtype=torch.float64)
    hc, wc = h // 2, w // 2
    xs = split_pieces(x) if x.dtype == torch.float32 else x[None]
    acc = torch.zeros((n, hc, wc, desc.o_pad), dtype=torch.float64)
    for i, j in stem_passes(x.dtype, desc.w.dtype):
        xp[:, 3:h + 3, 3:w + 3, :c] = xs[i].double()
        cols = []
        for k in range(KP):
            tap, ch = k_tap_channel(k)
            ky, kx = divmod(min(tap, 48), 7)
            cols.append(xp[:, ky:ky + 2 * hc:2, kx:kx + 2 * wc:2, ch])
        acc += torch.stack(cols, -1) @ desc.wk[j].double().t()
    y = acc[..., :desc.o].permute(0, 3, 1, 2)
    if desc.bias is not None:
        y = y + desc.bias.double().reshape(1, -1, 1, 1)
    return F.max_pool2d(torch.relu(y), 3, 2, 1).permute(0, 2, 3, 1)


@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16), (torch.float32, torch.float32)])
@pytest.mark.parametrize("c", [3, 1])
def test_k_order_and_passes_compute_the_conv(x_dtype, w_dtype, c):
    rng = np.random.RandomState(c)
    x = torch.from_numpy(rng.randn(2, 16, 24, c).astype(np.float32)).to(x_dtype)
    w = torch.from_numpy((0.1 * rng.randn(7, 7, c, 64)).astype(np.float32)).to(w_dtype)
    b = torch.from_numpy((0.1 * rng.randn(64)).astype(np.float32))
    d = StemDesc(w, b)
    got = _emulated(x, d)
    y = F.conv2d(x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1),
                 b.double(), stride=2, padding=3)
    want = F.max_pool2d(torch.relu(y), 3, 2, 1).permute(0, 2, 3, 1)
    # one operand in bf16: every product is exact; f32 x f32 drops the
    # pieces' products below 2^-24 of a product
    tol = 1e-6 if (x_dtype, w_dtype) == (torch.float32, torch.float32) else 1e-12
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=tol)


def _banks_ways(pitch):
    """Worst bank conflict (ways) of the window loads of a row tile, the
    window `pitch` pixels a row, by the kernel's lane addressing: lane
    (g, u) loads 64 bits, pixel 2 * (g + 8n) + tap offset of tap 4s + u
    (padding taps read tap 48); 64-bit loads conflict within a half-warp."""
    worst = 1
    for s in range(13):
        for n in range(2):
            for half in range(2):
                banks = {}
                for lane in range(16 * half, 16 * half + 16):
                    g, u = lane >> 2, lane & 3
                    ky, kx = divmod(min(4 * s + u, 48), 7)
                    px = ky * pitch + kx + 2 * (g + 8 * n)
                    for word in (2 * px, 2 * px + 1):
                        banks.setdefault(word % 32, set()).add(word)
                worst = max(worst, max(len(v) for v in banks.values()))
    return worst


def test_window_reads_are_conflict_free():
    ks, nc = int(_header_const("KS")), int(_header_const("NC"))
    assert (ks, nc, int(_header_const("KSTEPS"))) == (7, 16, 13)
    assert _header_const("WIN_COLS") == "2 * (NC - 1) + KS"
    pitch = int(_header_const("WIN_W"))
    assert pitch >= 2 * (nc - 1) + ks
    assert _banks_ways(pitch) == 1
    # the probe sees conflicts where they are: every other pitch from the
    # 37 pixels a row needs to 47 conflicts 2-way
    assert [_banks_ways(p) for p in range(37, 48) if p != pitch] == [2] * 10


def test_fused_stem_desc_is_kept_and_rebuilt():
    """The stem's kernel layout that the operator's CUDA implementation
    reads for FusedStem's weights (``kept_stem``) is made once, and made
    again after an in-place update, a cast, a replacement or a move."""
    torch.manual_seed(0)
    conv = nn.Conv2d(3, 64, 7, 2, 3)
    stem = FusedStem(conv)
    d1 = kept_stem(*stem.weights())
    assert kept_stem(*stem.weights()) is d1
    assert stem.weights()[0].data_ptr() == conv.weight.data_ptr()
    with torch.no_grad():  # an in-place update bumps the version
        conv.weight.mul_(2.0)
    d2 = kept_stem(*stem.weights())
    assert d2 is not d1
    assert torch.equal(d2.wk, StemDesc(conv.weight.detach().permute(2, 3, 1, 0)).wk)
    with torch.no_grad():
        conv.bias.add_(1.0)
    d3 = kept_stem(*stem.weights())
    assert d3 is not d2 and torch.equal(d3.bias_f32, conv.bias.detach())
    stem.to(torch.bfloat16)  # a cast
    d4 = kept_stem(*stem.weights())
    assert d4 is not d3 and d4.wk.shape[0] == 1
    assert stem.weights()[0].dtype == torch.bfloat16
    conv.weight = nn.Parameter(conv.weight.detach().float())  # replaced, not cast
    d5 = kept_stem(*stem.weights())
    assert d5 is not d4 and d5.wk.shape[0] == 3
    stem.to("meta")  # a device move
    d6 = kept_stem(*stem.weights())
    assert d6 is not d5 and d6.wk.device.type == "meta"


def test_cpu_path_is_the_plain_version():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 32, 28, 3).astype(np.float32))
    w = torch.from_numpy((0.1 * rng.randn(7, 7, 3, 64)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.randn(64)).astype(np.float32))
    before = fused_stem.launches
    want = fused_stem_reference(x, w, b)
    assert torch.equal(fused_stem(x, w, b), want)
    assert torch.equal(StemDesc(w, b)(x), want)
    conv = nn.Conv2d(3, 64, 7, 2, 3)
    with torch.no_grad():
        conv.weight.copy_(w.permute(3, 2, 0, 1))
        conv.bias.copy_(b)
    y = FusedStem(conv)(x.permute(0, 3, 1, 2))
    assert torch.equal(y.permute(0, 2, 3, 1), want)
    assert fused_stem.launches == before


_STEM_CASES = {
    # entry point -> the small geometry its own branch takes
    "v3": (jstem.fused_stem_v3, (2, 32, 32, 3)),
    "v2": (jstem.fused_stem_v2, (1, 32, 28, 3)),
    "v1": (jstem.fused_stem, (2, 24, 20, 3)),
}


def _bf16_ulp(v):
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("entry", sorted(_STEM_CASES))
def test_plain_version_matches_jax_kernels(entry, dtype):
    jfn, shape = _STEM_CASES[entry]
    rng = np.random.RandomState(len(entry) + shape[2] + len(dtype))
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(7, 7, shape[3], 64) * 0.1).astype(np.float32)
    b = (rng.randn(64) * 0.1).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jfn(jnp.asarray(x, jd), jnp.asarray(w, jd), jnp.asarray(b),
                          interpret=True).astype(jnp.float32))
    got = fused_stem_reference(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
                               torch.from_numpy(b))
    assert got.dtype == td and got.shape == want.shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        # both round an f32 sum to bf16: one bf16 ulp of each other
        ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
        assert np.all(np.abs(got - want) <= ulp)
