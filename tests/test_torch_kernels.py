"""The port's kernel modules against the JAX kernels.

The JAX Pallas kernels run in interpret mode, as tests/test_kernels.py and
tests/test_stem.py run them; the port takes its plain versions, as its
wrappers do for CPU tensors. The CUDA kernels themselves are held against
the plain versions on the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_tpu.kernels import gemm as jgemm
from bnn_tpu.kernels import stem as jstem
from bnn_tpu.kernels.packing import pack_bits as jpack_bits
from bnn_tpu_torch.kernels import (binary_gemm, binary_gemm_reference,
                                   fused_stem, fused_stem_reference, pack_bits)
from bnn_tpu_torch.kernels import stem as tstem
from bnn_tpu_torch.kernels.gemm import GEMM_TILES, binary_gemm_planned, gemm_plan


def _gemm_inputs(m, k, n, sign_inputs, seed):
    rng = np.random.RandomState(seed)
    if sign_inputs:
        x = rng.randn(m, k).astype(np.float32)
        x[rng.rand(m, k) < 0.15] = 0.0  # exact zeros sign to +1
    else:
        x = rng.randint(-1, 2, (m, k)).astype(np.float32)  # ternary
    w = rng.randn(k, n).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, n).astype(np.float32)
    add = rng.randn(n).astype(np.float32)
    return x, w, scale, add


@pytest.mark.parametrize("sign_inputs", [True, False])
@pytest.mark.parametrize("m,k,n", [(37, 77, 65), (8, 256, 130), (5, 33, 7)])
def test_binary_gemm_matches_jax_kernel(m, k, n, sign_inputs):
    x, w, scale, add = _gemm_inputs(m, k, n, sign_inputs, seed=m + k + n)
    wp_j = jpack_bits(jnp.asarray(w), axis=-2)
    wp_t = pack_bits(torch.from_numpy(w), axis=-2)
    np.testing.assert_array_equal(wp_t.numpy().view(np.uint32), np.asarray(wp_j))

    # the integer part (scale 1, add 0) is exact
    acc_j = np.asarray(jgemm.binary_gemm(
        jnp.asarray(x), wp_j, k, jnp.ones(n), jnp.zeros(n),
        sign_inputs=sign_inputs, interpret=True))
    acc_t = binary_gemm_reference(torch.from_numpy(x), wp_t, k,
                                  sign_inputs=sign_inputs).numpy()
    np.testing.assert_array_equal(acc_t, acc_j)
    xs = np.where(x >= 0, 1.0, -1.0) if sign_inputs else x
    np.testing.assert_array_equal(acc_t, xs @ np.where(w >= 0, 1.0, -1.0))

    got = binary_gemm_reference(torch.from_numpy(x), wp_t, k,
                                torch.from_numpy(scale), torch.from_numpy(add),
                                sign_inputs=sign_inputs).numpy()
    want = np.asarray(jgemm.binary_gemm(
        jnp.asarray(x), wp_j, k, jnp.asarray(scale), jnp.asarray(add),
        sign_inputs=sign_inputs, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_binary_gemm_wrapper_takes_plain_version_on_cpu():
    x, w, scale, add = _gemm_inputs(9, 40, 12, True, seed=3)
    args = (torch.from_numpy(x), pack_bits(torch.from_numpy(w), axis=-2), 40,
            torch.from_numpy(scale), torch.from_numpy(add))
    before = binary_gemm.launches
    np.testing.assert_array_equal(binary_gemm(*args).numpy(),
                                  binary_gemm_reference(*args).numpy())
    assert binary_gemm.launches == before  # no kernel launched on the CPU


def test_binary_gemm_rejects_bad_shapes():
    wp = pack_bits(torch.randn(40, 12), axis=-2)
    with pytest.raises(ValueError):
        binary_gemm(torch.randn(9, 70), wp, 70)  # 3 words, not 2
    with pytest.raises(ValueError):
        binary_gemm(torch.randn(9, 40), wp, 40, torch.ones(11))


@pytest.mark.parametrize("m,n,tile,blocks", [
    (196, 512, 32, 112),     # ResNet-50 layer4.0.conv1 at batch 1: 32 blocks of 64x64
    (392, 512, 32, 208),     # ResNet-18 layer4.0's shortcut at batch 8: 56 of 64x64
    (49, 2048, 32, 128),     # ResNet-50 layer4's conv3 at batch 1
    (196, 1024, 32, 224),    # 64 blocks of 64x64: under half a wave
    (784, 512, 64, 104),     # ResNet-50 layer3's conv1 at batch 4
    (3136, 128, 64, 98),     # ResNet-50 layer2's conv1 at batch 1
    (25088, 64, 64, 392),    # ResNet-50 layer1's conv1 at batch 8
    (6272, 128, 64, 196),    # ResNet-50 layer2's conv1 at batch 8
    (1, 7, 32, 1),
])
def test_gemm_plan_takes_the_largest_tile_that_fills_half_the_card(m, n, tile, blocks):
    """binary_gemm's grid: the largest tile whose grid reaches half a wave
    of the H100's 132 SMs (66 blocks), else the smallest."""
    got, _ = gemm_plan(m, 256, n, 2, 0, 0)
    assert got == tile and got in GEMM_TILES
    assert -(-m // tile) * -(-n // tile) == blocks
    if tile != GEMM_TILES[-1]:
        assert blocks >= 66
    else:
        big = GEMM_TILES[0]
        assert -(-m // big) * -(-n // big) < 66
    assert gemm_plan(m, 256, n, 2, 0, 0, sms=10 ** 9)[0] == GEMM_TILES[-1]


@pytest.mark.parametrize("k,n,itemsize,x_off,w_off,loader", [
    (256, 512, 2, 0, 0, "vector"),
    (40, 12, 2, 0, 0, "vector"),     # 80 bytes a row
    (40, 12, 4, 0, 0, "vector"),
    (70, 12, 2, 0, 0, "scalar"),     # K % 8 != 0 in bf16
    (70, 12, 4, 0, 0, "scalar"),     # K % 4 != 0 in f32
    (33, 64, 4, 0, 0, "scalar"),
    (256, 65, 2, 0, 0, "scalar"),    # N % 4 != 0
    (256, 7, 4, 0, 0, "scalar"),
    (256, 512, 2, 2, 0, "scalar"),   # x off 16 bytes (a row view)
    (256, 512, 2, 16, 0, "vector"),
    (256, 512, 2, 0, 4, "scalar"),   # words off 16 bytes
])
def test_gemm_plan_vector_loader_only_where_16_byte_copies_fit(k, n, itemsize, x_off,
                                                               w_off, loader):
    base = 1 << 20
    assert gemm_plan(392, k, n, itemsize, base + x_off, base + w_off)[1] == loader


def test_binary_gemm_planned_launches_only_on_the_card():
    x, w, _, _ = _gemm_inputs(9, 40, 12, True, seed=5)
    args = (torch.from_numpy(x), pack_bits(torch.from_numpy(w), axis=-2), 40)
    with pytest.raises(ValueError, match="CUDA"):
        binary_gemm_planned(*args, plan=(32, "scalar"))
    with pytest.raises(ValueError, match="shape mismatch"):
        binary_gemm_planned(torch.zeros(9, 70), args[1], 70)  # 3 words, not 2


_STEM_CASES = {
    # entry point -> the small geometry its own branch takes
    "v3": (jstem.fused_stem_v3, (2, 32, 32, 3)),
    "v2": (jstem.fused_stem_v2, (1, 32, 28, 3)),
    "v1": (jstem.fused_stem, (2, 24, 20, 3)),
}


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("entry", sorted(_STEM_CASES))
def test_fused_stem_matches_jax_kernel(entry, bias):
    jfn, shape = _STEM_CASES[entry]
    rng = np.random.RandomState(len(entry) + shape[2])
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(7, 7, shape[3], 64) * 0.1).astype(np.float32)
    b = (rng.randn(64) * 0.1).astype(np.float32) if bias else None
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(w),
                          None if b is None else jnp.asarray(b), interpret=True))
    bt = None if b is None else torch.from_numpy(b)
    got = fused_stem_reference(torch.from_numpy(x), torch.from_numpy(w), bt)
    assert got.shape == (shape[0], shape[1] // 4, shape[2] // 4, 64)
    # summation order differs: the tolerance tests/test_stem.py uses
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    before = fused_stem.launches
    np.testing.assert_array_equal(
        fused_stem(torch.from_numpy(x), torch.from_numpy(w), bt).numpy(),
        got.numpy())
    assert fused_stem.launches == before


@pytest.mark.parametrize("shape", [(1, 20, 16, 3), (1, 16, 18, 3), (1, 16, 16, 5)])
def test_fused_stem_rejects_unsupported_geometry(shape):
    with pytest.raises(ValueError):
        fused_stem(torch.zeros(shape), torch.zeros(7, 7, shape[3], 64))


def _stem_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(7, 7, shape[3], 64) * 0.1).astype(np.float32)
    b = (rng.randn(64) * 0.1).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("entry,shape", [("fused_stem_v2", (1, 32, 32, 3)),
                                         ("fused_stem_v3", (1, 32, 32, 3)),
                                         ("fused_stem_v3", (2, 32, 32, 3))])
def test_stem_entry_point_matches_its_jax_kernel(entry, shape):
    """The port's v2 / v3 entry points against JAX's kernels of the same
    name in interpret mode, as tests/test_stem.py runs them; their CPU calls
    launch nothing."""
    x, w, b = _stem_inputs(shape, seed=shape[0] + len(entry))
    want = np.asarray(getattr(jstem, entry)(jnp.asarray(x), jnp.asarray(w),
                                            jnp.asarray(b), interpret=True))
    before = fused_stem.launches
    got = getattr(tstem, entry)(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b))
    assert fused_stem.launches == before
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("entry", ["fused_stem", "fused_stem_v2", "fused_stem_v3"])
def test_stem_out_dtype_matches_jax_reference(entry):
    """bf16-valued x stored as f32: against JAX's fused_stem_reference with
    ``out_dtype=jnp.float32`` (f32 sums in another order, 1e-5); without
    ``out_dtype`` the output keeps x's bf16."""
    x, w, b = _stem_inputs((1, 32, 32, 3), seed=9)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jstem.fused_stem_reference(xj, jnp.asarray(w), jnp.asarray(b),
                                                 out_dtype=jnp.float32))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    got = getattr(tstem, entry)(xt, wt, bt, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    ref = fused_stem_reference(xt, wt, bt, out_dtype=torch.float32)
    np.testing.assert_array_equal(ref.numpy(), got.numpy())
    assert getattr(tstem, entry)(xt, wt, bt).dtype == torch.bfloat16


@pytest.mark.parametrize("entry,shape", [("fused_stem_v2", (2, 32, 32, 3)),
                                         ("fused_stem_v2", (1, 24, 32, 3)),
                                         ("fused_stem_v3", (1, 32, 28, 3)),
                                         ("fused_stem_v3", (2, 24, 32, 3))])
def test_stem_entry_points_refuse_shapes_outside_their_scope(entry, shape):
    with pytest.raises(ValueError, match=entry):
        getattr(tstem, entry)(torch.zeros(shape), torch.zeros(7, 7, 3, 64))
