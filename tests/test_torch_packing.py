"""bnn_tpu_torch.kernels.packing against bnn_tpu.kernels.packing: the words
must be equal bit for bit (int32 in the port, uint32 in JAX)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_tpu.kernels import packing as jpacking
from bnn_tpu_torch.kernels import packing


def _signs_with_zeros(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    x[rng.rand(*shape) < 0.2] = 0.0  # exact zeros pack as +1
    return x


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("k", [1, 31, 32, 33, 256, 577])
def test_pack_bits_equals_jax(k, axis):
    rng = np.random.RandomState(k * 2 + axis)
    shape = (k, 5) if axis == 0 else (5, k)
    x = _signs_with_zeros(rng, shape)
    want = np.asarray(jpacking.pack_bits(jnp.asarray(x), axis=axis))
    got = packing.pack_bits(torch.from_numpy(x), axis=axis)
    assert got.dtype == torch.int32
    assert got.shape[axis] == packing.packed_words(k) == jpacking.packed_words(k)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)

    unpacked = packing.unpack_bits(got, k, axis=axis).numpy()
    want_unpacked = np.asarray(jpacking.unpack_bits(jnp.asarray(want), k, axis=axis))
    np.testing.assert_array_equal(unpacked, want_unpacked)
    # the pad past k unpacks to exactly 0, the rest to sign with sign(0) = +1
    idx = [slice(None)] * 2
    idx[axis] = slice(0, k)
    np.testing.assert_array_equal(unpacked[tuple(idx)], np.where(x >= 0, 1.0, -1.0))


def test_bit31_unpacks_positive():
    """An int32 right shift sign-extends bit 31; the unpack must mask it."""
    x = -torch.ones(32, 1)
    x[31] = 1.0
    words = packing.pack_bits(x, axis=0)
    assert words.item() == -(2 ** 31)
    u = packing.unpack_bits(words, 32, axis=0, dtype=torch.int8)
    np.testing.assert_array_equal(u[:, 0].numpy(), [-1] * 31 + [1])
