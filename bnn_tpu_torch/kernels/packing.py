"""Bitpacking: sign bits -> 32-bit words (counterpart of
``bnn_tpu/kernels/packing.py``).

Bit ``j`` of word ``w`` is ``x[w*32 + j] >= 0`` (``sign(0) == +1``), and the
pad bits past ``k`` are 0. The JAX package stores uint32 words; torch has
little uint32 support, so the port stores the same 32 bits as int32 (compare
the two with ``.view``). An int32 right shift sign-extends bit 31, so every
unpack masks with ``& 1`` after the shift.
"""
from __future__ import annotations

import torch

__all__ = ["pack_bits", "unpack_bits", "packed_words"]


def packed_words(k: int) -> int:
    """Number of 32-bit words needed to pack ``k`` bits."""
    return -(-k // 32)


def _bit_shape(ndim: int, axis: int):
    # broadcast shape of the 32 bit positions, on the axis after ``axis``
    return (1,) * (axis + 1) + (32,) + (1,) * (ndim - axis - 1)


def pack_bits(x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Pack the sign bits of ``x`` along ``axis`` into int32 words.

    Returns a tensor with ``shape[axis] == ceil(K / 32)``; for a ``(K, N)``
    weight matrix the default packs the reduction axis.
    """
    axis = axis % x.ndim
    k = x.shape[axis]
    words = packed_words(k)
    bits = (x >= 0).to(torch.int64)
    if words * 32 != k:
        pad_shape = list(bits.shape)
        pad_shape[axis] = words * 32 - k
        bits = torch.cat([bits, bits.new_zeros(pad_shape)], dim=axis)
    bits = bits.reshape(bits.shape[:axis] + (words, 32) + bits.shape[axis + 1:])
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)
    u32 = (bits << shifts.reshape(_bit_shape(x.ndim, axis))).sum(dim=axis + 1)
    # reinterpret the unsigned 32-bit value as int32 (two's complement)
    return torch.where(u32 >= 2 ** 31, u32 - 2 ** 32, u32).to(torch.int32)


def unpack_bits(packed: torch.Tensor, k: int, axis: int = -2,
                dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: words -> ``+/-1`` values along ``axis``
    (``words * 32`` long), with the pad past ``k`` set to exactly 0."""
    axis = axis % packed.ndim
    words = packed.shape[axis]
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32).unsqueeze(axis + 1)
            >> shifts.reshape(_bit_shape(packed.ndim, axis))) & 1
    values = (2 * bits - 1).to(dtype)
    values = values.reshape(packed.shape[:axis] + (words * 32,)
                            + packed.shape[axis + 1:])
    if words * 32 != k:
        idx = torch.arange(words * 32, device=packed.device).reshape(
            (1,) * axis + (-1,) + (1,) * (packed.ndim - axis - 1))
        values = torch.where(idx < k, values, torch.zeros_like(values))
    return values
