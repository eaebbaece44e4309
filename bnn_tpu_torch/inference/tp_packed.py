"""Packed-activation tensor-parallel serving with overlapped transport
(counterpart of ``bnn_tpu/inference/tp_packed.py``).

Binary activations cross ranks as packed 32-bit words (1 bit an element,
1/32 of an f32 gather's bytes) on a ring whose hops overlap the partial
popcount products. For a chain of binary dense layers over P ranks of the
``model`` axis:

- every layer's packed weights are out-channel sharded: rank p holds all
  ``Kw`` packed rows of its ``N / P`` columns and the matching
  ``scale`` / ``add`` slice;
- after layer ``l`` rank p holds the sign bits of its own out-shard, which
  is chunk p of layer ``l + 1``'s reduction axis; no gather makes the whole
  activation;
- each layer runs a K-chunk ring: at step s rank p holds the chunk of rank
  ``(p - s) mod P``; it posts the hop of that chunk to its successor
  (``batch_isend_irecv``), computes the chunk's mismatch counts against the
  matching ``Kw / P`` weight rows, then waits for the hop. After P steps
  ``dot = K - 2 * mismatches`` for its out-shard; the epilogue, sign and pack
  make the next chunk in place. Only the last layer's float output is
  all-gathered.

The words are JAX's uint32 bits held as int32 (``kernels/packing.py``);
sign(0) = +1. The mismatch counts are exact integers and the epilogue is
rounded once, as XLA's fused multiply-add is, so the chain is bit-exact
against :func:`reference_chain` and against JAX's. The partial
products are plain torch (an XOR and the port's popcount over the words),
as JAX's are ``jnp``, not Pallas.

:attr:`transport` of the returned function records what each call hands
its collectives: one entry a layer for the ring (int32, the bytes this rank
receives, :func:`ici_bytes_per_layer`'s ``packed_ring``) and one for the
final gather (f32).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.gemm import _popcount32
from ..kernels.packing import pack_bits, packed_words
from ..parallel.collectives import gather, group_ranks
from ..parallel.mesh import Mesh

__all__ = ["PackedTPLayer", "pack_chain_weights", "packed_tp_chain",
           "ici_bytes_per_layer", "reference_chain"]


class PackedTPLayer(NamedTuple):
    """One binary dense layer of a packed-TP chain (whole tensors)."""

    w_packed: torch.Tensor  # (Kw, N) int32: pack_bits(W, axis=-2)
    scale: torch.Tensor     # (N,) f32 epilogue multiplier
    add: torch.Tensor       # (N,) f32 epilogue addend
    k: int                  # true reduction length


def pack_chain_weights(weights: Sequence[np.ndarray],
                       scales: Optional[Sequence[np.ndarray]] = None,
                       adds: Optional[Sequence[np.ndarray]] = None
                       ) -> List[PackedTPLayer]:
    """Pack a chain of float ``(K, N)`` weight matrices into layers."""
    out = []
    for i, w in enumerate(weights):
        k, n = w.shape
        out.append(PackedTPLayer(
            w_packed=pack_bits(torch.as_tensor(np.asarray(w)), axis=-2),
            scale=torch.as_tensor(np.asarray(scales[i] if scales is not None
                                             else np.ones(n)), dtype=torch.float32),
            add=torch.as_tensor(np.asarray(adds[i] if adds is not None
                                           else np.zeros(n)), dtype=torch.float32),
            k=k))
    return out


def _check_chain(layers: Sequence[PackedTPLayer], p: int) -> None:
    # raises, not asserts: a mis-sized chain would otherwise slice 0 weight
    # rows a rank and return wrong numbers (dot == K) of the right shapes
    for i, l in enumerate(layers):
        kw, n = l.w_packed.shape
        if kw != packed_words(l.k):
            raise ValueError(
                f"layer {i}: packed rows {kw} != packed_words(K={l.k})")
        if l.k % (32 * p) != 0:
            raise ValueError(
                f"layer {i}: K={l.k} must split into {p} whole-word "
                f"chunks (multiple of {32 * p})")
        if i + 1 < len(layers):
            if n != layers[i + 1].k:
                raise ValueError(
                    f"layer {i} out {n} != layer {i + 1} K {layers[i + 1].k}")
            if n % (32 * p) != 0:
                raise ValueError(
                    f"layer {i}: out {n} must be a multiple of {32 * p} "
                    f"to repack into {p} whole-word chunks")
        elif n % p != 0:
            raise ValueError(f"final layer out {n} must divide over {p} chips")


def _mismatch_chunk(xbits: torch.Tensor, wbits: torch.Tensor) -> torch.Tensor:
    """``(M, Kw') x (Kw', N') -> `` int32 mismatch counts, popcount(XOR)
    summed over the words, one word row at a time."""
    mask = 0xFFFFFFFF
    xw = xbits.to(torch.int64) & mask
    ww = wbits.to(torch.int64) & mask
    mism = torch.zeros((xw.shape[0], ww.shape[1]), dtype=torch.int64,
                       device=xw.device)
    for i in range(ww.shape[0]):
        mism += _popcount32(xw[:, i, None] ^ ww[None, i, :])
    return mism.to(torch.int32)


def ici_bytes_per_layer(m: int, k: int, p: int) -> dict:
    """Bytes one rank receives for one layer's activation transport: the
    packed ring against an f32 all-gather of the same activation. Defined
    only where the chain is (``k`` a multiple of ``32 * p``)."""
    if k % (32 * p) != 0:
        raise ValueError(
            f"K={k} is not packed-TP-legal for p={p} (needs a multiple "
            f"of {32 * p}; the chain itself would reject it)")
    packed = (p - 1) * m * (packed_words(k) // p) * 4  # 32-bit words
    f32_gather = (p - 1) * m * (k // p) * 4
    return {"packed_ring": packed, "f32_all_gather": f32_gather,
            "ratio": f32_gather / packed}


def _epilogue(mism: torch.Tensor, k: int, scale, add) -> torch.Tensor:
    """``dot * scale + add`` rounded to f32 once, as XLA's fused multiply-add
    rounds JAX's: in f64 the product of an integer under 2**24 and an f32
    is exact, and so is its sum with an f32 of a near exponent."""
    dot = (k - 2 * mism).to(torch.float64)
    return (dot * scale.to(torch.float64)[None, :]
            + add.to(torch.float64)[None, :]).to(torch.float32)


def packed_tp_chain(layers: Sequence[PackedTPLayer], mesh: Mesh, axis: str = "model"):
    """A packed-activation tensor-parallel forward of a binary dense chain:
    ``fn(x) -> logits`` for the float input ``(M, K0)`` (the same on every
    rank of ``axis``), returning the whole ``(M, N_last)`` f32 output on
    every rank. Each rank keeps only its out-channel shard of every layer."""
    p = mesh.size(axis)
    _check_chain(layers, p)
    me = mesh.index(axis)
    group = mesh.group(axis)
    ranks = group_ranks(group)
    succ, pred = ranks[(me + 1) % p], ranks[(me - 1) % p]
    dev = mesh.device
    local = []
    for l in layers:
        n_local = l.w_packed.shape[1] // p
        cols = slice(me * n_local, (me + 1) * n_local)
        local.append((l.w_packed[:, cols].contiguous().to(dev),
                      l.scale[cols].to(dev), l.add[cols].to(dev), l.k))

    def forward(x: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x).to(dev)
        record = []
        xbits = pack_bits(x, axis=-1)                      # (M, Kw0)
        chunk0 = xbits.shape[1] // p
        xb = xbits[:, me * chunk0:(me + 1) * chunk0].contiguous()
        for li, (wp, scale, add, k) in enumerate(local):
            chunk = packed_words(k) // p
            mism = torch.zeros((xb.shape[0], wp.shape[1]), dtype=torch.int32,
                               device=dev)
            for s in range(p):
                src = (me - s) % p  # the rank whose chunk this is
                works = []
                if s + 1 < p:  # post the next hop before the partial product
                    nxt = torch.empty_like(xb)
                    works = dist.batch_isend_irecv([
                        dist.P2POp(dist.isend, xb, succ, group),
                        dist.P2POp(dist.irecv, nxt, pred, group)])
                    record.append({"layer": li, "collective": "ring",
                                   "dtype": xb.dtype,
                                   "bytes": nxt.numel() * nxt.element_size()})
                mism += _mismatch_chunk(xb, wp[src * chunk:(src + 1) * chunk])
                for w in works:
                    w.wait()
                if s + 1 < p:
                    xb = nxt
            y = _epilogue(mism, k, scale, add)
            if li + 1 < len(local):
                # this rank's out-shard IS chunk `me` of the next K
                xb = pack_bits(y, axis=-1)
            else:
                record.append({"layer": li, "collective": "all_gather",
                               "dtype": y.dtype,
                               "bytes": (p - 1) * y.numel() * y.element_size()})
                forward.transport = _per_layer(record)
                return gather(y, group, 1)

    forward.transport = []
    return forward


def _per_layer(record: list) -> list:
    """Sum the ring hops of each layer into one entry."""
    out = []
    for r in record:
        if out and out[-1]["layer"] == r["layer"] and out[-1]["collective"] == r["collective"]:
            out[-1]["bytes"] += r["bytes"]
        else:
            out.append(dict(r))
    return out


def reference_chain(layers: Sequence[PackedTPLayer]):
    """The single-device oracle: the same integer mismatch arithmetic, no
    sharding, so :func:`packed_tp_chain` must match it bit for bit."""

    def forward(x: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x)
        xbits = pack_bits(x, axis=-1)
        for li, l in enumerate(layers):
            dev = xbits.device
            mism = _mismatch_chunk(xbits, l.w_packed.to(dev))
            y = _epilogue(mism, l.k, l.scale.to(dev), l.add.to(dev))
            if li + 1 < len(layers):
                xbits = pack_bits(y, axis=-1)
            else:
                return y

    return forward
