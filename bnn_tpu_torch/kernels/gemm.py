"""Binary GEMM over bit-packed weights (counterpart of
``bnn_tpu/kernels/gemm.py``).

:func:`binary_gemm` calls the ``bnn_tpu_torch::binary_gemm`` operator
(``kernels/ops.py``), which launches the hand-written Hopper kernel
``bnn_tpu_torch/csrc/binary_gemm.cu`` for CUDA tensors and takes
:func:`binary_gemm_reference`, its plain version, only for CPU tensors.

Contract: ``out = (s(x) @ unpack(w_packed)[:K]) * scale + add`` in f32, with
``s(x) = x >= 0 ? +1 : -1`` when ``sign_inputs``, else x already ternary
{-1, 0, +1}. The dot is exact; the epilogue rounds the product and the sum
separately, so kernel and plain version agree bit for bit.

Bound on an H100 at the main-path shape (M=392, K=256, N=512, bf16 x): about
1.0 MB moved, 0.3 us at 3.35 TB/s, against 0.05 us of int8 work, so the
layer is bound by bytes and in practice by its launch. The kernel runs the
int8 tensor cores (``mma.sync`` s8 tiles) on weights that stay packed (1 bit
each) until they reach the registers. :func:`gemm_plan` is its host plan:
the output tile (64 or 32 a side, the larger whose grid fills half a wave
of the card's SMs) and the loader (16-byte asynchronous copies where K, N and
the pointers allow them, else element by element).

:func:`popcount_gemm` is the XNOR / popcount form over packed activations
AND packed weights, ``(K - 2 * sum popcount(xp ^ wp)) * scale + add``: the
kernel ``bnn_tpu_torch/csrc/popcount_gemm.cu`` for CUDA tensors, the plain
version :func:`popcount_gemm_reference` for CPU tensors, through the
``bnn_tpu_torch::popcount_gemm`` operator. The pad bits past K
are 0 in both operands and cancel. The kernel runs 1-bit tensor-core
products (``mma.sync`` m16n8k256 ``.and.popc``, the mismatches as
``popc(x & ~w) + popc(~x & w)``) on the packed words; it is bound by its f32
output. :func:`popcount_plan` is its host plan: the output tile (the
half-wave rule of :func:`gemm_plan`), the loader and the K split over warp
groups of a block.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ._build import load
from .packing import packed_words, unpack_bits

__all__ = ["binary_gemm", "binary_gemm_planned", "binary_gemm_reference",
           "gemm_plan", "popcount_gemm", "popcount_gemm_planned",
           "popcount_gemm_reference", "popcount_plan"]

_X_DTYPES = (torch.float32, torch.bfloat16)
# output rows and columns per block of binary_gemm.cu's instances, largest first
GEMM_TILES = (64, 32)
H100_SMS = 132


def gemm_plan(m: int, k: int, n: int, x_itemsize: int, x_ptr: int,
              w_ptr: int, sms: int = H100_SMS) -> Tuple[int, str]:
    """``(tile, loader)`` of a :func:`binary_gemm` launch.

    ``tile``: the largest of :data:`GEMM_TILES` whose grid of ``tile x tile``
    output blocks has at least half a wave (``sms / 2`` blocks), else the
    smallest. On the H100 a 64x64 grid of 100 blocks or more ran faster than
    the 32x32 grid of the same product, one of 98 tied with it, and one of
    64 or fewer ran slower (``chip_smoke.py`` phase 4 times both).
    ``loader``: ``"vector"`` (16-byte copies) when every x row and every word
    row starts on 16 bytes (K a multiple of 16 bytes of x, N of 4 words, both
    pointers aligned), else ``"scalar"``.
    """
    tile = next((t for t in GEMM_TILES
                 if 2 * (-(-m // t) * -(-n // t)) >= sms), GEMM_TILES[-1])
    vector = (k * x_itemsize % 16 == 0 and n % 4 == 0 and x_ptr % 16 == 0
              and w_ptr % 16 == 0)
    return tile, "vector" if vector else "scalar"


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _epilogue_operand(v: Optional[torch.Tensor], n: int, fill: float,
                      device) -> torch.Tensor:
    if v is None:
        return torch.full((n,), fill, dtype=torch.float32, device=device)
    return v.to(device=device, dtype=torch.float32).contiguous()


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of ``csrc/binary_gemm.cu``, built at first use."""
    fn = load("binary_gemm").bnn_binary_gemm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def _check_shapes(x, w_packed, k, scale, add):
    """``(M, N)`` of a product, or a ValueError naming what disagrees."""
    if x.ndim != 2 or w_packed.ndim != 2:
        raise ValueError(f"expected 2-D x and w_packed, got {tuple(x.shape)} "
                         f"and {tuple(w_packed.shape)}")
    m, k_in = x.shape
    kw, n = w_packed.shape
    if k_in != k or kw != packed_words(k):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w_packed "
                         f"{tuple(w_packed.shape)}, k={k}")
    for v in (scale, add):
        if v is not None and tuple(v.shape) != (n,):
            raise ValueError(f"epilogue operands must have shape ({n},), got "
                             f"{tuple(v.shape)}")
    return m, n


def binary_gemm(x: torch.Tensor, w_packed: torch.Tensor, k: int,
                scale: Optional[torch.Tensor] = None,
                add: Optional[torch.Tensor] = None, *,
                sign_inputs: bool = True) -> torch.Tensor:
    """``s(x) @ unpack(w_packed)[:k] * scale + add`` as one kernel: the
    ``bnn_tpu_torch::binary_gemm`` operator (``kernels/ops.py``), whose CUDA
    implementation is :func:`binary_gemm_planned` with the host's plan and
    whose CPU implementation is :func:`binary_gemm_reference`.

    Args:
        x: ``(M, K)`` activations, f32 or bf16.
        w_packed: ``(ceil(K/32), N)`` int32 words of
            :func:`~bnn_tpu_torch.kernels.packing.pack_bits` along axis -2.
        k: the true reduction length K.
        scale, add: ``(N,)`` per-out-channel epilogue (default 1 and 0).
    Returns:
        ``(M, N)`` f32.
    """
    _check_shapes(x, w_packed, k, scale, add)
    return torch.ops.bnn_tpu_torch.binary_gemm(x, w_packed, k, scale, add,
                                               sign_inputs)


def binary_gemm_planned(x: torch.Tensor, w_packed: torch.Tensor, k: int,
                        scale: Optional[torch.Tensor] = None,
                        add: Optional[torch.Tensor] = None, *,
                        sign_inputs: bool = True,
                        plan: Optional[Tuple[int, str]] = None) -> torch.Tensor:
    """:func:`binary_gemm`'s kernel on CUDA tensors, launched with ``plan``
    (``(tile, loader)``) in place of :func:`gemm_plan`'s, so that each
    instance can be held against the plain version. The vector loader is
    refused where :func:`gemm_plan` would not take it."""
    m, n = _check_shapes(x, w_packed, k, scale, add)
    if x.device.type != "cuda" or w_packed.device != x.device:
        raise ValueError(f"binary_gemm needs x and w_packed on one CUDA "
                         f"device, got {x.device} and {w_packed.device}")
    if x.dtype not in _X_DTYPES or w_packed.dtype != torch.int32:
        raise TypeError(f"binary_gemm takes f32/bf16 x and int32 w_packed, "
                        f"got {x.dtype} and {w_packed.dtype}")
    if not (x.is_contiguous() and w_packed.is_contiguous()):
        raise ValueError("binary_gemm needs contiguous x and w_packed")
    auto = gemm_plan(m, k, n, x.element_size(), x.data_ptr(),
                     w_packed.data_ptr(), _sm_count(x.device))
    tile, loader = plan or auto
    if tile not in GEMM_TILES or loader not in ("vector", "scalar") or (
            loader == "vector" and auto[1] != "vector"):
        raise ValueError(f"binary_gemm has no launch plan {plan!r} for x "
                         f"{tuple(x.shape)} and w_packed {tuple(w_packed.shape)}")
    scale = _epilogue_operand(scale, n, 1.0, x.device)
    add = _epilogue_operand(add, n, 0.0, x.device)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    err = _kernel()(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w_packed.data_ptr(),
        scale.data_ptr(), add.data_ptr(), out.data_ptr(), m, k, n,
        int(sign_inputs), tile, int(loader == "vector"),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"binary_gemm kernel launch failed: CUDA error {err}")
    binary_gemm.launches += 1
    return out


binary_gemm.launches = 0


def binary_gemm_reference(x: torch.Tensor, w_packed: torch.Tensor, k: int,
                          scale: Optional[torch.Tensor] = None,
                          add: Optional[torch.Tensor] = None, *,
                          sign_inputs: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`binary_gemm`: the dot in float64
    (exact for integer values), the epilogue in f32."""
    xs = torch.where(x >= 0, 1.0, -1.0) if sign_inputs else x
    w = unpack_bits(w_packed, k, axis=-2, dtype=torch.float64)[:k]
    out = (xs.to(torch.float64) @ w).to(torch.float32)
    if scale is not None:
        out = out * scale.to(torch.float32)
    if add is not None:
        out = out + add.to(torch.float32)
    return out


# popcount_gemm.cu's instances: output tile sides (largest first) and warp
# groups sharing K (most first); its words per chunk of K; the fewest chunks
# a warp group of a split is left to walk
POPCOUNT_TILES = (64, 32)
POPCOUNT_SPLITS = (4, 2, 1)
POPCOUNT_KWC = 8
POPCOUNT_MIN_CHUNKS = 2


def popcount_plan(m: int, kw: int, n: int, x_ptr: int, w_ptr: int,
                  sms: int = H100_SMS) -> Tuple[int, str, int]:
    """``(tile, loader, split)`` of a :func:`popcount_gemm` launch on
    ``(m, kw)`` activation words and ``(kw, n)`` weight words.

    ``tile``: the largest of :data:`POPCOUNT_TILES` whose grid has at least
    half a wave (``sms / 2`` blocks), else the smallest, as
    :func:`gemm_plan`. ``loader``: ``"vector"`` (8-byte copies of x word
    pairs, 16-byte copies of four weight columns, 16-byte output rows) when
    ``kw`` is even, ``n`` a multiple of 4 and the pointers aligned to 8 and
    16 bytes, else ``"scalar"``. ``split``: on the 32x32 tile only, the most
    warp groups of :data:`POPCOUNT_SPLITS` that leave each at least
    :data:`POPCOUNT_MIN_CHUNKS` chunks of :data:`POPCOUNT_KWC` words and put
    at most four warp groups per SM; else 1. On the H100 the split ran
    faster at most such shapes of a ResNet-50's pointwise convs and slower
    at every 64x64 one (``PERF.md``; ``chip_smoke.py`` phase 4 times every
    split beside the plan's).
    """
    def blocks(t):
        return -(-m // t) * -(-n // t)

    tile = next((t for t in POPCOUNT_TILES if 2 * blocks(t) >= sms),
                POPCOUNT_TILES[-1])
    chunks = -(-kw // POPCOUNT_KWC)
    split = next(s for s in POPCOUNT_SPLITS
                 if s == 1 or (tile == POPCOUNT_TILES[-1]
                               and chunks >= POPCOUNT_MIN_CHUNKS * s
                               and blocks(tile) * s <= 4 * sms))
    return tile, "vector" if _popcount_vector_ok(kw, n, x_ptr, w_ptr) else "scalar", split


def _popcount_vector_ok(kw: int, n: int, x_ptr: int, w_ptr: int) -> bool:
    """Whether every x word pair and every quad of weight columns can be
    copied whole: ``kw`` even, ``n`` a multiple of 4, x on 8 bytes and the
    weights on 16."""
    return kw % 2 == 0 and n % 4 == 0 and x_ptr % 8 == 0 and w_ptr % 16 == 0


@functools.lru_cache(maxsize=None)
def _popcount_kernel():
    """The C entry point of ``csrc/popcount_gemm.cu``, built at first use."""
    fn = load("popcount_gemm").bnn_popcount_gemm
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    return fn


def _popcount_check_shapes(x_packed, w_packed, k, scale, add):
    """``(M, N)`` of a popcount product, or a ValueError naming what
    disagrees."""
    if x_packed.ndim != 2 or w_packed.ndim != 2:
        raise ValueError(f"expected 2-D x_packed and w_packed, got "
                         f"{tuple(x_packed.shape)} and {tuple(w_packed.shape)}")
    m, kw_in = x_packed.shape
    kw, n = w_packed.shape
    if kw != packed_words(k) or kw_in != kw:
        raise ValueError(f"shape mismatch: x_packed {tuple(x_packed.shape)}, "
                         f"w_packed {tuple(w_packed.shape)}, k={k} needs "
                         f"{packed_words(k)} words")
    for v in (scale, add):
        if v is not None and tuple(v.shape) != (n,):
            raise ValueError(f"epilogue operands must have shape ({n},), got "
                             f"{tuple(v.shape)}")
    return m, n


def popcount_gemm(x_packed: torch.Tensor, w_packed: torch.Tensor, k: int,
                  scale: Optional[torch.Tensor] = None,
                  add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(k - 2 * popcount(x_packed XOR w_packed)) * scale + add``: the
    ``bnn_tpu_torch::popcount_gemm`` operator (``kernels/ops.py``), whose CUDA
    implementation is :func:`popcount_gemm_planned` with the host's plan and
    whose CPU implementation is :func:`popcount_gemm_reference`.

    Args:
        x_packed: ``(M, ceil(K/32))`` int32 words, :func:`pack_bits` of the
            activations along the last axis (sign(0) = +1).
        w_packed: ``(ceil(K/32), N)`` int32 words of the weights.
        k: the true reduction length K.
        scale, add: ``(N,)`` per-out-channel epilogue (default 1 and 0).
    Returns:
        ``(M, N)`` f32.
    """
    _popcount_check_shapes(x_packed, w_packed, k, scale, add)
    return torch.ops.bnn_tpu_torch.popcount_gemm(x_packed, w_packed, k, scale, add)


def popcount_gemm_planned(x_packed: torch.Tensor, w_packed: torch.Tensor,
                          k: int, scale: Optional[torch.Tensor] = None,
                          add: Optional[torch.Tensor] = None, *,
                          plan: Optional[Tuple[int, str, int]] = None
                          ) -> torch.Tensor:
    """:func:`popcount_gemm`'s kernel on CUDA tensors, launched with ``plan``
    (``(tile, loader, split)``) in place of :func:`popcount_plan`'s, so that
    each instance can be held against the plain version. A plan is refused
    where it names no instance or the vector loader cannot take the
    operands."""
    m, n = _popcount_check_shapes(x_packed, w_packed, k, scale, add)
    kw = w_packed.shape[0]
    if plan is not None:
        tile, loader, split = plan
        if (tile not in POPCOUNT_TILES or split not in POPCOUNT_SPLITS
                or loader not in ("vector", "scalar")
                or (loader == "vector" and not _popcount_vector_ok(
                    kw, n, x_packed.data_ptr(), w_packed.data_ptr()))):
            raise ValueError(f"popcount_gemm has no launch plan {plan!r} for "
                             f"x_packed {tuple(x_packed.shape)} and w_packed "
                             f"{tuple(w_packed.shape)}")
    if x_packed.device.type != "cuda" or w_packed.device != x_packed.device:
        raise ValueError(f"popcount_gemm needs x_packed and w_packed on one "
                         f"CUDA device, got {x_packed.device} and "
                         f"{w_packed.device}")
    if x_packed.dtype != torch.int32 or w_packed.dtype != torch.int32:
        raise TypeError(f"popcount_gemm takes int32 words, got "
                        f"{x_packed.dtype} and {w_packed.dtype}")
    if not (x_packed.is_contiguous() and w_packed.is_contiguous()):
        raise ValueError("popcount_gemm needs contiguous x_packed and w_packed")
    tile, loader, split = plan or popcount_plan(
        m, kw, n, x_packed.data_ptr(), w_packed.data_ptr(),
        _sm_count(x_packed.device))
    scale = _epilogue_operand(scale, n, 1.0, x_packed.device)
    add = _epilogue_operand(add, n, 0.0, x_packed.device)
    out = torch.empty((m, n), dtype=torch.float32, device=x_packed.device)
    if m == 0 or n == 0:
        return out
    err = _popcount_kernel()(
        x_packed.data_ptr(), w_packed.data_ptr(), scale.data_ptr(),
        add.data_ptr(), out.data_ptr(), m, kw, n, k, tile,
        int(loader == "vector"), split,
        torch.cuda.current_stream(x_packed.device).cuda_stream)
    if err:
        raise RuntimeError(f"popcount_gemm kernel launch failed: CUDA error {err}")
    popcount_gemm.launches += 1
    return out


popcount_gemm.launches = 0


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word held in an int64 tensor."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def popcount_gemm_reference(x_packed: torch.Tensor, w_packed: torch.Tensor,
                            k: int, scale: Optional[torch.Tensor] = None,
                            add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`popcount_gemm`, on the kernel's own
    operands: ``x_packed`` is :func:`pack_bits` of the ``(M, K)`` activations
    along the last axis, as the kernel takes it. The JAX package's
    ``popcount_gemm_reference(x, ...)`` takes the unpacked activations and
    packs them inside; for the same result here pass ``pack_bits(x,
    axis=-1)``. The mismatch counts are exact integers; the epilogue is
    f32."""
    mask = 0xFFFFFFFF
    xw = x_packed.to(torch.int64) & mask
    ww = w_packed.to(torch.int64) & mask
    mism = torch.zeros((xw.shape[0], ww.shape[1]), dtype=torch.int64,
                       device=xw.device)
    for i in range(ww.shape[0]):
        mism += _popcount32(xw[:, i, None] ^ ww[None, i, :])
    out = (k - 2 * mism).to(torch.float32)
    if scale is not None:
        out = out * scale.to(torch.float32)
    if add is not None:
        out = out + add.to(torch.float32)
    return out
