"""The host-side C++ engines (counterpart of ``bnn_tpu/native/__init__.py``).

Two libraries, each built from the port's own source at first use with
``g++ -O3 -march=native -fopenmp -shared -fPIC`` and loaded with ctypes:

- ``csrc/cpu/xnor_cpu.cpp``: :func:`pack_rows`, :func:`pack_weights` and
  :func:`gemm`, the XNOR/popcount GEMM on the CPU;
- ``csrc/cpu/dataloader.cpp``: :func:`load_batch`, which gathers, augments
  and normalises one batch into NCHW float32 with OpenMP across samples and
  the interpreter lock released (the stage under
  :class:`bnn_tpu_torch.data.NativeDataLoader`).

A library goes into the build directory of :mod:`bnn_tpu_torch.kernels._build`
(``bnn_tpu_torch/_build`` unless :func:`bnn_tpu_torch.utils.
enable_compilation_cache` moved it) as ``lib<name>-<hash>.so``, the hash over
the source, the flags and the host CPU's features: the compiler writes a
temporary file that is then moved into place, so a process never loads half a
library, and its output is kept beside the library as ``<library>.log``. A
failed build raises ``RuntimeError`` with the compiler's output.
:func:`available` and :func:`loader_available` only say whether ``g++`` is
there. Nothing builds at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..kernels import _build

__all__ = ["available", "loader_available", "pack_rows", "pack_weights",
           "gemm", "num_threads", "load_batch", "loader_num_threads"]

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc" / "cpu"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)
_i64 = ctypes.c_int64
# the C signature of each library's functions: (argtypes, restype)
_SIGNATURES = {
    "xnor_cpu": {
        "bnn_pack_rows": ([_f32p, _u32p, _i64, _i64], None),
        "bnn_pack_weights": ([_f32p, _u32p, _i64, _i64], None),
        "bnn_gemm": ([_u32p, _u32p, _f32p, _i64, _i64, _i64, _f32p, _f32p], None),
        "bnn_gemm_f32": ([_f32p, _u32p, _f32p, _u32p, _i64, _i64, _i64, _f32p,
                          _f32p], None),
        "bnn_num_threads": ([], ctypes.c_int),
    },
    "dataloader": {
        "bnn_load_batch": ([
            _u8p, _i64, _i64, _i64,      # images, H, W, C
            _i64p, _i64,                 # indices, batch
            _i32p, _f32p, _i32p,         # labels, out_x, out_y
            _f32p, _f32p,                # scale, bias
            _i64, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        ], None),
        "bnn_loader_num_threads": ([], ctypes.c_int),
    },
}


def _cxx() -> Optional[str]:
    return shutil.which("g++")


def available() -> bool:
    """Whether the libraries can be built here (``g++`` is on PATH). A build
    that then fails raises; it is not reported here."""
    return _cxx() is not None


loader_available = available


def _target(name: str) -> Path:
    h = hashlib.sha1((SRC_DIR / f"{name}.cpp").read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_build.host_tag().encode())
    return _build.BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _compile(name: str) -> Path:
    """Build ``csrc/cpu/<name>.cpp`` unless its library is there already."""
    target = _target(name)
    if target.exists():
        return target
    cxx = _cxx()
    if cxx is None:
        raise RuntimeError(
            f"g++ not found on PATH: bnn_tpu_torch.native builds "
            f"{SRC_DIR / (name + '.cpp')} at first use")
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, str(SRC_DIR / f"{name}.cpp"), "-o", str(tmp)]
    try:
        run = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        log = target.with_name(target.name + ".log")
        log_tmp = log.with_suffix(f".{os.getpid()}.tmp")
        log_tmp.write_text(" ".join(cmd) + "\n" + run.stdout)
        os.replace(log_tmp, log)
        if run.returncode != 0:
            raise RuntimeError(f"native build of {name}.cpp failed (g++ exited "
                               f"{run.returncode}):\n{' '.join(cmd)}\n{run.stdout}")
        os.replace(tmp, target)
    finally:
        tmp.unlink(missing_ok=True)
    return target


def _load(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_compile(name)))
            for fn, (argtypes, restype) in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return _libs[name]


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def num_threads() -> int:
    """OpenMP threads of the XNOR engine."""
    return _load("xnor_cpu").bnn_num_threads()


def pack_rows(x: np.ndarray) -> np.ndarray:
    """Pack the sign bits (``x >= 0``) of a row-major ``(M, K)`` float array
    into ``(M, ceil(K/32))`` uint32 words."""
    lib = _load("xnor_cpu")
    x = np.ascontiguousarray(x, np.float32)
    m, k = x.shape
    out = np.empty((m, (k + 31) // 32), np.uint32)
    lib.bnn_pack_rows(_ptr(x, _f32p), _ptr(out, _u32p), m, k)
    return out


def pack_weights(w: np.ndarray) -> np.ndarray:
    """Pack a ``(K, N)`` float weight matrix into ``(ceil(K/32), N)`` uint32
    words, the layout of :func:`bnn_tpu_torch.kernels.pack_bits` over
    axis -2."""
    lib = _load("xnor_cpu")
    w = np.ascontiguousarray(w, np.float32)
    k, n = w.shape
    out = np.empty(((k + 31) // 32, n), np.uint32)
    lib.bnn_pack_weights(_ptr(w, _f32p), _ptr(out, _u32p), k, n)
    return out


def gemm(x: np.ndarray, w_packed: np.ndarray, k: int,
         scale: Optional[np.ndarray] = None,
         add: Optional[np.ndarray] = None) -> np.ndarray:
    """``sign(x) @ unpack(w_packed) * scale + add`` by XNOR and popcount:
    ``x`` is ``(M, K)`` float32 (packed here), ``w_packed`` the
    ``(ceil(K/32), N)`` words of :func:`pack_weights`; returns ``(M, N)``
    float32."""
    lib = _load("xnor_cpu")
    x = np.ascontiguousarray(x, np.float32)
    w_packed = np.ascontiguousarray(w_packed, np.uint32)
    m, k_in = x.shape
    kw, n = w_packed.shape
    if k_in != k or kw != (k + 31) // 32:
        raise ValueError(f"x of K={k_in} and {kw} weight words do not fit k={k}")
    # contiguous copies held for the duration of the call
    rows = []
    for v in (scale, add):
        if v is not None:
            v = np.ascontiguousarray(v, np.float32)
            if v.shape != (n,):
                raise ValueError(f"an epilogue row of shape {v.shape} for N={n}")
        rows.append(v)
    out = np.empty((m, n), np.float32)
    scratch = np.empty((m, kw), np.uint32)
    null = ctypes.cast(None, _f32p)
    lib.bnn_gemm_f32(_ptr(x, _f32p), _ptr(w_packed, _u32p), _ptr(out, _f32p),
                     _ptr(scratch, _u32p), m, k, n,
                     *[null if v is None else _ptr(v, _f32p) for v in rows])
    return out


def loader_num_threads() -> int:
    """OpenMP threads of the batch-assembly library."""
    return _load("dataloader").bnn_loader_num_threads()


def load_batch(images: np.ndarray, indices: np.ndarray,
               labels: Optional[np.ndarray],
               scale: np.ndarray, bias: np.ndarray, *,
               pad: int = 0, pad_mode: str = "zeros", flip: bool = False,
               seed: int = 0,
               out_x: Optional[np.ndarray] = None,
               out_y: Optional[np.ndarray] = None):
    """Assemble one normalised float32 batch, ``(B, C, H, W)``, from a uint8
    ``(N, H, W, C)`` store (a ``np.load(..., mmap_mode='r')`` array works).

    ``out = u8[idx] * scale[c] + bias[c]`` per channel, after an optional
    padded random crop (``pad`` > 0, ``pad_mode`` ``'zeros'`` or
    ``'reflect'``) and random horizontal flip. Sample ``idx``'s randomness
    is ``splitmix64(seed ^ idx)``, so a batch is what
    ``bnn_tpu.native.load_batch`` gives, transposed to NCHW, bit for bit.
    Returns ``(out_x, out_y)`` (``out_y`` int32, or None without labels);
    pass preallocated arrays to avoid allocating per batch."""
    lib = _load("dataloader")
    if images.dtype != np.uint8 or images.ndim != 4:
        raise ValueError(f"images must be (N, H, W, C) uint8, got "
                         f"{images.dtype} of rank {images.ndim}")
    if not images.flags.c_contiguous:
        raise ValueError("images must be C-contiguous")
    if pad_mode not in ("zeros", "reflect"):
        raise ValueError(f"pad_mode must be 'zeros' or 'reflect', got {pad_mode!r}")
    n, h, w, c = images.shape
    indices = np.ascontiguousarray(indices, np.int64)
    batch = indices.shape[0]
    # the C function takes no N: an index past the store would read outside
    # it, where the numpy path raises IndexError
    if batch and (int(indices.min()) < 0 or int(indices.max()) >= n):
        raise IndexError(
            f"indices out of range [0, {n}): "
            f"[{int(indices.min())}, {int(indices.max())}]")
    if labels is not None and np.shape(labels)[0] != n:
        raise ValueError(
            f"labels length {np.shape(labels)[0]} != images length {n}")
    if out_x is None:
        out_x = np.empty((batch, c, h, w), np.float32)
    elif (out_x.shape != (batch, c, h, w) or out_x.dtype != np.float32
          or not out_x.flags.c_contiguous):
        raise ValueError(f"out_x must be C-contiguous float32 of shape "
                         f"{(batch, c, h, w)}, got {out_x.dtype} {out_x.shape}")
    if labels is not None:
        labels = np.ascontiguousarray(labels, np.int32)
        if out_y is None:
            out_y = np.empty((batch,), np.int32)
        elif out_y.shape != (batch,) or out_y.dtype != np.int32:
            raise ValueError(f"out_y must be int32 of shape {(batch,)}")
    scale = np.ascontiguousarray(scale, np.float32)
    bias = np.ascontiguousarray(bias, np.float32)
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"scale and bias must be ({c},), got {scale.shape} "
                         f"and {bias.shape}")
    null = ctypes.cast(None, _i32p)
    lib.bnn_load_batch(
        _ptr(images, _u8p), h, w, c, _ptr(indices, _i64p), batch,
        null if labels is None else _ptr(labels, _i32p), _ptr(out_x, _f32p),
        null if out_y is None else _ptr(out_y, _i32p),
        _ptr(scale, _f32p), _ptr(bias, _f32p),
        int(pad), {"zeros": 0, "reflect": 1}[pad_mode], int(bool(flip)),
        int(seed) & (2**64 - 1))
    return out_x, out_y
