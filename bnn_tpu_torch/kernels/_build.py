"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``bnn_tpu_torch/csrc/<name>.cu`` compiles on its own with ``nvcc`` for
``sm_90a`` into ``bnn_tpu_torch/_build/lib<name>-<hash>.so``; the hash covers
the source, the shared headers and the flags, so an edited source never
loads a stale library. :func:`build` starts one ``nvcc`` per missing library,
all at once. Nothing here runs at import: the CPU tests import every module
of the package on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["SOURCES", "build", "load", "host_tag", "set_build_dir"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("binary_gemm", "fused_stem", "fused_chain", "fused_basic_block",
           "fused_downsample_block", "fused_bottleneck", "fused_stem_chain",
           "binary_conv2d_s1", "popcount_gemm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def host_tag() -> str:
    """A fingerprint of the host CPU's ISA features. Code built with
    ``-march=native`` (``bnn_tpu_torch.native``) runs only on CPUs that have
    the features of the CPU that built it, so its library names and build directories carry
    this tag, and a build directory copied to another machine is not loaded
    there."""
    feats = platform.machine()
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("flags", "Features")):
                    feats += " " + " ".join(sorted(line.split()[2:]))
                    break
    except OSError:
        pass
    return hashlib.sha1(feats.encode()).hexdigest()[:10]


def set_build_dir(path) -> Path:
    """Build (and look for) the CUDA and native libraries in ``path`` from
    now on; libraries already loaded stay loaded."""
    global BUILD_DIR
    BUILD_DIR = Path(path)
    return BUILD_DIR


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's CUDA "
        "kernels build from bnn_tpu_torch/csrc at first use")


def _target(name: str) -> Path:
    h = hashlib.sha1()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` per source, all started together. Returns the wall seconds.
    The compiler's report (registers, shared memory, spills) is kept beside
    each library as ``<library>.log``."""
    start = time.perf_counter()
    pending = [(n, _target(n)) for n in names if not _target(n).exists()]
    if not pending:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    try:
        for name, target in pending:
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, target, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failures = []
        for name, target, tmp, proc in procs:
            log, _ = proc.communicate()
            target.with_name(target.name + ".log").write_text(log)
            if proc.returncode != 0:
                failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            else:
                os.replace(tmp, target)
        if failures:
            raise RuntimeError("CUDA build failed:\n" + "\n".join(failures))
    finally:
        for _, _, tmp, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return time.perf_counter() - start


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]
