"""The port's host C++ engines (bnn_tpu_torch.native) against bnn_tpu.native
on the CPU: the XNOR GEMM and its packing bit for bit at
tests/test_native.py's cases; load_batch and NativeDataLoader's native path
bit for bit against the JAX package's output transposed to NCHW; the
Python-side bounds checks; and the build, which keeps its own copies of the
sources, raises with the compiler's output when it fails, and never falls
back.

The JAX package builds its libraries in place, under bnn_tpu/native, guarded
by a thread lock only. So that this file never builds there beside another
worker, the JAX wrappers here load libraries that its own build function
makes from its own sources in a directory of this run. Every case skips only
where g++ is absent.
"""
import shutil
import threading

import numpy as np
import pytest
import torch

from bnn_tpu import data as jdata
from bnn_tpu import native as jnative
from bnn_tpu_torch import data as tdata
from bnn_tpu_torch import native as tnative
from bnn_tpu_torch.kernels import _build


@pytest.fixture(scope="module")
def jax_libs(tmp_path_factory):
    """Private builds of bnn_tpu/native's two libraries, made by its own
    ``_build_and_load``, and the port's two libraries, all four compilers
    started together."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not on PATH: the native engines cannot be built")
    out = tmp_path_factory.mktemp("jax_native")
    paths = {"xnor": (jnative._SRC, str(out / "libxnor_cpu.so")),
             "loader": (jnative._DL_SRC, str(out / "libbnndata.so"))}
    errors = []

    def run(fn):
        try:
            fn()
        except Exception as e:  # read after the join
            errors.append(e)

    jobs = [lambda s=s, p=p: jnative._build_and_load(s, p) for s, p in paths.values()]
    jobs += [tnative.num_threads, tnative.loader_num_threads]
    threads = [threading.Thread(target=run, args=(j,)) for j in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    if errors:
        raise errors[0]
    return {k: p for k, (_, p) in paths.items()}


@pytest.fixture
def jax_native(jax_libs, monkeypatch):
    """``bnn_tpu.native`` loading the private builds."""
    monkeypatch.setattr(jnative, "_LIB_PATH", jax_libs["xnor"])
    monkeypatch.setattr(jnative, "_DL_LIB_PATH", jax_libs["loader"])
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_dl_lib", None)
    return jnative


@pytest.mark.parametrize("k", [32, 64, 100, 7])
def test_pack_rows_bit_equal(jax_native, k):
    x = np.random.default_rng(0).normal(size=(4, k)).astype(np.float32)
    np.testing.assert_array_equal(tnative.pack_rows(x), jax_native.pack_rows(x))


@pytest.mark.parametrize("k,n", [(64, 16), (100, 10), (256, 128)])
def test_pack_weights_bit_equal(jax_native, k, n):
    w = np.random.default_rng(1).normal(size=(k, n)).astype(np.float32)
    ours = tnative.pack_weights(w)
    np.testing.assert_array_equal(ours, jax_native.pack_weights(w))
    # the layout of the port's pack_bits over the K axis
    from bnn_tpu_torch.kernels import pack_bits
    np.testing.assert_array_equal(
        ours.view(np.int32), pack_bits(torch.from_numpy(w), axis=-2).numpy().view(np.int32))


@pytest.mark.parametrize("m,k,n,epilogue", [(4, 64, 8, True), (3, 100, 5, True),
                                            (16, 512, 64, True), (8, 96, 32, False)])
def test_gemm_bit_equal(jax_native, m, k, n, epilogue):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    wp = tnative.pack_weights(w)
    rows = ((np.abs(rng.normal(size=n)).astype(np.float32),
             rng.normal(size=n).astype(np.float32)) if epilogue else (None, None))
    ours = tnative.gemm(x, wp, k, *rows)
    np.testing.assert_array_equal(ours, jax_native.gemm(x, wp, k, *rows))
    if not epilogue:
        exact = np.where(x >= 0, 1.0, -1.0) @ np.where(w >= 0, 1.0, -1.0)
        np.testing.assert_array_equal(ours, exact)


def test_gemm_refuses_mismatched_operands(jax_libs):
    x = np.ones((2, 64), np.float32)
    wp = tnative.pack_weights(np.ones((64, 4), np.float32))
    with pytest.raises(ValueError, match="k=65"):
        tnative.gemm(x, wp, 65)
    with pytest.raises(ValueError, match="epilogue row"):
        tnative.gemm(x, wp, 64, np.ones(3, np.float32))


def test_threads_reported(jax_libs):
    assert tnative.num_threads() >= 1 and tnative.loader_num_threads() >= 1


def _store(n=24, h=9, w=7, c=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, h, w, c)).astype(np.uint8),
            rng.permutation(n).astype(np.int32))


_AUGMENTS = [(0, "zeros", False), (0, "zeros", True), (2, "zeros", False),
             (2, "zeros", True), (2, "reflect", False), (2, "reflect", True)]


@pytest.mark.parametrize("pad,mode,flip", _AUGMENTS)
def test_load_batch_bit_equal_transposed(jax_native, pad, mode, flip):
    imgs, labels = _store()
    idx = np.array([5, 0, 23, 7, 7, 12])
    scale = np.array([1 / 51.0, 1 / 60.0, 1 / 70.0], np.float32)
    bias = np.array([-1.0, -2.0, -0.5], np.float32)
    kw = dict(pad=pad, pad_mode=mode, flip=flip, seed=11)
    tx, ty = tnative.load_batch(imgs, idx, labels, scale, bias, **kw)
    jx, jy = jax_native.load_batch(imgs, idx, labels, scale, bias, **kw)
    assert tx.shape == (6, 3, 9, 7) and tx.dtype == np.float32
    np.testing.assert_array_equal(tx, jx.transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(ty, jy)
    # into preallocated buffers, without labels
    out = np.empty_like(tx)
    got, none = tnative.load_batch(imgs, idx, None, scale, bias, out_x=out, **kw)
    assert got is out and none is None
    np.testing.assert_array_equal(out, tx)


@pytest.mark.parametrize("pad,mode,flip", _AUGMENTS[1::2])
def test_native_loader_bit_equal_transposed(jax_native, pad, mode, flip):
    imgs, labels = _store(n=40)
    kw = dict(batch_size=8, seed=3, mean=(0.4, 0.5, 0.6), std=(0.2, 0.25, 0.3),
              pad=pad, pad_mode=mode, flip=flip, process_index=1,
              process_count=2)
    ours = tdata.NativeDataLoader(imgs, labels, **kw)
    theirs = jdata.NativeDataLoader(imgs, labels, use_native=True, **kw)
    assert ours.use_native and len(ours) == len(theirs) == 2
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for (tx, ty), (jx, jy) in zip(ours, theirs):
            assert tx.dtype == torch.float32 and ty.dtype == torch.int64
            np.testing.assert_array_equal(tx.numpy(), jx.transpose(0, 3, 1, 2))
            np.testing.assert_array_equal(ty.numpy(), jy)


def test_loader_bounds(jax_libs):
    """The C function takes no N: Python checks indices and labels."""
    imgs = np.zeros((8, 4, 4, 3), np.uint8)
    labels = np.arange(8, dtype=np.int32)
    one = np.ones(3, np.float32)
    for bad in ([0, 8], [-1]):
        with pytest.raises(IndexError, match="out of range"):
            tnative.load_batch(imgs, np.array(bad), labels, one, one * 0)
    with pytest.raises(ValueError, match="labels length"):
        tnative.load_batch(imgs, np.array([0]), np.zeros(3, np.int32), one, one * 0)
    with pytest.raises(ValueError, match="out_x"):
        tnative.load_batch(imgs, np.array([0]), labels, one, one * 0,
                           out_x=np.empty((1, 4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="uint8"):
        tnative.load_batch(imgs.astype(np.float32), np.array([0]), labels, one, one * 0)


def test_build_is_the_ports_own(jax_libs):
    """The libraries build from bnn_tpu_torch/csrc/cpu into the build
    directory, named by a hash of the source, the flags and the host, with
    the compiler's output beside them."""
    assert tnative.SRC_DIR == _build.CSRC / "cpu"
    for name in ("xnor_cpu", "dataloader"):
        target = tnative._target(name)
        assert target.parent == _build.BUILD_DIR and target.exists()
        assert target.name.startswith(f"lib{name}-") and target.suffix == ".so"
        assert target.with_name(target.name + ".log").read_text().startswith(
            shutil.which("g++"))
        # the copy differs from the JAX source only where the layout does
        assert (tnative.SRC_DIR / f"{name}.cpp").read_text() != open(
            jnative._SRC if name == "xnor_cpu" else jnative._DL_SRC).read()


def test_failed_build_raises_with_compiler_output(jax_libs, tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s output, leaves no
    library behind, and the loader does not fall back to numpy."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "dataloader.cpp").write_text("this is not C++;\n")
    monkeypatch.setattr(tnative, "SRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_libs", {})
    imgs, labels = _store(n=8)
    with pytest.raises(RuntimeError, match="g\\+\\+ exited") as info:
        tdata.NativeDataLoader(imgs, labels, batch_size=4)
    assert "error" in str(info.value)
    assert not list((tmp_path / "build").glob("*.so"))
    assert list((tmp_path / "build").glob("*.so.log"))
    # the numpy path, asked for, needs no build
    loader = tdata.NativeDataLoader(imgs, labels, batch_size=4, use_native=False)
    assert not loader.use_native and len(list(loader)) == 2


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(tnative, "_cxx", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative, "_libs", {})
    assert not tnative.available() and not tnative.loader_available()
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tnative.pack_rows(np.ones((1, 4), np.float32))
