"""The port's input pipeline (bnn_tpu_torch.data) against bnn_tpu.data on the
CPU: augment_crop_flip and the loader's numpy path bit for bit (the latter
transposed to NCHW), the loader cases of tests/test_data.py on both paths
(labels that follow the images, the reshuffle each epoch, disjoint shards,
mmap stores, the crops' pad values, flips), and the prefetcher's order, early
exit, error propagation and refusals. The native path is held against the
JAX package's in tests/test_torch_native.py; here it runs the port's own
library, whose cases skip only where g++ is absent.
"""
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from bnn_tpu import data as jdata
from bnn_tpu_torch import data as tdata


@pytest.fixture(params=[True, False], ids=["native", "numpy"])
def use_native(request):
    if request.param and shutil.which("g++") is None:
        pytest.skip("g++ is not on PATH: the native loader cannot be built")
    return request.param


def _store(n=64, h=8, w=8, c=3):
    # image i is filled with value i, so labels can be checked against pixels
    imgs = np.broadcast_to(
        np.arange(n, dtype=np.uint8)[:, None, None, None], (n, h, w, c)).copy()
    return imgs, np.arange(n, dtype=np.int32)


@pytest.mark.parametrize("pad", [0, 2, 4])
def test_augment_crop_flip_bit_equal(pad):
    x = np.random.default_rng(0).normal(size=(8, 12, 10, 3)).astype(np.float32)
    ours = tdata.augment_crop_flip(x, np.random.default_rng(1), pad=pad)
    np.testing.assert_array_equal(
        ours, jdata.augment_crop_flip(x, np.random.default_rng(1), pad=pad))


@pytest.mark.parametrize("pad,mode,flip", [(0, "zeros", False), (0, "zeros", True),
                                           (2, "zeros", True), (2, "reflect", False),
                                           (2, "reflect", True)])
def test_numpy_path_bit_equal_transposed(pad, mode, flip):
    imgs = np.random.default_rng(0).integers(0, 256, (32, 8, 6, 3)).astype(np.uint8)
    labels = np.arange(32, dtype=np.int32)
    kw = dict(batch_size=8, shuffle=True, seed=3, mean=(0.4, 0.5, 0.6),
              std=(0.2, 0.25, 0.3), pad=pad, pad_mode=mode, flip=flip,
              process_index=0, process_count=1, use_native=False)
    ours = list(tdata.NativeDataLoader(imgs, labels, **kw))
    theirs = list(jdata.NativeDataLoader(imgs, labels, **kw))
    assert len(ours) == len(theirs) == 4
    for (tx, ty), (jx, jy) in zip(ours, theirs):
        assert tx.shape == (8, 3, 8, 6) and tx.is_contiguous()
        np.testing.assert_array_equal(tx.numpy(), jx.transpose(0, 3, 1, 2))
        np.testing.assert_array_equal(ty.numpy(), jy)


def test_native_matches_numpy_without_augment():
    """tests/test_data.py's case: the two paths agree where no randomness
    enters (the C++ may contract the affine into one rounding)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not on PATH")
    imgs = np.random.default_rng(0).integers(0, 256, (32, 8, 8, 3)).astype(np.uint8)
    labels = np.arange(32, dtype=np.int32)
    kw = dict(batch_size=8, shuffle=True, seed=3, mean=(0.4, 0.5, 0.6),
              std=(0.2, 0.25, 0.3), process_index=0, process_count=1)
    a = list(tdata.NativeDataLoader(imgs, labels, use_native=True, **kw))
    b = list(tdata.NativeDataLoader(imgs, labels, use_native=False, **kw))
    for (xa, ya), (xb, yb) in zip(a, b):
        torch.testing.assert_close(xa, xb, rtol=0, atol=1e-6)
        assert torch.equal(ya, yb)


def test_labels_track_images_through_shuffle(use_native):
    imgs, labels = _store()
    loader = tdata.NativeDataLoader(imgs, labels, batch_size=16, seed=1,
                                    process_index=0, process_count=1,
                                    use_native=use_native)
    loader.set_epoch(2)
    for x, y in loader:
        torch.testing.assert_close(x[:, 0, 0, 0] * 255.0, y.float(), rtol=0, atol=1e-4)


def test_epoch_reshuffles_deterministically(use_native):
    imgs, labels = _store()
    loader = tdata.NativeDataLoader(imgs, labels, batch_size=64, seed=5,
                                    process_index=0, process_count=1,
                                    use_native=use_native)
    ys = []
    for epoch in (0, 1, 0):
        loader.set_epoch(epoch)
        ys.append(next(iter(loader))[1])
    assert not torch.equal(ys[0], ys[1])
    assert torch.equal(ys[0], ys[2])


def test_shards_are_disjoint_and_cover(use_native):
    imgs, labels = _store(n=60)
    seen = []
    for rank in range(4):
        loader = tdata.NativeDataLoader(imgs, labels, batch_size=5, seed=2,
                                        process_index=rank, process_count=4,
                                        use_native=use_native)
        assert len(loader) == 3
        for _, y in loader:
            seen.extend(y.tolist())
    assert sorted(seen) == list(range(60))


def test_default_shard_is_the_whole_store():
    imgs, labels = _store(n=10)
    loader = tdata.NativeDataLoader(imgs, labels, batch_size=4, drop_last=False,
                                    use_native=False)
    assert (loader.process_index, loader.process_count) == (0, 1)
    assert len(loader) == 3 and [len(y) for _, y in loader] == [4, 4, 2]


def test_zero_padding_introduces_only_pad_value(use_native):
    imgs = np.full((16, 8, 8, 3), 127, np.uint8)
    loader = tdata.NativeDataLoader(imgs, np.zeros(16, np.int32), batch_size=16,
                                    pad=2, pad_mode="zeros", seed=0,
                                    process_index=0, process_count=1,
                                    use_native=use_native)
    x, _ = next(iter(loader))
    vals = set(np.unique(np.round(x.numpy() * 255).astype(np.int32)).tolist())
    assert vals == {0, 127}


def test_reflect_crop_and_flip_keep_constant_images(use_native):
    imgs = np.full((16, 8, 8, 3), 99, np.uint8)
    loader = tdata.NativeDataLoader(imgs, None, batch_size=16, pad=3,
                                    pad_mode="reflect", flip=True, seed=0,
                                    process_index=0, process_count=1,
                                    use_native=use_native)
    x, y = next(iter(loader))
    assert y is None
    torch.testing.assert_close(x, torch.full_like(x, 99.0 / 255.0), rtol=0, atol=1e-6)


def test_flip_mirrors_samples(use_native):
    imgs = np.zeros((64, 4, 4, 1), np.uint8)
    imgs[:, :, 2:, :] = 200
    loader = tdata.NativeDataLoader(imgs, np.zeros(64, np.int32), batch_size=64,
                                    flip=True, shuffle=False, seed=0,
                                    process_index=0, process_count=1,
                                    use_native=use_native)
    x, _ = next(iter(loader))
    orig = torch.from_numpy(imgs[0].transpose(2, 0, 1).astype(np.float32) / 255.0)
    is_orig = torch.isclose(x, orig).flatten(1).all(1)
    is_mirr = torch.isclose(x, orig.flip(-1)).flatten(1).all(1)
    assert bool((is_orig | is_mirr).all()) and is_orig.any() and is_mirr.any()


def test_mmap_store(use_native, tmp_path):
    imgs, labels = _store()
    np.save(tmp_path / "x.npy", imgs)
    mm = np.load(tmp_path / "x.npy", mmap_mode="r")
    loader = tdata.NativeDataLoader(mm, labels, batch_size=16, seed=1,
                                    process_index=0, process_count=1,
                                    use_native=use_native)
    x, y = next(iter(loader))
    torch.testing.assert_close(x[:, 0, 0, 0] * 255.0, y.float(), rtol=0, atol=1e-4)


def test_loader_refuses_bad_stores():
    with pytest.raises(ValueError, match="uint8"):
        tdata.NativeDataLoader(np.zeros((4, 2, 2, 3), np.float32), None, 2,
                               use_native=False)
    with pytest.raises(ValueError, match="pad_mode"):
        tdata.NativeDataLoader(np.zeros((4, 2, 2, 3), np.uint8), None, 2,
                               pad_mode="edge", use_native=False)


def test_prefetch_on_cpu_keeps_order_and_moves_nothing():
    def gen():
        for i in range(5):
            yield (np.full((4, 3), i, np.float32), torch.full((4,), i), None)

    batches = list(tdata.prefetch_to_device(gen(), size=2, device="cpu"))
    assert len(batches) == 5
    for i, (x, y, none) in enumerate(batches):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        assert bool((x == i).all()) and bool((y == i).all()) and none is None


def test_prefetch_early_exit_stops_worker():
    """A break in the consumer (or an exception in the step) stops the
    thread and the source, and drops the queued batches."""
    produced = []

    def gen():
        for i in range(100):
            produced.append(i)
            yield np.full((2,), i, np.float32)

    before = threading.active_count()
    it = tdata.prefetch_to_device(gen(), size=2, device="cpu")
    next(it)
    it.close()  # what a `break` in a for-loop does
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "prefetch worker leaked"
    assert len(produced) < 100


def test_prefetch_propagates_errors():
    def gen():
        yield np.ones((2,), np.float32)
        raise RuntimeError("loader broke")

    with pytest.raises(RuntimeError, match="loader broke"):
        list(tdata.prefetch_to_device(gen(), device="cpu"))


def test_prefetch_refusals():
    with pytest.raises(NotImplementedError, match="item 5"):
        next(tdata.prefetch_to_device(iter([]), mesh=object(), device="cpu"))
    with pytest.raises(NotImplementedError, match="item 5"):
        next(tdata.prefetch_to_device(iter([]), host_shards=True, device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            next(tdata.prefetch_to_device(iter([np.ones(2)])))
