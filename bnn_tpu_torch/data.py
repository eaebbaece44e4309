"""Input pipeline (counterpart of ``bnn_tpu/data.py``).

:class:`NativeDataLoader` assembles shuffled, sharded, augmented and
normalised NCHW float32 batches on the host from a uint8 NHWC store, with
the C++ stage of :mod:`bnn_tpu_torch.native`; :func:`prefetch_to_device`
copies them to the card from a background thread on a side stream, so host
work and copies overlap the training step. :func:`augment_crop_flip` is the
CIFAR trainer's vectorised numpy augmentation, bit for bit the JAX
package's.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from . import native

__all__ = ["prefetch_to_device", "augment_crop_flip", "NativeDataLoader"]


def _tree_map(fn, tree):
    """``fn`` over the tensors and arrays of a batch (tuples, lists and dicts
    of them; None and other leaves pass through)."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return fn(torch.from_numpy(tree))
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def _tensors(tree) -> list:
    found = []
    _tree_map(lambda t: found.append(t) or t, tree)
    return found


def prefetch_to_device(iterator: Iterable, size: int = 2, device=None,
                       mesh=None, host_shards: bool = False) -> Iterator:
    """Stage host batches onto ``device`` (default: the current CUDA device)
    ahead of the consumer.

    A background thread pulls from ``iterator``, pins each batch's tensors
    (numpy arrays become tensors) and copies them with ``non_blocking=True``
    on a side CUDA stream, keeping up to ``size`` batches in flight. The
    consumer's stream waits on each copy's event, and every tensor it gets
    is recorded on that stream, so the caching allocator does not hand its
    memory out again while the consumer's work may still read it. With
    ``device='cpu'`` nothing moves: the batches come as tensors, in order.

    An exception in ``iterator`` is raised in the consumer; closing the
    generator (a ``break``, an exception in the step) stops the thread and
    drops the queued batches. ``mesh=`` and ``host_shards=True`` (batches
    sharded over several devices or hosts) wait for the port's parallelism
    (``ROADMAP.md`` queue 1, item 5) and raise ``NotImplementedError``.
    """
    if mesh is not None or host_shards:
        raise NotImplementedError(
            "prefetch_to_device(mesh=, host_shards=True) shards batches over "
            "devices; the port's parallelism (ROADMAP.md queue 1, item 5) is "
            "not ported yet")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "prefetch_to_device copies to CUDA by default and no CUDA "
                "device is available; pass device='cpu'")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        side = torch.cuda.Stream(device)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    err: list = []
    stop = threading.Event()

    def _put(batch):
        if device.type != "cuda":
            return _tree_map(lambda t: t.to(device), batch), None
        with torch.cuda.device(device), torch.cuda.stream(side):
            # pin_memory() copies into a fresh page-locked buffer; the host
            # allocator keeps it from reuse until the copy issued from it on
            # ``side`` has run
            out = _tree_map(
                lambda t: t.pin_memory().to(device, non_blocking=True), batch)
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    def _offer(item) -> bool:
        # a bounded put that gives up when the consumer is gone: a plain
        # q.put would block forever after the generator is closed early,
        # keeping the thread and size + 1 batches alive
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker():
        try:
            for batch in iterator:
                if not _offer(_put(batch)):
                    return
        except Exception as e:  # raised again in the consumer
            err.append(e)
        finally:
            _offer(sentinel)

    threading.Thread(target=_worker, daemon=True,
                     name="prefetch_to_device").start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            batch, done = item
            if done is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(done)
                for t in _tensors(batch):
                    t.record_stream(stream)
            yield batch
    finally:
        stop.set()
        while True:  # release the queued batches now
            try:
                q.get_nowait()
            except queue.Empty:
                break


def _gather_crops(padded: np.ndarray, oy: np.ndarray, ox: np.ndarray,
                  h: int, w: int) -> np.ndarray:
    """Per-image crop gather by advanced indexing, the shared core of
    :func:`augment_crop_flip` and the loader's numpy path."""
    n = padded.shape[0]
    rows = oy[:, None] + np.arange(h)[None, :]            # (n, h)
    cols = ox[:, None] + np.arange(w)[None, :]            # (n, w)
    return padded[np.arange(n)[:, None, None], rows[:, :, None],
                  cols[:, None, :], :]


def augment_crop_flip(x: np.ndarray, rng: np.random.Generator,
                      pad: int = 4) -> np.ndarray:
    """Vectorised random crop (reflect pad) + horizontal flip of an NHWC
    batch, the reference's CIFAR transforms; the same ``rng`` gives the same
    bits as ``bnn_tpu.data.augment_crop_flip``."""
    n, h, w, c = x.shape
    padded = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                    mode="reflect")
    oy = rng.integers(0, 2 * pad + 1, n)
    ox = rng.integers(0, 2 * pad + 1, n)
    out = _gather_crops(padded, oy, ox, h, w)
    flips = rng.random(n) < 0.5
    out[flips] = out[flips, :, ::-1]
    return out


def _default_shard() -> tuple:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class NativeDataLoader:
    """Multi-core host data loader over an in-memory or memory-mapped uint8
    store: the torch ``DataLoader`` of the reference's trainers.

    Each epoch is one seeded permutation (``seed + epoch``) split round-robin
    over ``process_count`` shards (``DistributedSampler``'s rule), and each
    batch is gathered, augmented (padded random crop, horizontal flip) and
    normalised by :func:`bnn_tpu_torch.native.load_batch`, with OpenMP across
    cores and the interpreter lock released. It yields ``(x, y)``: ``x`` a
    ``(B, C, H, W)`` float32 tensor, ``y`` int64 labels or None. The batches
    equal ``bnn_tpu.data.NativeDataLoader``'s transposed to NCHW, bit for
    bit, on either path.

    Typical use::

        loader = NativeDataLoader(train_x_u8, train_y, batch_size=256,
                                  mean=(0.485, 0.456, 0.406),
                                  std=(0.229, 0.224, 0.225),
                                  pad=4, flip=True)
        for epoch in range(epochs):
            loader.set_epoch(epoch)
            for x, y in prefetch_to_device(iter(loader)):
                metrics = train_step(model, opt, x, y)

    Args:
        images: ``(N, H, W, C)`` uint8 (``np.load(..., mmap_mode='r')``
            works: pages are read on first touch).
        labels: ``(N,)`` integer labels, or None.
        batch_size: batch size of this shard.
        shuffle: reshuffle each epoch with ``seed + epoch``.
        mean/std: per-channel normalisation in [0, 1] units (torchvision's
            convention); the output is ``(u8/255 - mean) / std``.
        pad: padded-random-crop size (0: no crop). ``pad_mode='zeros'`` is
            torchvision's RandomCrop; ``'reflect'`` is
            :func:`augment_crop_flip`'s.
        flip: random horizontal flip.
        drop_last: drop the trailing partial batch (every step sees one
            shape).
        process_index/process_count: this shard and the number of shards
            (default: ``torch.distributed``'s rank and world size when a
            process group exists, else 0 and 1).
        use_native: None or True, the C++ stage (a failed build raises);
            False, the vectorised numpy path, whose random stream differs
            from the native one (each is deterministic in seed and epoch).
    """

    def __init__(self, images: np.ndarray, labels: Optional[np.ndarray],
                 batch_size: int, *, shuffle: bool = True,
                 mean: Sequence[float] = 0.0,
                 std: Sequence[float] = 1.0,
                 pad: int = 0, pad_mode: str = "zeros", flip: bool = False,
                 drop_last: bool = True, seed: int = 0,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 use_native: Optional[bool] = None):
        if images.dtype != np.uint8 or images.ndim != 4:
            raise ValueError("images must be (N, H, W, C) uint8")
        if pad_mode not in ("zeros", "reflect"):
            raise ValueError(f"pad_mode must be 'zeros' or 'reflect', got {pad_mode!r}")
        self.images = images
        self.labels = None if labels is None else np.ascontiguousarray(
            labels, np.int32)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.pad, self.pad_mode, self.flip = int(pad), pad_mode, bool(flip)
        self.drop_last = drop_last
        self.seed = int(seed)
        self.epoch = 0
        c = images.shape[-1]
        mean = np.broadcast_to(np.asarray(mean, np.float32), (c,))
        std = np.broadcast_to(np.asarray(std, np.float32), (c,))
        self.scale = np.ascontiguousarray(1.0 / (255.0 * std))
        self.bias = np.ascontiguousarray(-mean / std)
        rank, world = _default_shard()
        self.process_index = rank if process_index is None else process_index
        self.process_count = world if process_count is None else process_count
        self.use_native = True if use_native is None else bool(use_native)
        if self.use_native:
            native.loader_num_threads()  # builds and loads now: a failure raises here

    def set_epoch(self, epoch: int) -> None:
        """Advance the shuffle and augmentation seed (``DistributedSampler``'s
        ``set_epoch``)."""
        self.epoch = int(epoch)

    def _epoch_indices(self) -> np.ndarray:
        n = self.images.shape[0]
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            idx = rng.permutation(n)
        else:
            idx = np.arange(n)
        # this shard's round-robin slice of the permutation every shard draws
        return np.ascontiguousarray(
            idx[self.process_index::self.process_count], np.int64)

    def __len__(self) -> int:
        n = len(range(self.process_index, self.images.shape[0],
                      self.process_count))
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        idx = self._epoch_indices()
        bs = self.batch_size
        end = len(idx) - (len(idx) % bs) if self.drop_last else len(idx)
        aug_seed = self.seed * 1_000_003 + self.epoch
        for lo in range(0, end, bs):
            sel = idx[lo:lo + bs]
            if self.use_native:
                x, y = native.load_batch(
                    self.images, sel, self.labels, self.scale, self.bias,
                    pad=self.pad, pad_mode=self.pad_mode, flip=self.flip,
                    seed=aug_seed)
            else:
                x, y = self._numpy_batch(sel, aug_seed)
            yield (torch.from_numpy(x),
                   None if y is None else torch.from_numpy(y).long())

    def _numpy_batch(self, sel: np.ndarray, aug_seed: int):
        """The vectorised numpy path: the same transforms as the native one,
        from another random stream; NCHW float32 and int32 labels."""
        x = self.images[sel].astype(np.float32) * self.scale + self.bias
        if self.pad > 0 or self.flip:
            rng = np.random.default_rng(aug_seed + int(sel[0]))
            if self.pad > 0:
                n, h, w, _ = x.shape
                mode = "reflect" if self.pad_mode == "reflect" else "constant"
                kw = {} if mode == "reflect" else {"constant_values": 0.0}
                # pad in normalised space with the value of a u8 zero, bias
                pv = np.broadcast_to(self.bias, x.shape[-1:])
                padded = np.pad(
                    x - pv, ((0, 0), (self.pad,) * 2, (self.pad,) * 2,
                             (0, 0)), mode=mode, **kw) + pv
                oy = rng.integers(0, 2 * self.pad + 1, n)
                ox = rng.integers(0, 2 * self.pad + 1, n)
                x = _gather_crops(padded, oy, ox, h, w)
            if self.flip:
                flips = rng.random(x.shape[0]) < 0.5
                x[flips] = x[flips, :, ::-1]
        y = None if self.labels is None else self.labels[sel]
        return np.ascontiguousarray(x.transpose(0, 3, 1, 2)), y
