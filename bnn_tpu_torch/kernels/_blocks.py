"""What the residual-block kernels share: the plain arithmetic their
plain versions are built from, and the launcher that hands a chain of block
descriptors to a kernel of ``bnn_tpu_torch/csrc`` (fused_basic_block,
fused_downsample_block, fused_chain, fused_stem_chain; all built on
``bnn_common.cuh``).

The plain helpers take NHWC f32 tensors and repeat the kernels' arithmetic:
exact integer convolutions (computed in float64, where sums of at most a few
thousand ternary products are exact, and rounded in case a device algorithm
is not), then f32 epilogues whose multiply and add round separately.
"""
from __future__ import annotations

import ctypes
import functools
import threading
import weakref
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from ._build import load

ACTS = ("relu", "prelu", "identity")
# epilogue rows of a block descriptor, in csrc/bnn_common.cuh's order (the
# kernel gives a missing row its default: scales 1, slopes 0.25, others 0)
ROWS = ("scale1", "add1", "prelu1", "scale2", "add2", "prelu2", "scaled",
        "addd", "threshold2", "threshold1", "thresholdd")
_IN_ROWS = ("threshold1", "thresholdd")  # per input channel; the rest per output
MAX_BLOCKS = 8
# a block's pointers and ints in a kernel's flat arrays, csrc/bnn_common.cuh's
# BLOCK_PTRS and BLOCK_INTS: w1, w2, wd, their K-major copies, the rows; down,
# ci, co, the row lengths
BLOCK_PTRS = 6 + len(ROWS)
BLOCK_INTS = 3 + len(ROWS)
_FLOATS = (torch.float32, torch.bfloat16)


def tensor_key(values) -> tuple:
    """What a descriptor built from ``values`` depends on: for each tensor
    its data pointer, version (in-place updates), shape, strides, dtype and
    device; any other value as given. The descriptor holds the tensors, so
    a pointer it recorded is not reused while it lives."""
    return tuple((v.data_ptr(), v._version, v.shape, v.stride(), v.dtype,
                  v.device) if isinstance(v, torch.Tensor) else v for v in values)


class Kept:
    """Kernel arguments derived from weights (K-major copies, pointer
    arrays, converted epilogue rows), kept per set of source tensors so that
    a launch does not derive them again. The key is :func:`tensor_key` of
    the sources and a few other values (such as the parameter dtype), so an
    in-place update (a new version), a cast or a move (new tensors) makes a
    new entry. A kept value never holds its sources, only what was derived
    from them, and it lives no longer than they do: a weakref finalizer on
    each source's storage drops the entry when the first of them is freed
    (so a pointer in a key is never reused while its entry lives), and a new
    version of the same tensors replaces the entry of the old one."""

    def __init__(self):
        self._values = {}   # tensor_key -> value
        self._latest = {}   # the key without versions -> its current key
        # reentrant: freeing a value, or a collection while the lock is
        # held, can run a finalizer that drops another entry
        self._lock = threading.RLock()

    def get(self, sources, extra, build):
        """The value kept for ``sources`` and ``extra``, made by ``build()``
        where there is none."""
        key = tensor_key(sources) + tuple(extra)
        value = self._values.get(key)
        if value is not None:
            return value
        value = build()
        ident = tuple(k[:1] + k[2:] if isinstance(v, torch.Tensor) else k
                      for k, v in zip(key, sources)) + tuple(extra)
        with self._lock:
            old = self._latest.get(ident)
            if old is None:
                for v in sources:
                    if isinstance(v, torch.Tensor):
                        weakref.finalize(v.untyped_storage(), self._drop,
                                         ident).atexit = False
            stale = self._values.pop(old, None) if old is not None else None
            self._latest[ident] = key
            self._values[key] = value
        del stale  # freed outside the lock
        return value

    def _drop(self, ident) -> None:
        with self._lock:
            key = self._latest.pop(ident, None)
            value = self._values.pop(key, None) if key is not None else None
        del value

    def __len__(self) -> int:
        return len(self._values)


# what the kernel operators' CUDA implementations keep (kernels/ops.py)
KEPT = Kept()


def launch_plan(name: str, args, gemms) -> dict:
    """The launch of block kernel ``name`` on the current CUDA device, from
    its ``bnn_<name>_plan(*args, out)`` (bnn_common.cuh's ``block_plan``):
    its blocks, the blocks that can be resident an SM, a conv's output
    tiles, and the K slices of each GEMM named in ``gemms``."""
    fn = getattr(load(name), f"bnn_{name}_plan")
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * (3 + len(gemms)))()
    err = fn(*args, out)
    if err:
        raise RuntimeError(f"{name} plan failed: CUDA error {err}")
    return {"blocks": out[0], "resident_per_sm": out[1], "tiles": out[2],
            "k_slices": dict(zip(gemms, out[3:]))}


def split_act(act):
    """``(act1, act2)`` from one kind or a pair, checked."""
    act1, act2 = (act, act) if isinstance(act, str) else act
    if act1 not in ACTS or act2 not in ACTS:
        raise ValueError(f"act must be one of {ACTS} or a pair of them, got {act!r}")
    return act1, act2


def apply_act(y: torch.Tensor, kind: str, slope) -> torch.Tensor:
    if kind == "relu":
        return torch.where(y > 0, y, torch.zeros_like(y))
    if kind == "prelu":
        return torch.where(y >= 0, y, y * slope)
    return y


def sign(v: torch.Tensor, t, zero_to_one: bool) -> torch.Tensor:
    """``sign(v - t)`` as f32 {-1, +1} with ``zero_to_one``, else {-1, 0, +1}."""
    if zero_to_one:
        return torch.where(v >= t, 1.0, -1.0)
    return (v > t).to(torch.float32) - (v < t).to(torch.float32)


def as_tensor_row(v, device) -> Optional[torch.Tensor]:
    """An epilogue row as an operator takes it: None, a tensor, or a number
    as a one-value f32 tensor on ``device``."""
    if v is None or isinstance(v, torch.Tensor):
        return v
    return torch.tensor([float(v)], dtype=torch.float32, device=device)


def row(v, default: float, width: int, device) -> torch.Tensor:
    """A per-channel f32 row of ``width``: ``v`` broadcast, or the default."""
    if v is None:
        return torch.full((width,), default, dtype=torch.float32, device=device)
    v = torch.as_tensor(v).to(device=device, dtype=torch.float32).reshape(-1)
    return v.expand(width) if v.numel() == 1 else v


def conv3x3(s: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """Exact ``conv3x3(s, w)`` with pad 1: NHWC ternary ``s``, HWIO ``w``."""
    y = F.conv2d(s.permute(0, 3, 1, 2).to(torch.float64),
                 w.permute(3, 2, 0, 1).to(torch.float64), stride=stride,
                 padding=1)
    return y.round().to(torch.float32).permute(0, 2, 3, 1)


def pointwise(s: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact ``s @ w`` over the channels of an NHWC map, ``w`` (Ci, Co)."""
    y = s.to(torch.float64) @ w.to(torch.float64)
    return y.round().to(torch.float32)


def epilogue(acc: torch.Tensor, scale, add) -> torch.Tensor:
    return acc * scale + add


def avgpool2x2(x: torch.Tensor) -> torch.Tensor:
    """The shortcut's 2x2/s2 mean in the kernels' order:
    ``0.25 * (((p00 + p01) + p10) + p11)``. Another order can round to a
    value on the other side of the next sign's threshold."""
    return 0.25 * (((x[:, 0::2, 0::2] + x[:, 0::2, 1::2]) + x[:, 1::2, 0::2])
                   + x[:, 1::2, 1::2])


def untransform_w1(ws: torch.Tensor, ci: int) -> torch.Tensor:
    """A down block's ``(16*C_in, C_out)`` s2d conv1, rows in (ki, kj, di,
    dj, c) order, back to its ``(3, 3, C_in, C_out)`` taps."""
    co = ws.shape[-1]
    t = ws.reshape(2, 2, 2, 2, ci, co)                # (ki, kj, di, dj, c, o)
    return t.permute(0, 2, 1, 3, 4, 5).reshape(4, 4, ci, co)[1:, 1:]


def head(a: torch.Tensor, wfc: torch.Tensor,
         bfc: Optional[torch.Tensor]) -> torch.Tensor:
    """Global mean over H, W then ``pooled @ wfc + bfc`` in f32, summed in
    the kernel's order: the mean one term at a time; each logit's dot as 32
    sequential partial sums over consecutive channel slices, joined by a
    butterfly of offsets 16, 8, 4, 2, 1."""
    n, h, w, c = a.shape
    flat = a.reshape(n, h * w, c)
    s = torch.zeros((n, c), dtype=torch.float32, device=a.device)
    for q in range(h * w):
        s = s + flat[:, q]
    pooled = s / float(h * w)
    per = -(-c // 32)
    prod = pooled[:, :, None] * wfc.to(torch.float32)[None]  # (n, c, classes)
    prod = torch.cat([prod, prod.new_zeros(n, 32 * per - c, prod.shape[2])], 1)
    prod = prod.reshape(n, 32, per, -1)
    part = torch.zeros_like(prod[:, :, 0])
    for i in range(per):
        part = part + prod[:, :, i]
    for off in (16, 8, 4, 2, 1):
        part = part[:, :off] + part[:, off:2 * off]
    logits = part[:, 0]
    if bfc is not None:
        logits = logits + bfc.to(torch.float32).reshape(1, -1)
    return logits


class Desc:
    """One block as a kernel takes it: int8 weights in the JAX kernels'
    layouts (basic w1/w2 ``(9C, C)``; down w1 ``(16Ci, Co)`` s2d, w2
    ``(9Co, Co)``, wd ``(Ci, Co)``) and the epilogue rows of :data:`ROWS`
    (None, numbers, tensors, or ``(matrix, row index)`` pairs)."""

    def __init__(self, down: bool, ci: int, co: int, w1, w2, wd, rows, *,
                 derived=()):
        self.down, self.ci, self.co = bool(down), ci, co
        self.w1, self.w2, self.wd = w1, w2, wd
        self.rows = list(rows)
        floats = [v[0] if isinstance(v, tuple) else v for v in self.rows]
        self.float_dtypes = {t.dtype for t in floats if isinstance(t, torch.Tensor)}
        # tensors made from the caller's for this descriptor that its
        # pointers read (a down block's s2d conv1): kept with its arguments
        self.derived = list(derived)
        self._flat = {}
        self._kmajor = {}

    def kmajor(self, device) -> tuple:
        """``(conv1, conv2, shortcut)`` as K-major ``(C_out, K)`` int8 copies
        on ``device`` (the shortcut None for a basic block): K in the (dy, dx,
        c) tap order, a down block's conv1 as its 9*C_in taps. The tensor-core
        tile reads them as 16-byte rows. Derived from the weights once per
        device and kept by the descriptor, like :meth:`flat`'s arrays; the
        operators keep them across calls per weights (:func:`kept_blocks`)."""
        device = torch.device(device)
        if device not in self._kmajor:
            w1 = (untransform_w1(self.w1, self.ci).reshape(9 * self.ci, self.co)
                  if self.down else self.w1)
            self._kmajor[device] = tuple(
                None if w is None else
                w.to(device=device, dtype=torch.int8).t().contiguous()
                for w in (w1, self.w2, self.wd if self.down else None))
        return self._kmajor[device]

    def flat(self, name: str, dtype, device):
        """This block's ``(pointers, ints, converted copies)`` for the
        kernel's flat arrays, the rows in ``dtype``; the copies must live
        until the launch. Checked and built once per dtype and device, and
        shared by every kernel, unless a tensor had to be converted (a copy
        would miss later in-place updates of its source); the tensors must
        not be replaced while the descriptor is in use."""
        key = (dtype, device)
        if key in self._flat:
            return self._flat[key]
        tensors = [self.w1, self.w2, self.wd] + [
            v[0] if isinstance(v, tuple) else v for v in self.rows]
        _check_device(name, device, tensors)
        _check_cuda(name, device)
        if self.ci % 4 or self.co % 4:
            raise ValueError(f"{name} needs channel counts divisible by 4, "
                             f"got {self.ci} -> {self.co}")
        flat = self._layout(name, dtype, device)
        if not flat[2]:  # converted copies serve one launch only
            self._flat[key] = flat
        return flat

    def _layout(self, name: str, dtype, device):
        """:meth:`flat`'s arrays, unchecked and uncached: BLOCK_PTRS pointers
        (w1, w2, wd, the K-major copies, the rows) and BLOCK_INTS ints (down,
        ci, co, the row lengths)."""
        weights = [self.w1, self.w2, self.wd if self.down else None]
        for w, shape in zip(weights, (((16 if self.down else 9) * self.ci, self.co),
                                      (9 * self.co, self.co), (self.ci, self.co))):
            if w is not None and tuple(w.shape) != shape:
                raise ValueError(f"{name}: weights {tuple(w.shape)}, "
                                 f"expected {shape}")
        weights += list(self.kmajor(device))
        ptrs, lens, keep = flat_args(
            name, weights, zip(ROWS, self.rows),
            [self.ci if r in _IN_ROWS else self.co for r in ROWS], dtype, device)
        return ptrs, [int(self.down), self.ci, self.co] + lens, keep


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """The C entry point ``bnn_<name>`` of ``csrc/<name>.cu``."""
    fn = getattr(load(name), f"bnn_{name}")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    return fn


def _carve(device, sizes: Sequence[int]) -> List[int]:
    """Pointers to ``sizes`` bytes each, 256-byte aligned, in one allocation
    (the tensor is returned first and must outlive the launch)."""
    offs, total = [], 0
    for s in sizes:
        offs.append(total)
        total += -(-max(s, 1) // 256) * 256
    buf = torch.empty(total, dtype=torch.uint8, device=device)
    return [buf] + [buf.data_ptr() + o for o in offs]


def _check_device(name: str, device, tensors) -> None:
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.device != device:
            raise ValueError(f"{name} needs every tensor on {device}, got one "
                             f"on {t.device}")


def _check_cuda(name: str, device) -> None:
    if device.type != "cuda":
        raise ValueError(f"{name} launches on CUDA tensors, got {device}")


def flat_args(name: str, weights, rows, widths, dtype, device):
    """``(pointers, row lengths, converted copies)`` of int8 weights (None:
    a null pointer) and of ``(row name, value)`` epilogue rows, each row
    ``widths[i]`` wide in ``dtype`` (see :func:`_row`); the copies must live
    until the launch."""
    keep, ptrs, lens = [], [], []
    for w in weights:
        if w is not None and (w.dtype != torch.int8 or not w.is_contiguous()):
            w = w.to(torch.int8).contiguous()
            keep.append(w)
        ptrs.append(0 if w is None else w.data_ptr())
    for (r, v), width in zip(rows, widths):
        p, length = _row(name, r, v, width, dtype, device, keep)
        ptrs.append(p)
        lens.append(length)
    return ptrs, lens, keep


def _row(name, r, v, width, dtype, device, keep):
    """``(pointer, length)`` of an epilogue row in ``dtype``: None, a number,
    a tensor of 1 or ``width`` values, or ``(matrix, i)``, the first
    ``width`` values of row i of a 2-D tensor. A converted copy goes into
    ``keep``."""
    if v is None:
        return 0, 0
    if isinstance(v, tuple):
        mat, i = v
        if mat.dtype != dtype or not mat.is_contiguous():
            mat = mat.to(dtype).contiguous()
            keep.append(mat)
        if mat.ndim != 2 or mat.shape[1] < width:
            raise ValueError(f"{name}: {r} needs {width} values per row, got "
                             f"{tuple(mat.shape)}")
        return mat.data_ptr() + i * mat.shape[1] * mat.element_size(), width
    if not isinstance(v, torch.Tensor) or v.dtype != dtype or not v.is_contiguous():
        v = torch.as_tensor(v, device=device).to(dtype).contiguous()
        keep.append(v)
    if v.numel() not in (1, width):
        raise ValueError(f"{name}: {r} has {v.numel()} values, expected 1 or "
                         f"{width}")
    return v.data_ptr(), v.numel()


class KeptBlocks(NamedTuple):
    """A chain of blocks' part of a kernel's flat arrays (:func:`kept_blocks`):
    ``BLOCK_PTRS`` pointers and ``BLOCK_INTS`` ints a block, the tensors
    derived from the sources that they point into (K-major copies, converted
    copies, a down block's s2d conv1), each block's ``(down, ci, co)`` and
    the rows' dtype."""
    ptrs: tuple
    ints: tuple
    derived: list
    metas: tuple
    dtype: torch.dtype


def kept_blocks(name: str, sources, device, descs, floats=()) -> KeptBlocks:
    """:class:`KeptBlocks` of the blocks that ``descs()`` describes, made
    (and checked) once per ``sources``, the tensors the blocks were built
    from, and kept while they live unchanged (:data:`KEPT`). The rows are
    read in bf16 where every float tensor among the blocks' rows and
    ``floats`` (a head's weights) is bf16, else in f32. Every block kernel
    takes the same arrays."""
    def build():
        descs_ = descs()
        dtypes = set().union(*(d.float_dtypes for d in descs_))
        dtypes |= {t.dtype for t in floats if t is not None}
        dtype = torch.bfloat16 if dtypes == {torch.bfloat16} else torch.float32
        ptrs, ints, derived, metas = [], [], [], []
        for d in descs_:
            p, i, copies = d.flat(name, dtype, device)
            ptrs += p
            ints += i
            derived += list(copies) + d.derived
            derived += [t for t in d.kmajor(device) if t is not None]
            metas.append((d.down, d.ci, d.co))
        return KeptBlocks(tuple(ptrs), tuple(ints), derived, tuple(metas), dtype)

    extra = ("blocks", device) + tuple(None if t is None else t.dtype for t in floats)
    return KEPT.get(sources, extra, build)


def launch(name: str, x: torch.Tensor, blocks: KeptBlocks,
           out: torch.Tensor, *, acts, pre: bool, zero_to_one: bool,
           wfc: Optional[torch.Tensor] = None,
           bfc: Optional[torch.Tensor] = None, stem=None) -> None:
    """One launch of kernel ``name`` on CUDA tensors; raises on what the
    kernel does not take and on a failed launch. ``stem``, for
    fused_stem_chain: ``(raw NHWC input, its StemWeights)``, whose pooled
    output the kernel writes into ``x``."""
    dev = x.device
    stem_tensors = [] if stem is None else [stem[0], stem[1].wk, stem[1].bias_f32]
    _check_device(name, dev, [out, wfc, bfc] + stem_tensors)
    if x.dtype not in _FLOATS or out.dtype not in _FLOATS:
        raise TypeError(f"{name} takes f32/bf16 x and output, got {x.dtype} "
                        f"and {out.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous NHWC x")
    metas = blocks.metas
    if not 1 <= len(metas) <= MAX_BLOCKS:
        raise ValueError(f"{name} runs 1 to {MAX_BLOCKS} blocks, got {len(metas)}")
    prm_dtype = blocks.dtype
    ptrs, ints, keep = list(blocks.ptrs), list(blocks.ints), [blocks]

    def ptr(t):
        keep.append(t)
        return t.data_ptr()

    n, h, w, _ = x.shape
    xs_n = out_n = ds_n = 0  # largest block input, block output, shortcut
    for down, ci, co in metas:
        xs_n = max(xs_n, n * h * w * ci)
        if down:
            if h % 2 or w % 2:
                raise ValueError(f"{name}: a stride-2 block needs even H and W, "
                                 f"got {h}x{w}")
            h, w = h // 2, w // 2
            ds_n = n * h * w * ci
        out_n = max(out_n, n * h * w * co)
    classes = 0
    if wfc is not None:
        classes = wfc.shape[1]
        if tuple(wfc.shape) != (metas[-1][2], classes):
            raise ValueError(f"{name}: wfc {tuple(wfc.shape)}, expected "
                             f"({metas[-1][2]}, classes)")
        if bfc is not None and bfc.numel() != classes:
            raise ValueError(f"{name}: bfc has {bfc.numel()} values, expected {classes}")
    buf, act0, act1, xs, hs, ds, acc, accd, pooled = _carve(
        dev, [4 * out_n, 4 * out_n, xs_n, out_n, ds_n, 4 * out_n, 4 * out_n,
              4 * n * metas[-1][2]])
    keep.append(buf)
    ptrs += [x.data_ptr(), out.data_ptr(), act0, act1, xs, hs, ds, acc, accd,
             ptr(wfc.to(prm_dtype).contiguous()) if wfc is not None else 0,
             ptr(bfc.to(prm_dtype).reshape(-1).contiguous()) if bfc is not None else 0,
             pooled]
    act1_kind, act2_kind = split_act(acts)
    ints += [n, x.shape[1], x.shape[2], ACTS.index(act1_kind),
             ACTS.index(act2_kind), int(pre), int(zero_to_one),
             int(x.dtype == torch.bfloat16), int(out.dtype == torch.bfloat16),
             int(prm_dtype == torch.bfloat16), classes]
    if stem is not None:
        sx, sd = stem
        ptrs += [sx.data_ptr(), sd.wk.data_ptr(), sd.bias_f32.data_ptr()]
        ints += [sx.shape[1], sx.shape[2], sx.shape[3],
                 int(sx.dtype == torch.bfloat16), sd.w_pieces, sd.o_pad]
    err = _entry(name)(len(metas), (ctypes.c_void_p * len(ptrs))(*ptrs),
                       (ctypes.c_int * len(ints))(*ints),
                       torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
