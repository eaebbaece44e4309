"""A whole residual stage in one kernel (counterpart of
``bnn_tpu/kernels/model.py``): an optional leading stride-2 block, then
stride-1 basic blocks, then optionally the global avgpool and a float fc.

:func:`fused_chain` (and :func:`fused_pair`, :func:`fused_down_stage`, which
call it) calls the ``bnn_tpu_torch::fused_chain`` operator
(``kernels/ops.py``) on the blocks' arrays (:func:`flatten`), which launches
the hand-written Hopper kernel ``bnn_tpu_torch/csrc/fused_chain.cu`` for
CUDA tensors (:func:`fused_chain_cuda`) and takes
:func:`fused_chain_reference`, its plain version, only for CPU tensors.
Between blocks the activations stay f32, as in the JAX kernel; the output
is in x's dtype, or f32 logits with the head. :class:`BlockParams` holds a
block's parameters in the JAX kernel's layouts, so its :meth:`arrays` equal
the JAX ones bit for bit.

Bound on an H100: each stage moves its int8 weights once (0.15 MB for
ResNet-18's layer1, 8.4 MB for layer4, whose 1000-class head adds 1 MB of
bf16 weights), which bounds it at batch 1; at batch 4 layers 1-3 are bound
by their int8 operations. The kernel runs a stage as one cooperative launch
over the card, its convolutions on the int8 tensor cores
(csrc/fused_chain.cu), which read K-major copies of the weights that each
block's descriptor makes (``_blocks.Desc.kmajor``), kept per arrays;
:meth:`BlockParams.arrays` stays the JAX layout.

:func:`fused_stem_chain` runs the network entry, the float stem and then
layer1's stride-1 blocks, as one launch of ``csrc/fused_stem_chain.cu``
(plain version :func:`fused_stem_chain_reference`); it equals
``fused_chain(fused_stem(x))`` bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import _blocks as B
from .block import fused_basic_block_reference
from .stem import (StemDesc, _check_geometry, check_x, fused_stem_reference,
                   kept_stem, stem_key)
from .strided_block import (_transform_w1, _untransform_w1,
                            fused_downsample_block_reference)

__all__ = ["BlockParams", "KINDS", "flatten", "unflatten", "kept_args",
           "fused_chain",
           "fused_chain_cuda", "fused_stem_chain_cuda", "fused_pair",
           "fused_down_stage",
           "fused_chain_reference", "fused_pair_reference",
           "fused_down_stage_reference", "fused_stem_chain",
           "fused_stem_chain_reference"]

_MAX_BATCH = 8


def _rows(vals, widths, device) -> torch.Tensor:
    return torch.stack([B.row(v, d, w, device) for v, (d, w) in zip(vals, widths)])


class BlockParams:
    """Folded parameters of one deployed block, in the kernel's layouts.

    ``kind='basic'``: w1/w2 ``(3, 3, C, C)``; ``kind='down'``: w1
    ``(3, 3, C, Co)`` stride 2, w2 ``(3, 3, Co, Co)``, wd ``(C, Co)``.
    Weights +/-1 int8. Stored as basic ``w1, w2 (9C, C)``, ``prm (8, C)``
    rows (scale1, add1, prelu1, scale2, add2, prelu2, threshold,
    threshold2); down ``w1 (16C, Co)`` s2d, ``w2 (9Co, Co)``, ``wd (C, Co)``,
    ``po (9, Co)`` rows (scale1, add1, prelu1, scale2, add2, prelu2, scaled,
    addd, threshold2) and ``pi (2, 4C)`` (threshold and thresholdd, each
    tiled four times).
    """

    def __init__(self, kind, w1, w2, wd=None, scale1=None, add1=None,
                 prelu1=None, scale2=None, add2=None, prelu2=None,
                 scaled=None, addd=None, threshold=None, threshold2=None,
                 thresholdd=None):
        if kind not in ("basic", "down"):
            raise ValueError(f"kind must be 'basic' or 'down', got {kind!r}")
        self.kind = kind
        ci, co = w1.shape[2], w1.shape[3]
        dev = w1.device
        if kind == "basic":
            self.w1 = w1.to(torch.int8).reshape(9 * ci, co).contiguous()
            self.w2 = w2.to(torch.int8).reshape(9 * ci, co).contiguous()
            self.prm = _rows(
                [scale1, add1, prelu1, scale2, add2, prelu2, threshold,
                 threshold2],
                [(1.0, co), (0.0, co), (0.25, co)] * 2 + [(0.0, co), (0.0, co)],
                dev)
        else:
            self.w1 = _transform_w1(w1.to(torch.int8))
            self.w2 = w2.to(torch.int8).reshape(9 * co, co).contiguous()
            self.wd = wd.to(torch.int8).reshape(ci, co).contiguous()
            self.po = _rows(
                [scale1, add1, prelu1, scale2, add2, prelu2, scaled, addd,
                 threshold2],
                [(1.0, co), (0.0, co), (0.25, co)] * 2
                + [(1.0, co), (0.0, co), (0.0, co)], dev)
            self.pi = torch.stack([B.row(threshold, 0.0, ci, dev).repeat(4),
                                   B.row(thresholdd, 0.0, ci, dev).repeat(4)])
        self.ci, self.co = ci, co

    def arrays(self):
        """Kernel-layout arrays in a fixed order."""
        if self.kind == "basic":
            return [self.w1, self.w2, self.prm]
        return [self.w1, self.w2, self.wd, self.po, self.pi]

    @classmethod
    def from_arrays(cls, meta, arrays) -> "BlockParams":
        """Rebuild from ``(kind, ci, co)`` and :meth:`arrays` without
        re-running the layout transforms."""
        kind, ci, co = meta
        bp = cls.__new__(cls)
        bp.kind, bp.ci, bp.co = kind, ci, co
        if kind == "basic":
            bp.w1, bp.w2, bp.prm = arrays
        else:
            bp.w1, bp.w2, bp.wd, bp.po, bp.pi = arrays
        return bp

    def desc(self) -> B.Desc:
        """The kernel's descriptor (made once); rows point into the stored
        arrays."""
        if getattr(self, "_desc", None) is None:
            if self.kind == "basic":
                p = self.prm
                self._desc = B.Desc(False, self.ci, self.co, self.w1, self.w2,
                                    None, [(p, 0), (p, 1), (p, 2), (p, 3),
                                           (p, 4), (p, 5), None, None, (p, 7),
                                           (p, 6), None])
            else:
                p, q = self.po, self.pi
                self._desc = B.Desc(True, self.ci, self.co, self.w1, self.w2,
                                    self.wd, [(p, i) for i in range(9)]
                                    + [(q, 0), (q, 1)])
        return self._desc


def _check_blocks(blocks: Sequence[BlockParams]) -> None:
    plan = tuple(b.kind for b in blocks)
    if not plan or any(k != "basic" for k in plan[1:]):
        raise ValueError(f"a chain is an optional leading 'down' block and "
                         f"'basic' blocks, got {plan}")
    for a, b in zip(blocks, blocks[1:]):
        if b.ci != a.co:
            raise ValueError(f"block widths do not chain: {a.co} -> {b.ci}")


def _check_x(x: torch.Tensor, metas) -> None:
    """x against the chain's blocks' ``(down, ci, co)``."""
    if x.ndim != 4 or x.shape[-1] != metas[0][1]:
        raise ValueError(f"x {tuple(x.shape)} does not feed a block of "
                         f"{metas[0][1]} input channels")
    if x.shape[0] > _MAX_BATCH:
        raise ValueError(f"stage megakernels serve batches up to {_MAX_BATCH}, "
                         f"got {x.shape[0]}; larger batches take the "
                         "per-block or unfused paths")


def _check_chain(x: torch.Tensor, blocks: Sequence[BlockParams]):
    _check_blocks(blocks)
    _check_x(x, [(b.kind == "down", b.ci, b.co) for b in blocks])


KINDS = ("basic", "down")


def flatten(blocks: Sequence[BlockParams]):
    """``(arrays, kinds)``: every block's :meth:`BlockParams.arrays` in one
    list and each block's index in :data:`KINDS`, as the chain operators
    take them."""
    return ([a for b in blocks for a in b.arrays()],
            [KINDS.index(b.kind) for b in blocks])


def unflatten(arrays, kinds) -> list:
    """The :class:`BlockParams` of :func:`flatten`'s ``(arrays, kinds)``."""
    blocks, i = [], 0
    for k in kinds:
        kind = KINDS[k]
        n = 3 if kind == "basic" else 5
        w1 = arrays[i]
        ci = w1.shape[1] if kind == "basic" else w1.shape[0] // 16
        blocks.append(BlockParams.from_arrays((kind, ci, w1.shape[1]),
                                              list(arrays[i:i + n])))
        i += n
    if i != len(arrays):
        raise ValueError(f"{len(arrays)} arrays for blocks of kinds "
                         f"{[KINDS[k] for k in kinds]}")
    return blocks


def fused_chain(
    x: torch.Tensor,
    blocks: Sequence[BlockParams],
    wfc: Optional[torch.Tensor] = None,
    bfc: Optional[torch.Tensor] = None,
    *,
    act="relu",
    pre: bool = False,
    zero_to_one: bool = True,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """A whole residual stage, any chain of [down] + basic* blocks, in one
    kernel; with ``wfc`` (``(C_out, classes)``) also the global avgpool and
    the fc, giving ``(N, classes)`` logits (f32 unless ``out_dtype``).
    Calls the ``bnn_tpu_torch::fused_chain`` operator (``kernels/ops.py``)
    on the blocks' :meth:`BlockParams.arrays` and their kinds.

    ``x``: ``(N, H, W, C)`` raw stage input, N <= 8, f32 or bf16.
    """
    _check_chain(x, blocks)
    act1, act2 = B.split_act(act)
    arrays, kinds = flatten(blocks)
    return torch.ops.bnn_tpu_torch.fused_chain(
        x, arrays, kinds, wfc, bfc, act1, act2, pre, zero_to_one, out_dtype)


def kept_args(name, arrays, kinds, device, floats=()) -> B.KeptBlocks:
    """The chain's kernel arguments on ``device`` (``_blocks.kept_blocks``;
    ``floats``: the head's weights, whose dtype joins the rows'), made once
    per arrays and kept while they live unchanged."""
    def descs():
        blocks = unflatten(arrays, kinds)
        _check_blocks(blocks)
        return [b.desc() for b in blocks]

    return B.kept_blocks(name, arrays, device, descs, floats)


def fused_chain_cuda(x, arrays, kinds, wfc, bfc, act1, act2, pre, zero_to_one,
                     out_dtype) -> torch.Tensor:
    """The ``fused_chain`` operator's CUDA implementation: one launch, with
    the blocks' kernel arguments (K-major copies, flat arrays) kept per
    arrays (``_blocks.KEPT``)."""
    blocks = kept_args("fused_chain", arrays, kinds, x.device, (wfc, bfc))
    _check_x(x, blocks.metas)
    n, h, w, _ = x.shape
    if blocks.metas[0][0]:
        h, w = h // 2, w // 2
    if wfc is not None:
        out = torch.empty((n, wfc.shape[-1]), dtype=torch.float32, device=x.device)
    else:
        out = torch.empty((n, h, w, blocks.metas[-1][2]),
                          dtype=x.dtype if out_dtype is None else out_dtype,
                          device=x.device)
    B.launch("fused_chain", x, blocks, out, acts=(act1, act2), pre=pre,
             zero_to_one=zero_to_one, wfc=wfc, bfc=bfc)
    fused_chain.launches += 1
    if wfc is not None and out_dtype not in (None, torch.float32):
        return out.to(out_dtype)
    return out


fused_chain.launches = 0


def fused_pair(x, blocks, **kw):
    """Two or more stride-1 blocks (a whole layer1) in one kernel; see
    :func:`fused_chain`."""
    if not all(b.kind == "basic" for b in blocks):
        raise ValueError("fused_pair takes stride-1 'basic' blocks only")
    return fused_chain(x, blocks, **kw)


def fused_down_stage(x, blocks, wfc=None, bfc=None, **kw):
    """A stride-2 stage (down + stride-1 blocks) in one kernel; see
    :func:`fused_chain`."""
    if not blocks or blocks[0].kind != "down":
        raise ValueError("fused_down_stage needs a leading 'down' block")
    return fused_chain(x, blocks, wfc, bfc, **kw)


def _basic_ref(a, bp, acts, pre, z21):
    c, p = bp.ci, bp.prm
    return fused_basic_block_reference(
        a, bp.w1.reshape(3, 3, c, c), bp.w2.reshape(3, 3, c, c),
        p[0], p[1], p[3], p[4], act=acts, prelu1=p[2], prelu2=p[5],
        threshold=p[6], threshold2=p[7], pre=pre, zero_to_one=z21,
        out_dtype=torch.float32)


def _down_ref(a, bp, acts, pre, z21):
    ci, co, p, q = bp.ci, bp.co, bp.po, bp.pi
    return fused_downsample_block_reference(
        a, _untransform_w1(bp.w1, ci), bp.w2.reshape(3, 3, co, co), bp.wd,
        p[0], p[1], p[3], p[4], p[6], p[7], act=acts, prelu1=p[2],
        prelu2=p[5], threshold1=q[0, :ci], threshold2=p[8],
        thresholdd=q[1, :ci], pre=pre, zero_to_one=z21,
        out_dtype=torch.float32)


def fused_chain_reference(x, blocks, wfc=None, bfc=None, *, act="relu",
                          pre=False, zero_to_one=True, out_dtype=None):
    """Plain PyTorch version of :func:`fused_chain`."""
    _check_chain(x, blocks)
    acts = B.split_act(act)
    a = x.to(torch.float32)
    for b in blocks:
        a = (_down_ref if b.kind == "down" else _basic_ref)(a, b, acts, pre,
                                                            zero_to_one)
    if wfc is None:
        return a.to(x.dtype if out_dtype is None else out_dtype)
    return B.head(a, wfc, bfc).to(torch.float32 if out_dtype is None else out_dtype)


def fused_pair_reference(x, blocks, *, act="relu", pre=False,
                         zero_to_one=True, out_dtype=None):
    """Plain PyTorch version of :func:`fused_pair`."""
    return fused_chain_reference(x, blocks, act=act, pre=pre,
                                 zero_to_one=zero_to_one, out_dtype=out_dtype)


fused_down_stage_reference = fused_chain_reference


def _check_stem_chain(x: torch.Tensor, w: torch.Tensor,
                      blocks: Sequence[BlockParams]) -> None:
    _check_geometry(x, w)
    n, h, ws, _ = x.shape
    if n > _MAX_BATCH:
        raise ValueError(f"fused_stem_chain serves batches up to {_MAX_BATCH}, "
                         f"got {n}")
    if h % 16 or ws % 8:
        raise ValueError(f"fused_stem_chain needs H % 16 == 0 and W % 8 == 0, "
                         f"got x {tuple(x.shape)}")
    plan = tuple(b.kind for b in blocks)
    if not plan or any(k != "basic" for k in plan):
        raise ValueError(f"fused_stem_chain takes stride-1 'basic' blocks "
                         f"only, got {plan}")
    if blocks[0].ci != w.shape[-1]:
        raise ValueError(f"the stem's {w.shape[-1]} channels do not feed a "
                         f"block of {blocks[0].ci} input channels")
    for a, b in zip(blocks, blocks[1:]):
        if b.ci != a.co:
            raise ValueError(f"block widths do not chain: {a.co} -> {b.ci}")


def fused_stem_chain(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor],
    blocks: Sequence[BlockParams],
    *,
    act="relu",
    pre: bool = False,
    zero_to_one: bool = True,
    out_dtype: Optional[torch.dtype] = None,
    stem: Optional[StemDesc] = None,
) -> torch.Tensor:
    """The network entry in one kernel: ``maxpool3x3/s2/p1(relu(
    conv7x7/s2/p3(x, w) + bias))``, rounded to the IO dtype (``out_dtype``,
    else x's) as the split pipeline's kernel boundary rounds it, then
    layer1's stride-1 blocks; the ``bnn_tpu_torch::fused_stem_chain``
    operator (``kernels/ops.py``).

    ``x``: ``(N, H, W, C)`` raw input, N <= 8, C <= 4, H % 16 == 0,
    W % 8 == 0; ``w``: ``(7, 7, C, O)`` HWIO stem kernel (BN folded);
    ``blocks``: ``basic`` BlockParams with ``blocks[0].ci == O``; ``stem``:
    a :class:`~bnn_tpu_torch.kernels.stem.StemDesc` of ``w`` and ``bias``,
    checked (a descriptor of other tensors is refused; the operator keeps
    its own :func:`~bnn_tpu_torch.kernels.stem.kept_stem`). Returns
    ``(N, H/4, W/4, C_out)`` in the IO dtype.
    """
    _check_stem_chain(x, w, blocks)
    if stem is not None and stem.key != stem_key(w, bias):
        raise ValueError("fused_stem_chain's stem descriptor was built from other "
                         "weights than w and bias")
    act1, act2 = B.split_act(act)
    arrays, kinds = flatten(blocks)
    return torch.ops.bnn_tpu_torch.fused_stem_chain(
        x, w, bias, arrays, kinds, act1, act2, pre, zero_to_one, out_dtype)


def fused_stem_chain_cuda(x, w, bias, arrays, kinds, act1, act2, pre,
                          zero_to_one, out_dtype) -> torch.Tensor:
    """The ``fused_stem_chain`` operator's CUDA implementation: one launch,
    with the stem's weights (:func:`~bnn_tpu_torch.kernels.stem.kept_stem`)
    and the blocks' kernel arguments kept (``_blocks.KEPT``)."""
    _check_stem_chain(x, w, unflatten(arrays, kinds))
    check_x(x, w, "fused_stem_chain")
    sw = kept_stem(w, bias)
    blocks = kept_args("fused_stem_chain", arrays, kinds, x.device)
    io = x.dtype if out_dtype is None else out_dtype
    n, h, ws, _ = x.shape
    stem_out = torch.empty((n, h // 4, ws // 4, sw.o), dtype=io, device=x.device)
    out = torch.empty((n, h // 4, ws // 4, blocks.metas[-1][2]), dtype=io,
                      device=x.device)
    B.launch("fused_stem_chain", stem_out, blocks, out, acts=(act1, act2),
             pre=pre, zero_to_one=zero_to_one, stem=(x, sw))
    fused_stem_chain.launches += 1
    return out


fused_stem_chain.launches = 0


def fused_stem_chain_plan(x: torch.Tensor, stem: StemDesc) -> dict:
    """The stem phase of a :func:`fused_stem_chain` launch on ``x``: pooled
    rows per work item, items, blocks of the cooperative grid and blocks
    per SM (its registers and shared memory decide them)."""
    fn = B.load("fused_stem_chain").bnn_fused_stem_chain_plan
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    n, h, w, _ = x.shape
    err = fn(n, h, w, stem.o_pad, out)
    if err:
        raise RuntimeError(f"fused_stem_chain plan failed: CUDA error {err}")
    return dict(zip(("rows", "items", "blocks", "blocks_per_sm"), out))


def fused_stem_chain_reference(x, w, bias, blocks, *, act="relu", pre=False,
                               zero_to_one=True, out_dtype=None):
    """Plain PyTorch version of :func:`fused_stem_chain`: the stem's plain
    version in f32, rounded to the IO dtype, then the chain's."""
    _check_stem_chain(x, w, blocks)
    io = x.dtype if out_dtype is None else out_dtype
    y = fused_stem_reference(x.to(torch.float32), w, bias).to(io)
    return fused_chain_reference(y, blocks, act=act, pre=pre,
                                 zero_to_one=zero_to_one, out_dtype=io)
