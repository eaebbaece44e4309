"""Whole-stage fusion pass for small-batch serving (counterpart of
``bnn_tpu/inference/stages.py``).

:func:`fuse_stages` replaces a ResNet stage (``model.layerN``, an
``nn.Sequential`` of deployed BasicBlocks: an optional leading downsample
block, then stride-1 blocks) with :class:`FusedStage`, one
:func:`~bnn_tpu_torch.kernels.model.fused_chain` launch per forward.
:func:`fuse_head` folds the classifier's avgpool and float fc into the last
stage's launch. With the fused stem, a binary ResNet-18 is then five
launches per forward.

A stage fuses only when all its blocks share the first block's activation
kinds and sign(0) convention (the kernel applies those to every block) and
its int8 weights are at most 10 MB, the JAX package's gate
(``_MAX_STAGE_WEIGHT_BYTES``): ResNet-18's layer4 (9.4 MB) fuses, ResNet-34's
(14 MB) stays per block.

:func:`fuse_entry`, an opt-in applied after the others (the ``Predictor``
never applies it, as in the JAX package), merges the fused stem and the fused
stride-1 layer1 into :class:`FusedEntry`, one
:func:`~bnn_tpu_torch.kernels.model.fused_stem_chain` launch, bit-identical
to the two launches it replaces.

Each :class:`FusedStage` keeps the original Sequential for batches above its
cap and odd H or W; :func:`~bnn_tpu_torch.inference.megablock.fuse_blocks`,
applied afterwards, still wraps the blocks inside it. Its kernel-layout
arrays are buffers made once (the operator keeps the kernel arguments
derived from them), so ``cast_floats`` rounds the epilogue rows,
thresholds, slopes and fc weights as the JAX package's ``cast_floats``
rounds them; the kernel computes in f32 on the rounded values.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..binarize import set_module_by_name
from ..kernels.model import BlockParams, fused_chain, fused_stem_chain
from ..models.layers import BasicBlock, PreBasicBlock
from .megablock import (_act_kind, _conv_weight_int8, _eligible,
                        _eligible_down, _eligible_pre, _z21)
from .stem import FusedStem, _inner

__all__ = ["FusedStage", "fuse_stages", "fuse_head", "FusedEntry",
           "fuse_entry"]

# the JAX package's gate: a stage's weights had to stay resident in VMEM
_MAX_STAGE_WEIGHT_BYTES = 10 << 20
# fused_chain serves batches up to 8
_CHAIN_MAX_BATCH = 8


def _slope(act) -> Optional[torch.Tensor]:
    return _act_kind(act)[1]


def _basic_params(block) -> BlockParams:
    return BlockParams(
        "basic", _conv_weight_int8(block.conv1), _conv_weight_int8(block.conv2),
        scale1=block.conv1.scale, add1=block.conv1.add, prelu1=_slope(block.act1),
        scale2=block.conv2.scale, add2=block.conv2.add, prelu2=_slope(block.act2),
        threshold=block.conv1.threshold, threshold2=block.conv2.threshold)


def _down_params(block) -> BlockParams:
    dconv = block.downsample[1]
    return BlockParams(
        "down", _conv_weight_int8(block.conv1), _conv_weight_int8(block.conv2),
        wd=_conv_weight_int8(dconv).reshape(block.conv1.in_channels, -1),
        scale1=block.conv1.scale, add1=block.conv1.add, prelu1=_slope(block.act1),
        scale2=block.conv2.scale, add2=block.conv2.add, prelu2=_slope(block.act2),
        scaled=dconv.scale, addd=dconv.add,
        threshold=block.conv1.threshold, threshold2=block.conv2.threshold,
        thresholdd=dconv.threshold)


class FusedStage(nn.Module):
    """One-kernel execution of a whole deployed ResNet stage at small batch.

    The kernel runs iff the batch is at most ``min(max_fused_batch, 8)`` and
    H and W are even; otherwise the kept Sequential runs (then the kept
    avgpool and fc, if a head is attached). The kernel-layout arrays are
    snapshots: deploy again after changing the underlying layers.
    """

    def __init__(self, stage: nn.Sequential, *, kind: str, pre: bool = False,
                 max_fused_batch: int = 4):
        super().__init__()
        if kind not in ("pair", "down"):
            raise ValueError(f"kind must be 'pair' or 'down', got {kind!r}")
        self.stage = stage
        self.kind = kind
        self.pre = pre
        self.max_fused_batch = min(max_fused_batch, _CHAIN_MAX_BATCH)
        bps = [(_down_params if kind == "down" and i == 0 else _basic_params)(b)
               for i, b in enumerate(stage)]
        self._metas = [(bp.kind, bp.ci, bp.co) for bp in bps]
        self._n_arrays = []
        for i, bp in enumerate(bps):
            arrays = bp.arrays()
            self._n_arrays.append(len(arrays))
            for j, a in enumerate(arrays):
                self.register_buffer(f"p{i}_{j}", a)
        # captured now: fuse_blocks may later wrap the kept blocks
        b0 = stage[0]
        self._acts = (_act_kind(b0.act1)[0], _act_kind(b0.act2)[0])
        self._z21 = _z21(b0.conv1)
        self.head_pool = None
        self.head_fc = None
        self.register_buffer("wfc", None)
        self.register_buffer("bfc", None)

    def attach_head(self, avgpool: nn.Module, fc: nn.Linear) -> None:
        """Fold the trailing global avgpool and float fc into this stage's
        kernel; the modules are kept for the fallback path."""
        self.head_pool = avgpool
        self.head_fc = fc
        self.wfc = fc.weight.detach().t().contiguous()      # (C, classes)
        self.bfc = fc.bias.detach().clone() if fc.bias is not None else None

    def _params(self):
        """The blocks' parameters over the current buffers (the operator
        keeps their kernel arguments per buffers)."""
        return [BlockParams.from_arrays(
            meta, [getattr(self, f"p{i}_{j}") for j in range(k)])
            for i, (meta, k) in enumerate(zip(self._metas, self._n_arrays))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, _, h, w = x.shape
        if n > self.max_fused_batch or h % 2 or w % 2:
            y = self.stage(x)
            if self.head_fc is not None:
                y = self.head_fc(torch.flatten(self.head_pool(y), 1))
            return y
        xh = x.permute(0, 2, 3, 1).contiguous()
        if self.head_fc is not None:
            return fused_chain(xh, self._params(), self.wfc, self.bfc,
                               act=self._acts, pre=self.pre,
                               zero_to_one=self._z21)
        y = fused_chain(xh, self._params(), act=self._acts, pre=self.pre,
                        zero_to_one=self._z21, out_dtype=x.dtype)
        return y.permute(0, 3, 1, 2)


def _stage_weight_bytes(seq) -> int:
    """Int8 weight bytes of a stage, each conv counted as 3x3 (an upper
    bound for the 1x1 shortcut)."""
    total = 0
    for b in seq:
        convs = [b.conv1, b.conv2]
        if b.downsample is not None:
            convs.append(b.downsample[1])
        total += sum(9 * c.in_channels * c.out_channels for c in convs)
    return total


def _stage_eligible(seq) -> str:
    """'' | 'pair' | 'down', with a 'pre-' prefix for pre-activation
    stages: a leading (optionally downsample) block and any number of
    stride-1 blocks of the same type, activations and sign convention."""
    if not isinstance(seq, nn.Sequential) or len(seq) < 2:
        return ""
    blocks = list(seq)
    if not all(isinstance(b, (BasicBlock, PreBasicBlock)) for b in blocks):
        return ""
    if len({type(b) for b in blocks}) != 1:
        return ""
    pre = isinstance(blocks[0], PreBasicBlock)
    # the kernel applies block 0's activation kinds and sign convention to
    # every block: a mixed stage would compute wrong outputs, not fail
    sig0 = (_act_kind(blocks[0].act1)[0], _act_kind(blocks[0].act2)[0],
            _z21(blocks[0].conv1))
    for b in blocks[1:]:
        if b.downsample is not None:
            return ""
        if not (_eligible_pre(b) if pre else _eligible(b)):
            return ""
        sig = (_act_kind(b.act1)[0], _act_kind(b.act2)[0], _z21(b.conv1))
        if sig != sig0 or _z21(b.conv2) != sig0[2]:
            return ""
    if _z21(blocks[0].conv2) != sig0[2]:
        return ""
    if (blocks[0].downsample is not None
            and getattr(blocks[0].downsample[1], "zero_to_one", None)
            not in (None, sig0[2])):
        return ""
    if _stage_weight_bytes(seq) > _MAX_STAGE_WEIGHT_BYTES:
        return ""
    b0 = blocks[0]
    if b0.downsample is None:
        ok = _eligible_pre(b0) if pre else _eligible(b0)
        return ("pre-pair" if pre else "pair") if ok else ""
    if _eligible_down(b0):
        return "pre-down" if pre else "down"
    return ""


def fuse_stages(model: nn.Module, *, max_fused_batch: int = 4,
                kinds=("pair", "down")) -> int:
    """Replace eligible whole stages with :class:`FusedStage` (in place);
    returns how many. ``kinds`` restricts which stage shapes fuse."""
    fused = 0
    done = []
    for name, m in list(model.named_modules()):
        if isinstance(m, FusedStage):
            done.append(name + ".")
            continue
        if not name or any(name.startswith(p) for p in done):
            continue
        kind = _stage_eligible(m)
        if not kind or kind.replace("pre-", "") not in kinds:
            continue
        set_module_by_name(model, name, FusedStage(
            m, kind=kind.replace("pre-", ""), pre=kind.startswith("pre-"),
            max_fused_batch=max_fused_batch))
        done.append(name + ".")
        fused += 1
    return fused


def fuse_head(model: nn.Module) -> int:
    """Fold a ResNet's global avgpool and float fc into its fused layer4
    (in place): ``avgpool`` and ``fc`` become identities and the stage emits
    f32 logits. Returns the number of heads fused."""
    from ..models.resnet import ResNet

    fused = 0
    for m in list(model.modules()):
        if not isinstance(m, ResNet):
            continue
        stage = getattr(m, "layer4", None)
        if not isinstance(stage, FusedStage) or stage.head_fc is not None:
            continue
        if not isinstance(m.avgpool, nn.AdaptiveAvgPool2d):
            continue
        if m.avgpool.output_size not in (1, (1, 1)):
            continue
        if type(m.fc) is not nn.Linear:
            continue
        stage.attach_head(m.avgpool, m.fc)
        m.avgpool = nn.Identity()
        m.fc = nn.Identity()
        fused += 1
    return fused


class FusedEntry(nn.Module):
    """The network entry, the fused stem and the stride-1 layer1 stage, as
    one :func:`~bnn_tpu_torch.kernels.model.fused_stem_chain` launch.

    The kernel runs iff the batch is at most the stage's cap, H % 16 == 0
    and W % 8 == 0; otherwise ``stage(stem(x))``, the held
    :class:`~bnn_tpu_torch.inference.stem.FusedStem` and :class:`FusedStage`
    (same arrays), runs. The kernel reads the stem's descriptor that the
    held ``FusedStem`` holds, and rounds the stem's output to the IO dtype
    where the split pipeline's kernel boundary rounds it, so both give the
    same bits.
    """

    def __init__(self, stem, stage: FusedStage):
        super().__init__()
        self.stem = stem
        self.stage = stage

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, _, h, w = x.shape
        if n > self.stage.max_fused_batch or h % 16 or w % 8:
            return self.stage(self.stem(x))
        y = fused_stem_chain(
            x.permute(0, 2, 3, 1).contiguous(), *self.stem.weights(),
            self.stage._params(), act=self.stage._acts, pre=self.stage.pre,
            zero_to_one=self.stage._z21, out_dtype=x.dtype)
        return y.permute(0, 3, 1, 2)


def fuse_entry(model: nn.Module) -> int:
    """Merge a fused stem with the fused stride-1 layer1 that follows it (in
    place); apply after :func:`~bnn_tpu_torch.inference.stem.fuse_stem` and
    :func:`fuse_stages`. ``conv1`` becomes :class:`FusedEntry` and ``layer1``
    an identity. Returns the number of entries merged (0 on a second call)."""
    from ..models.resnet import ResNet

    fused = 0
    for m in list(model.modules()):
        if not isinstance(m, ResNet):
            continue
        stem, stage = m.conv1, m.layer1
        # a merged entry is a FusedEntry, not a FusedStem: idempotent
        if not (isinstance(stem, FusedStem) and isinstance(stage, FusedStage)):
            continue
        if stage.kind != "pair" or stage.head_fc is not None:
            continue
        if stage._metas[0][1] != _inner(stem.conv).out_channels:
            continue
        m.conv1 = FusedEntry(stem, stage)
        m.layer1 = nn.Identity()
        fused += 1
    return fused
