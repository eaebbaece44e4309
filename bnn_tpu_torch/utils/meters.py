"""Training metrics (counterpart of ``bnn_tpu/utils/meters.py``; the
capability of the reference's ``examples/utils.py``)."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

__all__ = ["AverageMeter", "ProgressMeter", "accuracy", "count_parameters"]


class AverageMeter:
    """Streaming mean of a scalar metric.

    Tracks the last value and a weighted running sum; ``avg`` is derived on
    access. ``str()`` renders "name last (mean)" with the given format spec
    (the display contract of the reference's ``examples/utils.py:6-27``).
    """

    __slots__ = ("name", "fmt", "val", "sum", "count")

    def __init__(self, name: str = "", fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1) -> None:
        self.val = float(val)
        self.sum += self.val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def __str__(self) -> str:
        spec = self.fmt.lstrip(":")
        return (f"{self.name} {format(self.val, spec)}"
                f" ({format(self.avg, spec)})")


class ProgressMeter:
    """Renders one tab-joined progress line per displayed batch from a set
    of meters (the display contract of the reference's
    ``examples/utils.py:30-44``)."""

    def __init__(self, num_batches: int, meters: Sequence[AverageMeter],
                 prefix: str = ""):
        self._width = len(str(num_batches))
        self._total = num_batches
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int) -> None:
        head = f"{self.prefix}[{batch:{self._width}d}/{self._total}]"
        print("\t".join([head, *map(str, self.meters)]))


def accuracy(output: torch.Tensor, target: torch.Tensor,
             topk: Tuple[int, ...] = (1,)) -> list:
    """Top-k accuracy in percent for each k, from one top-k pass: a
    cumulative sum over the ranked-hit mask gives the hits within the top k
    for every k at once. k is clamped to the class count, so ``topk=(1, 5)``
    on a 2-class head does not fail."""
    maxk = min(max(topk), output.shape[-1])
    ranked_hit = output.topk(maxk, dim=-1).indices == target[:, None]
    pct_within = ranked_hit.float().cumsum(dim=1).mean(dim=0) * 100.0
    return [float(pct_within[min(k, maxk) - 1]) for k in topk]


def count_parameters(model: nn.Module) -> int:
    """Total trainable parameter count: the model's parameters, which are
    what the JAX package counts as ``nnx.Param`` (BatchNorm statistics and
    binarizer buffers are not parameters in either)."""
    return sum(p.numel() for p in model.parameters())
