"""BATS: Binary Architecture Search networks (counterpart of
``bnn_tpu/models/bats.py``).

The two public networks share one trunk (:class:`_CellNetwork`): a stack of
genotype-compiled cells with channel doubling and reduction at the 1/3 and
2/3 depth marks, an optional auxiliary classifier tapped at the 2/3 mark,
and a pooled linear head. They differ in their stems and pooling.

The stems are registered first, then the cells, the auxiliary head and the
classifier, as in the JAX package: ``_first_`` is the stem's conv and
``_last_`` the classifier. Drop-path and shake-shake run in train mode and
draw from the network's :class:`~bnn_tpu_torch.ops.binarizers.RandomStream`
(``noise``: seeded, one generator per device, carried by ``state_dict``).
Set ``model.drop_path_prob`` between epochs, as in the reference.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..nn import BatchNorm2d
from ..ops.binarizers import RandomStream
from .layers.bats_ops import (OPS, FactorizedReduce, Genotype, ReLUConvBN,
                              drop_path)

__all__ = ["BATS_EXAMPLE", "Cell", "AuxiliaryHead", "BATSNetworkCIFAR",
           "BATSNetworkImageNet"]

# an example genotype (DARTS-V2-style topology), so that the networks are
# usable out of the box; searched BATS genotypes can be passed instead
BATS_EXAMPLE = Genotype(
    normal=[("sep_conv_3x3", 0), ("sep_conv_3x3", 1),
            ("sep_conv_3x3", 0), ("sep_conv_3x3", 1),
            ("sep_conv_3x3", 1), ("skip_connect", 0),
            ("skip_connect", 0), ("dil_conv_3x3", 2)],
    normal_concat=[2, 3, 4, 5],
    reduce=[("max_pool_3x3", 0), ("max_pool_3x3", 1),
            ("skip_connect", 2), ("max_pool_3x3", 1),
            ("max_pool_3x3", 0), ("skip_connect", 2),
            ("skip_connect", 2), ("max_pool_3x3", 1)],
    reduce_concat=[2, 3, 4, 5],
)


class Cell(nn.Module):
    """One genotype-compiled DAG cell.

    Each intermediate node sums two op-transformed predecessor states; the
    cell output concatenates the genotype's ``concat`` nodes along channels
    (``multiplier = len(concat)`` times C channels). A reduction cell
    strides every op that reads a cell input by 2."""

    def __init__(self, genotype: Genotype, C_prev_prev: int, C_prev: int,
                 C: int, reduction: bool, reduction_prev: bool,
                 groups: int = 12, use_shake_shake: bool = False):
        super().__init__()
        self.use_shake_shake = use_shake_shake
        # the inputs arrive at different resolutions after a reduction:
        # align s0 with a factorized reduce, else a 1x1 ReLUConvBN
        self.preprocess0 = (FactorizedReduce(C_prev_prev, C) if reduction_prev
                            else ReLUConvBN(C_prev_prev, C, 1, 1, 0))
        self.preprocess1 = ReLUConvBN(C_prev, C, 1, 1, 0)

        edges = list(genotype.reduce if reduction else genotype.normal)
        self._concat = list(genotype.reduce_concat if reduction
                            else genotype.normal_concat)
        self.multiplier = len(self._concat)
        self._steps = len(edges) // 2
        self._indices = [src for _, src in edges]
        self._ops = nn.ModuleList(
            OPS[name](C, 2 if reduction and src < 2 else 1, True, True, groups)
            for name, src in edges)

    def _edge(self, op, state, drop_prob, generator):
        h = op(state)
        if drop_prob > 0.0 and self.training and not isinstance(op, nn.Identity):
            h = drop_path(h, drop_prob, generator)
        return h

    def _gather(self, states: List[torch.Tensor], generator) -> torch.Tensor:
        outs = [states[i] for i in self._concat]
        if self.use_shake_shake:
            if not self.training:
                outs = [o / len(outs) for o in outs]
            else:
                mix = torch.softmax(torch.rand(
                    (len(outs),), generator=generator, device=outs[0].device), 0)
                outs = [o * mix[j].to(o.dtype) for j, o in enumerate(outs)]
        return torch.cat(outs, dim=1)

    def forward(self, s0: torch.Tensor, s1: torch.Tensor, drop_prob: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` gives drop-path's and shake-shake's draws (torch's
        default generator when None)."""
        states = [self.preprocess0(s0), self.preprocess1(s1)]
        for i in range(self._steps):
            a, b = self._indices[2 * i], self._indices[2 * i + 1]
            states.append(
                self._edge(self._ops[2 * i], states[a], drop_prob, generator)
                + self._edge(self._ops[2 * i + 1], states[b], drop_prob, generator))
        return self._gather(states, generator)


class AuxiliaryHead(nn.Module):
    """Auxiliary classifier head."""

    def __init__(self, C: int, num_classes: int, stride: int):
        super().__init__()
        self.features = nn.Sequential(
            nn.AvgPool2d(5, stride=stride, padding=0, count_include_pad=False),
            BatchNorm2d(C),
            nn.Conv2d(C, 128, 1, bias=False),
            nn.PReLU(num_parameters=128),
            BatchNorm2d(128),
            nn.Conv2d(128, 768, 2, bias=False),
            nn.PReLU(num_parameters=768),
        )
        self.classifier = nn.Linear(768, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(torch.flatten(self.features(x), 1))


@torch.no_grad()
def _init_weights(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Draw every conv and linear weight (and bias) from ``generator`` with
    torch's default init, ``kaiming_uniform(a=sqrt(5))`` over fan-in."""
    if generator is None:
        return
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            for t in (m.weight, m.bias):
                if t is not None:
                    t.copy_((2 * torch.rand(t.shape, generator=generator) - 1)
                            * bound)


class _CellNetwork(nn.Module):
    """The cell-stack trunk behind both BATS networks. ``stems`` are
    registered before the cells, in their order; ``stem_states`` maps the
    input to the first two cell inputs."""

    def __init__(self, stems: Dict[str, nn.Module], C: int, num_classes: int,
                 layers: int, auxiliary: bool, genotype: Genotype, groups: int,
                 chans_in: Tuple[int, int], reduction_prev: bool,
                 aux_stride: int, pooling: nn.Module,
                 generator: Optional[torch.Generator], seed: int):
        super().__init__()
        for name, module in stems.items():
            setattr(self, name, module)
        self._layers = layers
        self._auxiliary = auxiliary
        self._aux_at = 2 * layers // 3
        self.drop_path_prob = 0.0

        self.cells = nn.ModuleList()
        c_pp, c_p = chans_in
        c = C
        aux_chans = None
        for depth in range(layers):
            reduction = depth in (layers // 3, self._aux_at)
            if reduction:
                c *= 2
            cell = Cell(genotype, c_pp, c_p, c, reduction, reduction_prev, groups)
            self.cells.append(cell)
            reduction_prev = reduction
            c_pp, c_p = c_p, cell.multiplier * c
            if depth == self._aux_at:
                aux_chans = c_p
        if auxiliary:
            self.auxiliary_head = AuxiliaryHead(aux_chans, num_classes, aux_stride)
        self.classifier = nn.Linear(c_p, num_classes)
        self.global_pooling = pooling
        self.noise = RandomStream(seed=seed)
        _init_weights(self, generator)

    def stem_states(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``(logits, aux_logits)``; ``aux_logits`` is None unless the
        network is in train mode and has an auxiliary head."""
        generator = self.noise.generator(x.device) if self.training else None
        s0, s1 = self.stem_states(x)
        logits_aux = None
        for depth, cell in enumerate(self.cells):
            s0, s1 = s1, cell(s0, s1, self.drop_path_prob, generator)
            if depth == self._aux_at and self._auxiliary and self.training:
                logits_aux = self.auxiliary_head(s1)
        pooled = self.global_pooling(s1)
        return self.classifier(torch.flatten(pooled, 1)), logits_aux


class BATSNetworkCIFAR(_CellNetwork):
    """CIFAR-scale BATS network: one 3x3 stem feeding both cell inputs.
    ``generator`` draws the conv and linear weights (torch's global
    generator when None); ``seed`` seeds the drop-path stream."""

    def __init__(self, C: int, num_classes: int, layers: int, auxiliary: bool,
                 genotype: Genotype, groups: int = 12, *,
                 generator: Optional[torch.Generator] = None, seed: int = 0):
        stem_width = 3 * C
        stem = nn.Sequential(
            nn.Conv2d(3, stem_width, 3, padding=1, bias=False),
            BatchNorm2d(stem_width),
            nn.ReLU(),
        )
        super().__init__({"stem": stem}, C, num_classes, layers, auxiliary,
                         genotype, groups, chans_in=(stem_width, stem_width),
                         reduction_prev=False, aux_stride=3,
                         pooling=nn.AdaptiveAvgPool2d(1), generator=generator,
                         seed=seed)

    def stem_states(self, x):
        s = self.stem(x)
        return s, s


class BATSNetworkImageNet(_CellNetwork):
    """ImageNet-scale BATS network: a two-stage grouped-conv stem giving the
    cells' two inputs at x4 and x8 downsampling."""

    def __init__(self, C: int, num_classes: int, layers: int, auxiliary: bool,
                 genotype: Genotype, groups: int = 12, *,
                 generator: Optional[torch.Generator] = None, seed: int = 0):
        g = max(C // 20, 1)
        stem0 = nn.Sequential(
            nn.Conv2d(3, C // 2, kernel_size=3, stride=2, padding=1, bias=False),
            BatchNorm2d(C // 2),
            nn.ReLU(),
            nn.Conv2d(C // 2, C, 3, stride=2, padding=1, bias=False, groups=g),
            BatchNorm2d(C),
        )
        stem1 = nn.Sequential(
            nn.ReLU(),
            nn.Conv2d(C, C, 3, stride=2, padding=1, bias=False, groups=g),
            BatchNorm2d(C),
        )
        super().__init__({"stem0": stem0, "stem1": stem1}, C, num_classes,
                         layers, auxiliary, genotype, groups, chans_in=(C, C),
                         reduction_prev=True, aux_stride=2,
                         pooling=nn.AvgPool2d(7), generator=generator, seed=seed)

    def stem_states(self, x):
        s0 = self.stem0(x)
        return s0, self.stem1(s0)
