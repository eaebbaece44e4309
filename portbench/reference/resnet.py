"""The plain reference of the ResNet family: the binary ResNet's forward,
in plain PyTorch, from the tensors the benchmark made; its eval-mode logits
and QAT training step with AdamW are :mod:`portbench.reference.common`'s
over this ``Forward``.

It imports nothing of the measured program. It works out for itself what
the program derives from those tensors: the ternary signs of the
activations (``sign(0) = 0``), the XNOR weights ``sign(W) * mean|W|`` per
output channel, the learned output scales, the norms (running statistics
in eval mode; in train mode the batch mean and the two-pass biased variance,
``(x - mean) * (rsqrt(var + eps) * weight) + bias``), the projection
shortcut (average pool, binary 1x1 conv, norm) and the float stem and head.
Gradients pass the signs straight through where ``|x| < 1`` (hardtanh), and
reach ``mean|W|`` with ``d|w|/dw = +1`` at ``w = 0``.

``q`` is applied wherever the program keeps a tensor in its own precision
(the input, float weights, every layer's output); the identity gives the
reference itself, :mod:`portbench.reference.lowp` the control in a lower
precision. Matrix products run in the dtype of the tensors handed in, with
TF32 off (:func:`~portbench.reference.common.exact_matmul`).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from ..families.resnet import blocks
from .common import batch_norm, binary_conv, identity


class Forward:
    """The network of ``config`` over the state ``S`` (name -> tensor)."""

    def __init__(self, config: dict, S: Dict[str, torch.Tensor], *,
                 train: bool = False, q: Callable = identity):
        self.config, self.S, self.train, self.q = config, S, train, q
        self.blocks = list(blocks(config))

    def norm(self, x, name):
        return self.q(batch_norm(x, self.S, name, self.train))

    def binary_conv(self, x, name, stride, pad):
        return binary_conv(x, self.S, name, stride, pad, self.q)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """The float stem: conv, norm, relu and max pool (layer1's input)."""
        q = self.q
        h = F.conv2d(q(x), q(self.S["conv1.weight"]), None, 2, 3)
        return F.max_pool2d(F.relu(self.norm(h, "bn1")), 3, 2, 1)

    def stage(self, s: int, h: torch.Tensor) -> torch.Tensor:
        """Stage ``s`` (``layer<s>``) on its input."""
        for blk in self.blocks:
            if blk["stage"] == s:
                h = self.block(blk, h)
        return h

    def block(self, blk: dict, h: torch.Tensor) -> torch.Tensor:
        p = blk["prefix"]
        shortcut = h
        if blk["downsample"]:
            s = blk["stride"]
            pooled = F.avg_pool2d(h, s, s, 0, ceil_mode=True,
                                  count_include_pad=False) if s > 1 else h
            shortcut = self.norm(self.binary_conv(pooled, p + "downsample.1", 1, 0),
                                 p + "downsample.2")
        t = h
        n = len(blk["units"])
        for u, (_, _, k, st) in enumerate(blk["units"], 1):
            t = self.norm(self.binary_conv(t, f"{p}conv{u}", st, k // 2), f"{p}bn{u}")
            if u < n:
                t = F.relu(t)
        return self.q(F.relu(t + shortcut))

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """Global average pool and the float dense layer."""
        q, S = self.q, self.S
        return F.linear(q(h.mean(dim=(2, 3))), q(S["fc.weight"]), q(S["fc.bias"]))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        h = self.stem(x)
        for s in range(1, len(self.config["layers"]) + 1):
            h = self.stage(s, h)
        return self.head(h)
