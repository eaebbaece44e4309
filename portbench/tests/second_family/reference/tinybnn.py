"""The plain reference of the toy family (``families/tinybnn.py``)."""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from ..families.tinybnn import conv_layers
from .common import batch_norm, binary_conv, identity


class Forward:
    def __init__(self, config: dict, S: Dict[str, torch.Tensor], *,
                 train: bool = False, q: Callable = identity):
        self.config, self.S, self.train, self.q = config, S, train, q
        self.layers = {l["name"]: l for l in conv_layers(config)}

    def norm(self, x, name):
        return self.q(batch_norm(x, self.S, name, self.train))

    def binary_conv(self, x, name, stride, pad):
        return binary_conv(x, self.S, name, stride, pad, self.q)

    def stem(self, x):
        q, l = self.q, self.layers["conv1"]
        h = F.conv2d(q(x), q(self.S["conv1.weight"]), None, l["stride"], 1)
        return F.relu(self.norm(h, "bn1"))

    def conv(self, name, h):
        """A binary conv and its norm."""
        i = int(name.split(".")[1])
        l = self.layers[name]
        return self.norm(self.binary_conv(h, name, l["stride"], l["pad"]), f"features.{i + 1}")

    def head(self, h):
        q, S = self.q, self.S
        return F.linear(q(h.mean(dim=(2, 3))), q(S["fc.weight"]), q(S["fc.bias"]))

    def __call__(self, x):
        h = self.stem(x)
        for name, l in self.layers.items():
            if l["kind"] == "binary":
                i = int(name.split(".")[1])
                h = self.q(F.prelu(self.conv(name, h), self.q(self.S[f"features.{i + 2}.weight"])))
        return self.head(h)
