"""Binarization configuration (counterpart of ``bnn_tpu/bconfig.py``).

A dataclass of three binarizer *classes* (or ``with_args`` factories), never
instances:

- ``activation_pre_process``: applied to the layer input;
- ``activation_post_process``: applied to ``(layer_out, layer_in)``; its
  constructor receives the layer module;
- ``weight_pre_process``: applied to the layer weight.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

from torch import nn

from .ops.binarizers import Identity


@dataclass
class BConfig:
    activation_pre_process: Callable = Identity
    activation_post_process: Callable = Identity
    weight_pre_process: Callable = Identity

    def __post_init__(self) -> None:
        for f in dataclasses.fields(self):
            if isinstance(getattr(self, f.name), nn.Module):
                raise ValueError(
                    "BConfig received an instance, please pass the class instead."
                )
