"""Model precision casting (counterpart of ``bnn_tpu/utils/precision.py``)."""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["cast_floats"]


def cast_floats(obj: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Cast every floating-point parameter and buffer of ``obj`` to ``dtype``,
    in place. Integer state (packed and int8 weights) is untouched, which is
    what ``nn.Module.to(dtype)`` does."""
    return obj.to(dtype)
