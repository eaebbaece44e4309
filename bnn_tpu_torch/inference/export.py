"""Serving-boundary batching (counterpart of ``bnn_tpu/inference/export.py``;
only :func:`batched_call` is ported so far)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["batched_call"]


def batched_call(one_batch, x: torch.Tensor, batch_size: int) -> torch.Tensor:
    """Pad ``x`` up to a multiple of ``batch_size`` rows, run ``one_batch``
    on each fixed-size chunk, concatenate and strip the padding rows."""
    n, bs = x.shape[0], batch_size
    if n == 0:
        # fabricating an output for zero rows would run a padded batch for
        # nothing; the contract violation is the caller's to hear about
        raise ValueError("empty request batch (0 rows)")
    padded_n = -(-n // bs) * bs
    if padded_n != n:
        x = F.pad(x, (0, 0) * (x.ndim - 1) + (0, padded_n - n))
    outs = [one_batch(x[i:i + bs]) for i in range(0, padded_n, bs)]
    out = torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]
    return out[:n]
