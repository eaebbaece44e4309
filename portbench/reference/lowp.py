"""The control's precision: the reference with every tensor the program
keeps in bf16 rounded to fp8 instead, as an fp8 port would keep it.

Each tensor is scaled to its own largest magnitude before the cast (a
per-tensor scale, as fp8 training and serving use; without it small values
would flush to zero), rounded, and scaled back. Forward values take E4M3;
gradients in the training step's backward take E5M2.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, fmt, fmax: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    if not torch.isfinite(amax) or amax == 0:
        return x
    s = fmax / amax
    return ((x.float() * s).to(fmt).float() / s).to(x.dtype)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """E4M3 rounding with a per-tensor scale (no gradient rule)."""
    return _round(x, torch.float8_e4m3fn, E4M3_MAX)


class _Fp8Train(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def fp8_train(x: torch.Tensor) -> torch.Tensor:
    """E4M3 forward, E5M2 gradient, each with a per-tensor scale."""
    return _Fp8Train.apply(x)
