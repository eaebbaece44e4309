"""Straight-through estimators (counterpart of ``bnn_tpu/ops/ste.py``).

Each STE is a ``torch.autograd.Function``: the forward is the sign the JAX
package computes, the backward the same surrogate gradient. The forwards are
what serving needs; the gradients are held against JAX with the training
path. :class:`SignActivation` and :class:`SignActivationStochastic` are the
reference's own Functions (bnn/ops.py:51-92), under its names.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = [
    "sign",
    "sign_ste",
    "sign_pm1_ste",
    "stochastic_sign_ste",
    "surrogate_sign",
    "resolve_surrogate",
    "SURROGATES",
    "tanh_surrogate_sign",
    "SignActivation",
    "SignActivationStochastic",
]


def sign(x: torch.Tensor) -> torch.Tensor:
    """Element-wise sign with sign(0) == 0 (``torch.sign``)."""
    return torch.sign(x)


def _hardtanh_mask(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    # pass the cotangent where |x| < 1 strictly, zero elsewhere
    return torch.where((x > -1.0) & (x < 1.0), g, torch.zeros_like(g))


class _Callable:
    """Lets an instance of an autograd Function be called as ``apply``, as
    the JAX package's shims are (torch warns on instantiating a Function
    that does not define ``__init__``)."""

    def __init__(self):
        pass

    def __call__(self, *args, **kwargs):
        return self.apply(*args, **kwargs)


class SignActivation(_Callable, torch.autograd.Function):
    """``SignActivation.apply(x)``: sign(x) forward (sign(0) == 0), hardtanh
    straight-through gradient (the cotangent where |x| < 1, else 0)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.sign(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _hardtanh_mask(x, g)


class _SignPm1STE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _hardtanh_mask(x, g)


class _StochasticSignSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, noise):
        ctx.save_for_backward(x)
        p = torch.clamp((x + 1.0) * 0.5 + noise, 0.0, 1.0)
        return torch.round(p) * 2.0 - 1.0

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _hardtanh_mask(x, g), None


class SignActivationStochastic(_Callable, _StochasticSignSTE):
    """``SignActivationStochastic.apply(x, generator=None)``: +1 with
    probability ``clip((x + 1) / 2, 0, 1)``, else -1; hardtanh
    straight-through gradient. The uniform noise is drawn from
    ``generator`` (a generator of ``x``'s device; the JAX package's PRNG
    key), on ``x``'s device."""

    @staticmethod
    def forward(ctx, x, generator=None):
        noise = torch.rand(x.shape, generator=generator, dtype=x.dtype,
                           device=x.device) - 0.5
        return _StochasticSignSTE.forward(ctx, x, noise)


def sign_ste(x: torch.Tensor) -> torch.Tensor:
    """sign(x) forward (sign(0) == 0); hardtanh straight-through gradient."""
    return SignActivation.apply(x)


def sign_pm1_ste(x: torch.Tensor) -> torch.Tensor:
    """``+1 where x >= 0 else -1`` (sign(0) == +1); hardtanh STE."""
    return _SignPm1STE.apply(x)


def stochastic_sign_ste(x: torch.Tensor,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """``round(clip((x+1)/2 + U[-0.5, 0.5]))`` mapped to {-1, +1}; the noise
    comes from ``generator`` (the JAX package's PRNG key), a generator of
    ``x``'s device, drawn there."""
    return SignActivationStochastic.apply(x, generator)


SURROGATES = {
    "tanh": torch.tanh,
    "erf": torch.erf,
    "softsign": lambda x: x / (1.0 + torch.abs(x)),
    "hardtanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "sin": lambda x: torch.sin(torch.clamp(x, -math.pi / 2, math.pi / 2)),
}


def resolve_surrogate(funct):
    """A surrogate spec (callable or name in :data:`SURROGATES`) -> callable."""
    if callable(funct):
        return funct
    try:
        return SURROGATES[funct]
    except KeyError:
        raise ValueError(
            f"unknown surrogate {funct!r}; known names: "
            f"{sorted(SURROGATES)} (or pass any callable)") from None


def surrogate_sign(x: torch.Tensor, funct="tanh", t: float = 5.0) -> torch.Tensor:
    """sign(x) forward with the gradient of ``funct(t * x)``."""
    y = resolve_surrogate(funct)(x * t)
    return y + (torch.sign(y) - y).detach()


def tanh_surrogate_sign(x: torch.Tensor, t: float = 5.0) -> torch.Tensor:
    """sign(x) forward with the gradient of ``tanh(t * x)`` (the reference's
    default ``derivative_funct``; see :func:`surrogate_sign`)."""
    return surrogate_sign(x, torch.tanh, t)
