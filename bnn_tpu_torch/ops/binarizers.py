"""The binarizer zoo as ``torch.nn`` modules (counterpart of
``bnn_tpu/ops/binarizers.py``).

Layouts are torch's: the out-channel axis of a weight is dim 0 and the
in-channel axis dim 1, and a per-channel output scale broadcasts as
``[1, C, 1, ...]`` over an NC... activation.
"""
from __future__ import annotations

import itertools
import math
from functools import partial
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.padding import conv_nd
from .registry import register
from .ste import (resolve_surrogate, sign_pm1_ste, sign_ste,
                  stochastic_sign_ste, surrogate_sign)

__all__ = [
    "BinarizerBase",
    "RandomStream",
    "Identity",
    "BasicInputBinarizer",
    "StochasticInputBinarizer",
    "AdvancedInputBinarizer",
    "XNORWeightBinarizer",
    "BasicScaleBinarizer",
    "XNORScaleBinarizer",
]


class _PartialWrapper:
    """Chainable constructor factory (the ``with_args`` machinery)."""

    def __init__(self, p: partial):
        self.p = p

    def __call__(self, *args, **kwargs):
        return self.p(*args, **kwargs)

    def with_args(self, **kwargs):
        return _PartialWrapper(partial(self.p.func, *self.p.args,
                                       **{**self.p.keywords, **kwargs}))

    def __repr__(self):
        return repr(self.p)


class BinarizerBase(nn.Module):
    """Base class: input/weight binarizers take one tensor, output (scale)
    binarizers take ``(layer_out, layer_in)``."""

    @classmethod
    def with_args(cls, **kwargs) -> _PartialWrapper:
        return _PartialWrapper(partial(cls, **kwargs))


@register(aliases=("nn.Identity", "identity"))
class Identity(BinarizerBase):
    """No-op binarizer for any of the three slots (one or two arguments)."""

    def __init__(self, module: nn.Module = None):
        super().__init__()

    def forward(self, x: torch.Tensor, *unused) -> torch.Tensor:
        return x


@register
class BasicInputBinarizer(BinarizerBase):
    """Deterministic sign with hardtanh-STE gradients; ``sign(0) == 0``
    unless ``zero_to_one``, which maps exact zeros to +1."""

    def __init__(self, zero_to_one: bool = False):
        super().__init__()
        self.zero_to_one = zero_to_one

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return sign_pm1_ste(x) if self.zero_to_one else sign_ste(x)


# every stochastic binarizer built without a seed gets its own stream, in
# construction order: one shared default seed would correlate the flips of
# all layers
_STOCHASTIC_SEED = itertools.count()


class RandomStream(nn.Module):
    """A seeded random stream of its own on each device.

    Draws come from a ``torch.Generator`` of the tensor's device, seeded
    with the instance's seed (``seed``, the given ``generator``'s initial
    seed, or ``_STOCHASTIC_SEED``'s next value), made at the first call
    there and kept.

    The seed and each device's generator state are the module's extra state
    (``_extra_state`` in its ``state_dict``), as a JAX module's ``nnx.Rngs``
    are part of its state: a restored stream draws on from where the saved
    one stopped. A saved state of a device this process has no generator on
    yet is applied when the generator is made."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 seed: Optional[int] = None):
        super().__init__()
        self._generators = {}
        self._saved_states = {}
        if generator is not None:
            self._generators[generator.device] = generator
            seed = generator.initial_seed()
        self.seed = next(_STOCHASTIC_SEED) if seed is None else seed

    def generator(self, device: torch.device) -> torch.Generator:
        """This instance's generator on ``device``."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self._generators:
            g = torch.Generator(device).manual_seed(self.seed)
            saved = self._saved_states.pop(str(device), None)
            if saved is not None:
                g.set_state(saved)
            self._generators[device] = g
        return self._generators[device]

    def get_extra_state(self) -> dict:
        states = {str(d): g.get_state() for d, g in self._generators.items()}
        return {"seed": self.seed, "states": {**self._saved_states, **states}}

    def set_extra_state(self, state: dict) -> None:
        self.seed = int(state["seed"])
        self._saved_states = {}
        for name, s in state["states"].items():
            device = torch.device(name)
            if device in self._generators:
                self._generators[device].set_state(s)
            else:
                self._saved_states[name] = s


@register
class StochasticInputBinarizer(RandomStream, BinarizerBase):
    """Stochastic sign binarizer with a stream of its own on each device
    (:class:`RandomStream`: seed and generator states travel in its
    ``state_dict``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return stochastic_sign_ste(x, self.generator(x.device))


@register
class AdvancedInputBinarizer(BinarizerBase):
    """Sign forward with a pluggable soft surrogate gradient."""

    def __init__(self, derivative_funct="tanh", t: float = 5.0):
        super().__init__()
        self.derivative_funct = resolve_surrogate(derivative_funct)
        self.t = t

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return surrogate_sign(x, self.derivative_funct, self.t)


@register
class XNORWeightBinarizer(BinarizerBase):
    """XNOR-Net weight binarizer ``alpha * sign(W)``, alpha the per-out-channel
    mean absolute weight. ``center_weights`` first subtracts the mean over
    the in-channel axis (dim 1)."""

    def __init__(self, compute_alpha: bool = True, center_weights: bool = False):
        super().__init__()
        self.compute_alpha = compute_alpha
        self.center_weights = center_weights

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        if w.ndim < 2:
            raise ValueError(f"Expected weight rank >= 2, got {w.ndim}")
        if self.center_weights:
            w = w - w.mean(dim=1, keepdim=True)
        if self.compute_alpha:
            alpha = _abs(w).mean(dim=tuple(range(1, w.ndim)), keepdim=True)
            return sign_ste(w) * alpha
        return sign_ste(w)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` with JAX's gradient at 0, +1 (``torch.abs`` gives 0 there):
    post-ReLU inputs to ``XNORScaleBinarizer`` hold exact zeros."""
    return torch.where(x >= 0, x, -x)


def _out_channels(module: nn.Module) -> int:
    for attr in ("out_features", "out_channels"):
        n = getattr(module, attr, None)
        if n is not None:
            return n
    raise ValueError(
        f"Unknown layer of type {type(module)} missing out_channels/out_features")


@register
class BasicScaleBinarizer(BinarizerBase):
    """Learnable per-out-channel scale of the layer output: ``alpha`` has
    shape ``[1, C]`` for a linear layer and ``[1, C, 1, ...]`` for a conv."""

    def __init__(self, module: nn.Module, shape: Optional[Sequence[int]] = None):
        super().__init__()
        if shape is None:
            spatial = len(getattr(module, "kernel_size", ()))
            shape = (1, _out_channels(module)) + (1,) * spatial
        self.alpha = nn.Parameter(torch.ones(tuple(shape)))

    def forward(self, layer_out: torch.Tensor,
                layer_in: torch.Tensor = None) -> torch.Tensor:
        return layer_out * self.alpha


@register
class XNORScaleBinarizer(BinarizerBase):
    """Data-driven XNOR-Net spatial scale ``K = mean_c |x| * k``, ``k`` a
    uniform kernel of the layer's receptive field (dilation included)."""

    def __init__(self, module: nn.Module):
        super().__init__()
        if not hasattr(module, "kernel_size"):
            raise TypeError(
                "XNORScaleBinarizer only applies to conv layers (needs "
                f"kernel_size/stride/padding); got {type(module).__name__}. "
                "Use BasicScaleBinarizer for dense layers.")
        self.kernel_size = tuple(module.kernel_size)
        self.stride = module.stride
        self.padding = module.padding
        self.dilation = getattr(module, "dilation", 1)

    def forward(self, layer_out: torch.Tensor,
                layer_in: torch.Tensor) -> torch.Tensor:
        a = _abs(layer_in).mean(dim=1, keepdim=True)
        k = torch.full((1, 1) + self.kernel_size,
                       1.0 / math.prod(self.kernel_size),
                       dtype=layer_in.dtype, device=layer_in.device)
        scale = conv_nd(a, k, None, self.stride, self.padding, self.dilation)
        return layer_out * scale
