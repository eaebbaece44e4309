"""Weights, norm statistics and inputs made from ``--seed`` on the device.

Every tensor of the QAT model's state is drawn by its name and shape
(:func:`portbench.arch.state_spec`) from one ``torch.Generator`` on the
device, in two calls (one normal, one uniform draw, cut into the tensors in
a fixed order), so the same seed gives the same tensors:

- convs: Kaiming normal, fan-out (``sqrt(2 / (cout * k * k))``);
- the dense head: uniform in ``+-1 / sqrt(fan_in)``;
- norms: scale ``1 + 0.3 N``, shift ``0.3 N``, running mean ``0.3 N``,
  running variance ``0.5 + 1.5 U``; binary output scales ``0.5 + U``.

Random norm statistics and scales keep every folded shift non-zero (at scale
1 and shift 0 a binary conv's BN output can sit within rounding of 0 for a
whole channel, and the sign after it is then noise). Both the program and
the plain reference are handed these same tensors.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from . import arch

NORMAL = {"conv", "bn_weight", "bn_bias", "bn_mean"}
UNIFORM = {"linear", "bn_var", "alpha"}


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def make_state(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The QAT model's state (f32, ``num_batches_tracked`` int64) on ``device``."""
    spec = arch.state_spec(config)
    by_name = {n: s for n, s, _ in spec}
    gen = generator(seed, device)
    sizes = {"n": sum(math.prod(s) for _, s, k in spec if k in NORMAL),
             "u": sum(math.prod(s) for _, s, k in spec if k in UNIFORM)}
    normal = torch.randn(sizes["n"], generator=gen, device=device)
    uniform = torch.rand(sizes["u"], generator=gen, device=device)
    at = {"n": 0, "u": 0}
    state = {}
    for name, shape, init in spec:
        if init == "count":
            state[name] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        which = "n" if init in NORMAL else "u"
        n = math.prod(shape)
        v = (normal if which == "n" else uniform)[at[which]:at[which] + n].view(shape)
        at[which] += n
        if init == "conv":
            v = v * math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
        elif init == "linear":
            bound = 1.0 / math.sqrt(arch.fan_in(by_name, name))
            v = (2 * v - 1) * bound
        elif init == "bn_weight":
            v = 1.0 + 0.3 * v
        elif init in ("bn_bias", "bn_mean"):
            v = 0.3 * v
        elif init == "bn_var":
            v = 0.5 + 1.5 * v
        elif init == "alpha":
            v = 0.5 + v
        state[name] = v.contiguous()
    return state


def make_images(seed: int, count: int, shape, device, stream: int) -> torch.Tensor:
    """``count`` float32 images of ``shape`` (C, H, W), standard normal, from
    the seed and a stream number (so that weights and each pool draw apart)."""
    gen = generator((seed * 7919 + stream) % (1 << 63), device)
    return torch.randn((count, *shape), generator=gen, device=device)


def make_labels(seed: int, count: int, classes: int, device, stream: int) -> torch.Tensor:
    gen = generator((seed * 7919 + stream) % (1 << 63), device)
    return torch.randint(0, classes, (count,), generator=gen, device=device)
