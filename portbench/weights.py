"""Weights, norm statistics and inputs made from ``--seed`` on the device.

Every tensor of the QAT model's state is drawn by its name, shape and init
rule (:func:`portbench.arch.state_spec`, :data:`RULES` and the family's
``INITS``) from one ``torch.Generator`` on the device, in two calls (one
normal, one uniform draw, cut into the tensors in a fixed order), so the
same seed gives the same tensors:

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

# init name -> (draw, transform): ``n`` cuts the tensor from the normal draw,
# ``u`` from the uniform one; ``transform(v, shape, fan_in)`` maps the cut to
# the tensor, ``fan_in()`` giving its dense layer's fan-in. ``count`` tensors
# are a zero int64 scalar. A family's ``INITS`` adds rules of its own.
RULES = {
    "conv": ("n", lambda v, shape, fan_in: v * math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))),
    "linear": ("u", lambda v, shape, fan_in: (2 * v - 1) * (1.0 / math.sqrt(fan_in()))),
    "bn_weight": ("n", lambda v, shape, fan_in: 1.0 + 0.3 * v),
    "bn_bias": ("n", lambda v, shape, fan_in: 0.3 * v),
    "bn_mean": ("n", lambda v, shape, fan_in: 0.3 * v),
    "bn_var": ("u", lambda v, shape, fan_in: 0.5 + 1.5 * v),
    "alpha": ("u", lambda v, shape, fan_in: 0.5 + v),
}


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def make_state(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The QAT model's state (f32, ``num_batches_tracked`` int64) on ``device``."""
    spec = arch.state_spec(config)
    rules = {**RULES, **arch.family(config).INITS}
    by_name = {n: s for n, s, _ in spec}
    gen = generator(seed, device)
    sizes = {d: sum(math.prod(s) for _, s, k in spec if k != "count" and rules[k][0] == d)
             for d in ("n", "u")}
    normal = torch.randn(sizes["n"], generator=gen, device=device)
    uniform = torch.rand(sizes["u"], generator=gen, device=device)
    at = {"n": 0, "u": 0}
    state = {}
    for name, shape, init in spec:
        if init == "count":
            state[name] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        which, transform = rules[init]
        n = math.prod(shape)
        v = (normal if which == "n" else uniform)[at[which]:at[which] + n].view(shape)
        at[which] += n
        v = transform(v, shape, lambda: arch.fan_in(config, by_name, name))
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
