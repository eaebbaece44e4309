"""The plain reference: the binary ResNet's forward and its QAT training
step with AdamW, in plain PyTorch, from the tensors the benchmark made.

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
TF32 off (:func:`exact_matmul`).
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

from .. import arch

EPS = 1e-5
BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def _identity(x):
    return x


@contextlib.contextmanager
def exact_matmul():
    """TF32 off for matmuls and convs inside, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class _Sign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.sign(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * ((x > -1) & (x < 1)).to(g.dtype)


def xnor_weight(w: torch.Tensor) -> torch.Tensor:
    alpha = torch.where(w >= 0, w, -w).mean(dim=(1, 2, 3), keepdim=True)
    return _Sign.apply(w) * alpha


def is_param(name: str) -> bool:
    return not name.endswith(BUFFERS)


class Forward:
    """The network of ``config`` over the state ``S`` (name -> tensor)."""

    def __init__(self, config: dict, S: Dict[str, torch.Tensor], *,
                 train: bool = False, q: Callable = _identity):
        self.config, self.S, self.train, self.q = config, S, train, q
        self.blocks = list(arch.blocks(config))

    def norm(self, x, name):
        S = self.S
        if not self.train:
            y = F.batch_norm(x, S[name + ".running_mean"], S[name + ".running_var"],
                             S[name + ".weight"], S[name + ".bias"], False, 0.0, EPS)
        else:
            mean = x.mean(dim=(0, 2, 3), keepdim=True)
            d = x - mean
            var = d.square().mean(dim=(0, 2, 3), keepdim=True)
            mul = torch.rsqrt(var + EPS) * S[name + ".weight"].view(1, -1, 1, 1)
            y = d * mul + S[name + ".bias"].view(1, -1, 1, 1)
        return self.q(y)

    def binary_conv(self, x, name, stride, pad):
        w = xnor_weight(self.q(self.S[name + ".weight"]))
        y = F.conv2d(_Sign.apply(x), w, None, stride, pad)
        return self.q(y * self.q(self.S[name + ".activation_post_process.alpha"]))

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


@torch.no_grad()
def logits(config: dict, state: Dict[str, torch.Tensor], images: torch.Tensor, *,
           q: Callable = _identity, block: int = 64, dtype=torch.float32) -> torch.Tensor:
    """Eval-mode logits of ``images`` (N, C, H, W), in blocks of ``block``
    rows, on the device of ``state``; f32 on the host."""
    S = {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in state.items()}
    fwd = Forward(config, S, q=q)
    dev = next(iter(S.values())).device
    out = []
    with exact_matmul():
        for i in range(0, images.shape[0], block):
            out.append(fwd(images[i:i + block].to(dev, dtype)).float().cpu())
    return torch.cat(out)


def adamw_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               state: dict, t: int, lr: float, weight_decay: float,
               betas=(0.9, 0.999), eps: float = 1e-8) -> None:
    """One AdamW step (decoupled weight decay, bias-corrected moments) in place."""
    b1, b2 = betas
    for name, p in params.items():
        g = grads[name]
        m, v = state.setdefault(name, (torch.zeros_like(p), torch.zeros_like(p)))
        p.mul_(1 - lr * weight_decay)
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = (v.sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
        p.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))


def train_steps(config: dict, state: Dict[str, torch.Tensor],
                batches: Sequence[tuple], *, lr: float, weight_decay: float,
                q: Callable = _identity, dtype=torch.float32) -> dict:
    """The QAT step on each ``(images, labels)`` of ``batches`` in turn,
    from ``state``: mean softmax cross entropy, backward through the
    straight-through signs, AdamW. Returns each step's ``losses``, the first
    step's gradient norm per parameter (``grad_norms``) and each parameter's
    change over all the steps (``change_norms``)."""
    dev = next(iter(state.values())).device
    P = {k: v.detach().to(dev, dtype).clone() for k, v in state.items() if is_param(k)}
    start = {k: v.clone() for k, v in P.items()}
    opt_state: dict = {}
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    with exact_matmul():
        for t, (x, y) in enumerate(batches, 1):
            leaves = {k: v.detach().requires_grad_() for k, v in P.items()}
            loss = F.cross_entropy(Forward(config, leaves, train=True, q=q)(x.to(dev, dtype))
                                   .float(), y.to(dev))
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            losses.append(float(loss.detach()))
            if t == 1:
                grad_norms = {k: float(g.double().norm()) for k, g in grads.items()}
            with torch.no_grad():
                adamw_step(P, grads, opt_state, t, lr, weight_decay)
    change_norms = {k: float((P[k] - start[k]).double().norm()) for k in P}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change_norms}
