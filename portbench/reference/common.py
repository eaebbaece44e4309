"""What every family's plain reference shares: exact matrix products, the
straight-through sign, the XNOR weights, the norm and the binary conv of the
flagship recipe, AdamW, and the eval-mode logits and QAT training steps of a
family's ``Forward``.

A family's reference module (``reference/<module>.py``, named by its
family's ``REFERENCE``) defines ``Forward(config, S, *, train=False,
q=identity)``: the network of ``config`` over the state ``S`` (name ->
tensor), called on a batch of NCHW images, which keeps ``config``, ``S``
and ``q`` as attributes and applies ``q`` wherever the program keeps a
tensor in its own precision. Plain PyTorch; imports nothing of the measured
program.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

EPS = 1e-5
BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def identity(x):
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


class Sign(torch.autograd.Function):
    """``sign(x)`` (``sign(0) = 0``), its gradient passed straight through
    where ``|x| < 1`` (hardtanh)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.sign(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * ((x > -1) & (x < 1)).to(g.dtype)


def xnor_weight(w: torch.Tensor) -> torch.Tensor:
    """``sign(W) * mean|W|`` per output channel; ``mean|W|`` gets its
    gradient with ``d|w|/dw = +1`` at ``w = 0``."""
    alpha = torch.where(w >= 0, w, -w).mean(dim=(1, 2, 3), keepdim=True)
    return Sign.apply(w) * alpha


def batch_norm(x: torch.Tensor, S: Dict[str, torch.Tensor], name: str,
               train: bool) -> torch.Tensor:
    """The norm ``name`` of the state ``S`` on NCHW ``x``: running
    statistics in eval mode; in train mode the batch mean and the two-pass
    biased variance, ``(x - mean) * (rsqrt(var + eps) * weight) + bias``."""
    if not train:
        return F.batch_norm(x, S[name + ".running_mean"], S[name + ".running_var"],
                            S[name + ".weight"], S[name + ".bias"], False, 0.0, EPS)
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    d = x - mean
    var = d.square().mean(dim=(0, 2, 3), keepdim=True)
    mul = torch.rsqrt(var + EPS) * S[name + ".weight"].view(1, -1, 1, 1)
    return d * mul + S[name + ".bias"].view(1, -1, 1, 1)


def binary_conv(x: torch.Tensor, S: Dict[str, torch.Tensor], name: str, stride, pad,
                q: Callable = identity) -> torch.Tensor:
    """The binary conv ``name`` of the state ``S`` as the flagship recipe
    makes it: the signs of ``x`` against the XNOR weights, times the learned
    output scale, each kept tensor rounded by ``q``."""
    w = xnor_weight(q(S[name + ".weight"]))
    y = F.conv2d(Sign.apply(x), w, None, stride, pad)
    return q(y * q(S[name + ".activation_post_process.alpha"]))


def is_param(name: str) -> bool:
    return not name.endswith(BUFFERS)


@torch.no_grad()
def logits(Forward, config: dict, state: Dict[str, torch.Tensor], images: torch.Tensor, *,
           q: Callable = identity, block: int = 64, dtype=torch.float32) -> torch.Tensor:
    """Eval-mode logits of ``images`` (N, C, H, W) by the reference
    ``Forward``, in blocks of ``block`` rows, on the device of ``state``;
    f32 on the host."""
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


def train_steps(Forward, config: dict, state: Dict[str, torch.Tensor],
                batches: Sequence[tuple], *, lr: float, weight_decay: float,
                q: Callable = identity, dtype=torch.float32) -> dict:
    """The QAT step of the reference ``Forward`` on each ``(images,
    labels)`` of ``batches`` in turn, from ``state``: mean softmax cross
    entropy, backward through the straight-through signs, AdamW. Returns
    each step's ``losses``, the first step's gradient norm per parameter
    (``grad_norms``) and each parameter's change over all the steps
    (``change_norms``)."""
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
