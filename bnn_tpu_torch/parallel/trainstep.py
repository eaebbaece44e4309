"""Train and eval steps (counterpart of ``bnn_tpu/parallel/trainstep.py``).

A step runs on the device of the model's parameters: the batch is moved
there, the model never is. The model is updated in place (parameters,
BatchNorm statistics, binarizer streams) through a ``torch.optim``
optimizer.

On a model placed on a mesh (:func:`~bnn_tpu_torch.parallel.shard_model`),
the step does by hand what GSPMD does behind JAX's step: each rank passes
its rows (:func:`~bnn_tpu_torch.parallel.shard_batch`); the gradients are
averaged over the ``data`` axis (one all-reduce per dtype), BatchNorm has
normalised with the whole batch's statistics, a tensor-parallel layer has
gathered its output over ``model``; the metrics are the whole batch's, on
every rank. With ``accum_steps`` each rank splits its own rows.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.binarizers import RandomStream
from ..utils.precision import cast_float_tree
from ..utils.profiling import (TRAIN_BACKWARD, TRAIN_FORWARD, TRAIN_OPTIMIZER,
                               TRAIN_STEP, span)
from .mesh import mesh_of

__all__ = ["cross_entropy_mean", "make_train_step", "make_eval_step"]


def cross_entropy_mean(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy over integer labels (the default loss)."""
    return F.cross_entropy(logits, labels)


def _logits_of(out):
    # BATS networks return (logits, aux); plain models return logits
    return out[0] if isinstance(out, tuple) else out


def _as_f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float32 else x.float()


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _data_group(model: nn.Module):
    """``(group, size)`` of the model's data axis, or None off a mesh or on
    a data axis of 1."""
    mesh = mesh_of(model)
    if mesh is None or mesh.size("data") == 1:
        return None
    return mesh.group("data"), mesh.size("data")


def _data_sum(values: torch.Tensor, data) -> torch.Tensor:
    if data is not None:
        values = values.clone()
        torch.distributed.all_reduce(values, group=data[0])
    return values


def _average_grads(model: nn.Module, data) -> None:
    """Average every gradient over the data axis: one all-reduce per dtype."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    group, n = data
    by_dtype = {}
    for p in model.parameters():
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = _flatten_dense_tensors(grads)
        torch.distributed.all_reduce(flat, group=group)
        flat.div_(n)
        for g, v in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(v)


def _mixed_forward(model: nn.Module, x: torch.Tensor, compute_dtype):
    """``model(x)`` on ``compute_dtype`` copies of the parameters.

    The casts run inside autograd, so the gradients reach the f32 masters
    through them. Buffers are the model's own: the BatchNorm statistics stay
    f32 and are updated in place, while the norm layers' outputs take the
    dtype of their inputs. bf16 has f32's exponent range: no loss scaling."""
    params = cast_float_tree(dict(model.named_parameters()), compute_dtype)
    return torch.func.functional_call(model, params, (x.to(compute_dtype),))


@contextlib.contextmanager
def _as_first_forward(model: nn.Module, generators, start_states):
    """Run a checkpointed forward again as it ran the first time: each
    random stream's generator (stochastic binarizers, drop-path) draws from
    where it stood then, and buffers that the recompute writes (BatchNorm
    statistics) are put back, so that they are written once a step. On exit
    the generators stand where the first forward left them."""
    after = [g.get_state() for g in generators]
    for g, s in zip(generators, start_states):
        g.set_state(s)
    buffers = [(b, b._version, b.clone()) for b in model.buffers()]
    try:
        yield
    finally:
        for g, s in zip(generators, after):
            g.set_state(s)
        with torch.no_grad():
            for b, version, saved in buffers:
                if b._version != version:
                    b.copy_(saved)


def _remat(fwd: Callable, model: nn.Module, x: torch.Tensor):
    """``fwd(x)`` under ``torch.utils.checkpoint``: activations are recomputed
    in the backward instead of stored."""
    generators = [m.generator(x.device) for m in model.modules()
                  if isinstance(m, RandomStream)]
    start = [g.get_state() for g in generators]
    return checkpoint(fwd, x, use_reentrant=False, context_fn=lambda: (
        contextlib.nullcontext(), _as_first_forward(model, generators, start)))


def make_train_step(loss_fn: Callable = cross_entropy_mean,
                    aux_weight: float = 0.0, remat: bool = False,
                    compute_dtype=None, accum_steps: int = 1) -> Callable:
    """Build a train step ``step(model, optimizer, x, y) -> {"loss", "top1"}``
    (detached f32 scalars on the model's device), ``optimizer`` a
    ``torch.optim.Optimizer`` over the model's parameters.

    - ``aux_weight``: models returning ``(logits, aux)`` (BATS) add
      ``aux_weight * loss_fn(aux, y)``. The loss is computed in f32.
    - ``remat=True`` recomputes the whole forward in the backward
      (``torch.utils.checkpoint``), BatchNorm statistics written once and
      random streams (stochastic binarizers, drop-path) drawing the same
      noise again.
    - ``compute_dtype=torch.bfloat16``: forward and backward on bf16 copies
      of the parameters; masters, their gradients, the optimizer's state and
      the BatchNorm statistics stay f32.
    - ``accum_steps=N``: the batch is split into N equal microbatches, in
      order; their gradients are averaged and the optimizer steps once.
      BatchNorm statistics are updated per microbatch. A batch that N does
      not divide raises ``ValueError``.
    """

    def forward(model, x):
        if compute_dtype is not None:
            fwd = lambda v: _mixed_forward(model, v, compute_dtype)  # noqa: E731
        else:
            fwd = model
        return _remat(fwd, model, x) if remat else fwd(x)

    def loss_of(model, x, y):
        out = forward(model, x)
        logits = _logits_of(out)
        loss = loss_fn(_as_f32(logits), y)
        if aux_weight and isinstance(out, tuple) and out[1] is not None:
            loss = loss + aux_weight * loss_fn(_as_f32(out[1]), y)
        return loss, logits

    def step(model, optimizer, x, y):
        if x.shape[0] % accum_steps:
            raise ValueError(f"a batch of {x.shape[0]} does not split into "
                             f"{accum_steps} equal microbatches")
        with span(TRAIN_STEP):
            device = _device_of(model)
            x, y = x.to(device), y.to(device)
            optimizer.zero_grad(set_to_none=True)
            loss_sum = top1_sum = torch.zeros((), device=device)
            for xs, ys in zip(x.chunk(accum_steps), y.chunk(accum_steps)):
                with span(TRAIN_FORWARD):
                    loss, logits = loss_of(model, xs, ys)
                with span(TRAIN_BACKWARD):
                    loss.backward()
                loss_sum = loss_sum + loss.detach()
                top1_sum = top1_sum + (logits.argmax(-1) == ys).float().mean()
            if accum_steps > 1:
                for p in model.parameters():
                    if p.grad is not None:
                        p.grad.div_(accum_steps)
            data = _data_group(model)
            if data is not None:
                _average_grads(model, data)
            with span(TRAIN_OPTIMIZER):
                optimizer.step()
            metrics = torch.stack([loss_sum, top1_sum]) / accum_steps
            if data is not None:
                metrics = _data_sum(metrics, data) / data[1]
            return {"loss": metrics[0], "top1": metrics[1]}

    return step


def make_eval_step() -> Callable:
    """Build an eval step ``step(model, x, y)`` returning the summed ``loss``,
    ``top1`` and ``top5`` hits and the ``count``, for exact aggregation over
    an epoch; on a placed model, summed over the data axis."""

    @torch.no_grad()
    def step(model, x, y):
        device = _device_of(model)
        x, y = x.to(device), y.to(device)
        logits = _logits_of(model(x))
        loss = cross_entropy_mean(logits, y)
        top1 = (logits.argmax(-1) == y).float().sum()
        k = min(5, logits.shape[-1])
        top5 = (logits.topk(k, -1).indices == y[:, None]).any(-1).float().sum()
        out = {"loss": loss * y.shape[0], "top1": top1, "top5": top5,
               "count": torch.tensor(float(y.shape[0]), device=device)}
        data = _data_group(model)
        return out if data is None else {k: _data_sum(v, data) for k, v in out.items()}

    return step
