"""GPipe pipeline parallelism over a ``pipe`` mesh axis (counterpart of
``bnn_tpu/parallel/pipeline.py``).

Stages are homogeneous, as in the JAX package: identical module structure
and matching activation shapes, so their states stack on a leading
``n_stages`` axis that shards over ``pipe``: each rank holds its own stage.
The schedule is JAX's: ``n_micro + n_stages - 1`` ticks; at tick ``t``
stage 0 takes microbatch ``t`` (clamped), every other stage the activation
its predecessor handed on at ``t - 1``, and the last stage finishes
microbatch ``t - (n_stages - 1)``. Activations move one stage on by a ring
permute (``batch_isend_irecv``) whose backward is the inverse permute; the
last stage's outputs reach every rank by a broadcast whose backward leaves
the gradient on the last stage alone. With a ``data`` axis each microbatch
is split over it and the result gathered back, so the returned batch is
the whole one on every rank, differentiable w.r.t. the local stage state:
its gradient is the whole batch's (summed over ``data``).

The selections JAX writes with ``jnp.where`` stay ``torch.where`` on every
rank, so each rank's autograd graph has the same collectives in the same
order and the backward's sends and receives pair up.

The stage function is pure: BatchNorm running statistics a stage writes in
train mode are dropped, as in JAX. :class:`~bnn_tpu_torch.parallel.
HeteroPipeline` keeps them.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, Sequence

import torch
from torch import nn

from .collectives import broadcast_from_last, copy_to, gather_from, ring_permute
from .mesh import Mesh, Spec, _tag, spec_of

__all__ = ["make_pipeline_mesh", "stack_stage_states", "make_stage_fn",
           "shard_stacked_state", "pipeline_apply"]


def make_pipeline_mesh(pipe: int, data: int = 1, device=None) -> Mesh:
    """A ``(pipe, data)`` mesh: ``pipe`` is the stage axis, ``data``
    batch-splits each microbatch."""
    return Mesh({"pipe": pipe, "data": data}, device)


def _state(module: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in module.state_dict().items()}


def stack_stage_states(modules: Sequence[nn.Module]) -> Dict[str, torch.Tensor]:
    """Stack the states (parameters and buffers, ``state_dict`` names) of
    structurally identical modules on a new leading ``n_stages`` axis."""
    states = [_state(m) for m in modules]
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


def make_stage_fn(template: nn.Module) -> Callable:
    """``stage_fn(state, x) -> y``: the template module (any of the
    identical stages) run on ``state``. Pure: buffers the forward writes
    (BatchNorm running statistics) are copies, dropped afterwards."""
    module = copy.deepcopy(template)
    buffers = {k for k, _ in module.named_buffers()}

    def stage_fn(state, x):
        state = {k: (v.clone() if k in buffers else v) for k, v in state.items()}
        return torch.func.functional_call(module, state, (x,))

    return stage_fn


def shard_stacked_state(stacked_state: Dict[str, torch.Tensor], mesh: Mesh,
                        axis: str = "pipe") -> Dict[str, torch.Tensor]:
    """This rank's row of a stacked stage state (leading axis kept, of 1),
    on the mesh's device, each with ``Spec(axis)``. The stacking must hold
    one stage per ``axis`` coordinate."""
    i, n = mesh.index(axis), mesh.size(axis)
    out = {}
    for k, v in stacked_state.items():
        if v.shape[0] != n:
            raise ValueError(f"{v.shape[0]} stacked stages != {n}-way '{axis}' "
                             f"mesh axis (one stage per pipeline device)")
        out[k] = _tag(v[i:i + 1].to(mesh.device).clone(), mesh,
                      Spec(axis, *([None] * (v.ndim - 1))))
    return out


def _local_row(leaf: torch.Tensor, mesh: Mesh, axis: str, n_stages: int):
    """(this rank's stage row of a stacked leaf, the global number of
    stacked stages): a sharded leaf holds its row, a whole one all rows."""
    if axis in spec_of(leaf).axes(0):
        return leaf[0], leaf.shape[0] * n_stages
    if leaf.shape[0] != n_stages:
        return None, leaf.shape[0]
    return leaf[mesh.index(axis)], leaf.shape[0]


def _split_batch(x: torch.Tensor, mesh: Mesh, n_microbatches: int):
    """``(n_micro, local micro, ...)``: the microbatches, each cut to this
    rank's ``data`` rows; also ``(micro, data size)``."""
    batch = x.shape[0]
    if batch % n_microbatches:
        raise ValueError(f"a batch of {batch} does not split into "
                         f"{n_microbatches} microbatches")
    micro = batch // n_microbatches
    n_data = mesh.size("data")
    if micro % n_data:
        raise ValueError(
            f"microbatch size {micro} must divide over the data axis "
            f"({n_data}); use fewer microbatches or more batch")
    local = micro // n_data
    d = mesh.index("data")
    xs = x.reshape(n_microbatches, micro, *x.shape[1:])
    return xs[:, d * local:(d + 1) * local].to(mesh.device), micro, n_data


def run_schedule(step: Callable, xs: torch.Tensor, mesh: Mesh, axis: str,
                 n_microbatches: int) -> torch.Tensor:
    """The GPipe ticks shared by both pipelines. ``step(t, inp)`` runs this
    rank's stage at tick ``t`` and returns its output (the shape of ``inp``);
    returns the stacked last-stage outputs ``(n_micro, local micro, ...)``,
    on every rank of ``axis``."""
    n_stages = mesh.size(axis)
    s, last = mesh.index(axis), n_stages - 1
    group = mesh.group(axis)
    is_first = torch.tensor(s == 0, device=xs.device)
    ticks = n_microbatches + n_stages - 1
    buf = torch.zeros_like(xs[0])
    ys = [torch.zeros_like(xs[0]) for _ in range(n_microbatches)]
    for t in range(ticks):
        feed = xs[min(t, n_microbatches - 1)]
        out = step(t, torch.where(is_first, feed, buf))
        idx = min(max(t - last, 0), n_microbatches - 1)
        valid = torch.tensor(t - last >= 0 and s == last, device=xs.device)
        ys[idx] = torch.where(valid, out, ys[idx])
        if t + 1 < ticks:  # the last tick's hand-on would go unused
            buf = ring_permute(out, group)
    # only the last stage holds real outputs; every rank takes them
    return broadcast_from_last(torch.stack(ys), group)


def pipeline_apply(stage_fn: Callable, stacked_state: Dict[str, torch.Tensor],
                   x: torch.Tensor, *, mesh: Mesh, n_microbatches: int,
                   axis: str = "pipe") -> torch.Tensor:
    """Run ``x`` through ``n_stages`` sequential stages with a GPipe
    microbatch schedule over the mesh's ``axis``.

    ``stacked_state``: stage states stacked on a leading axis of
    ``n_stages`` (:func:`stack_stage_states`), whole on every rank or this
    rank's row (:func:`shard_stacked_state`). ``x``: the whole ``(batch,
    ...)`` batch, the same on every rank, split into ``n_microbatches``
    equal microbatches; a ``data`` axis over 1 splits each over it.

    Returns ``stage_{S-1}(... stage_0(x))`` for the whole batch on every
    rank. Every rank computes its loss from it (the same loss) and calls
    ``backward``; the gradient reaching this rank's stage state is then the
    whole batch's.
    """
    n_stages = mesh.size(axis)
    rows = {}
    for k, leaf in stacked_state.items():
        row, n_stacked = _local_row(leaf, mesh, axis, n_stages)
        if n_stacked != n_stages:
            # a multiple would hand one rank several stages and run only one
            raise ValueError(
                f"{n_stacked} stacked stages != {n_stages}-way '{axis}' mesh "
                f"axis (one stage per pipeline device)")
        rows[k] = row
    xs, micro, n_data = _split_batch(x, mesh, n_microbatches)
    if n_data > 1:
        # the local stage state's gradient sums every data coordinate's rows
        group = mesh.group("data")
        rows = {k: copy_to(v, group) for k, v in rows.items()}
    ys = run_schedule(lambda t, inp: stage_fn(rows, inp), xs, mesh, axis,
                      n_microbatches)
    if n_data > 1:
        ys = gather_from(ys, mesh.group("data"), 1)
    return ys.reshape(x.shape[0], *ys.shape[2:])
