"""Differentiable collectives over a mesh axis's process group.

JAX's ``shard_map`` code transposes its collectives for free; here each one
is a ``torch.autograd.Function`` whose backward is written out. Every rank
of the group calls each of them, in the same order, in the forward and (for
those with a collective backward) in the backward.

- :func:`all_reduce_sum`: sum over the group; backward: the sum of the
  incoming gradients (a replicated sum feeds every rank's loss).
- :func:`copy_to`: identity; backward: the sum of the gradients, the input
  side of a layer whose output channels are split over the group.
- :func:`gather_from`: concatenation of every rank's piece along ``dim``;
  backward: this rank's slice of the incoming gradient. The computation after
  the gather is replicated, so each rank already holds the whole gradient.
- :func:`ring_permute`: rank ``i`` sends to ``i + 1`` (mod n) and receives
  from ``i - 1``; backward: the inverse permute.
- :func:`broadcast_from_last`: every rank receives the last rank's tensor;
  backward: the last rank keeps its own gradient, the others get zeros
  (every rank computes the same loss from the broadcast value, so one copy
  of the gradient is the whole of it).

The gathers go through ``dist.all_gather`` into a list (the form the gloo
backend takes for every dtype); a group of one rank is an identity and
moves nothing.
"""
from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

__all__ = ["all_reduce_sum", "copy_to", "gather_from", "gather", "ring_permute",
           "broadcast_from_last", "group_ranks"]


def group_ranks(group) -> List[int]:
    """The global ranks of ``group``, in group order."""
    return dist.get_process_group_ranks(group)


def _size(group) -> int:
    return dist.get_world_size(group)


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` (no autograd)."""
    n = _size(group)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _local_slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = _size(group)
    i = dist.get_rank(group)
    step = x.shape[dim] // n
    return x.narrow(dim, i * step, step).contiguous()


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    if _size(group) == 1:
        return x
    x = x.contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if _size(ctx.group) == 1:
            return g, None, None
        return _local_slice(g, ctx.group, ctx.dim), None, None


def _permute(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    ranks = group_ranks(group)
    n = len(ranks)
    if n == 1:
        return x
    i = ranks.index(dist.get_rank())
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ranks[(i + shift) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(i - shift) % n], group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _permute(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.group, -1), None


class _BroadcastFromLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ranks = group_ranks(group)
        ctx.last = dist.get_rank() == ranks[-1]
        if len(ranks) == 1:
            return x
        x = x.contiguous().clone()
        dist.broadcast(x, src=ranks[-1], group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group) if x.requires_grad else x


def gather_from(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _GatherFrom.apply(x, group, dim % x.ndim)


def ring_permute(x: torch.Tensor, group) -> torch.Tensor:
    return _RingPermute.apply(x, group)


def broadcast_from_last(x: torch.Tensor, group) -> torch.Tensor:
    return _BroadcastFromLast.apply(x, group)
