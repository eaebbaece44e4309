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

:func:`mesh_gather` is the serving forward's gather as an operator,
``torch.ops.bnn_tpu_torch.mesh_gather``, so that ``torch.export`` traces a
tensor-parallel model (``inference/export.py``): its arguments name the mesh
by its axes and sizes and the axis by name, never a process group or a rank,
so one traced program serves every rank. The real implementation finds the
mesh of that shape that this process built last (each :class:`~bnn_tpu_torch.
parallel.Mesh` registers itself) and gathers over the axis's group; the fake
one gives the shape. No autograd: serving runs without gradients.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["all_reduce_sum", "copy_to", "gather_from", "gather", "ring_permute",
           "broadcast_from_last", "group_ranks", "mesh_gather", "register_mesh"]


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


# -- the exportable gather ----------------------------------------------------

_MESHES: Dict[Tuple[Tuple[str, ...], Tuple[int, ...]], object] = {}


def _mesh_key(names: Sequence[str], sizes: Sequence[int]):
    return tuple(names), tuple(int(s) for s in sizes)


def register_mesh(mesh) -> None:
    """Make ``mesh`` the one :func:`mesh_gather` finds for its shape (every
    rank builds its meshes in the same order, so each finds the same one)."""
    _MESHES[_mesh_key(mesh.shape, mesh.shape.values())] = mesh


def _mesh_gather(x: torch.Tensor, axis_names: List[str], axis_sizes: List[int],
                 axis: str, dim: int) -> torch.Tensor:
    mesh = _MESHES.get(_mesh_key(axis_names, axis_sizes))
    if mesh is None:
        raise RuntimeError(
            f"mesh_gather over a mesh {dict(zip(axis_names, axis_sizes))} that this "
            "process has not built: build it (parallel.Mesh) first, on every rank")
    return gather(x, mesh.group(axis), dim)


def _mesh_gather_fake(x, axis_names, axis_sizes, axis, dim):
    shape = list(x.shape)
    shape[dim] *= axis_sizes[list(axis_names).index(axis)]
    return x.new_empty(shape)


_lib = torch.library.Library("bnn_tpu_torch", "FRAGMENT")
_lib.define("mesh_gather(Tensor x, str[] axis_names, int[] axis_sizes, str axis, "
            "int dim) -> Tensor")
for _key in ("CPU", "CUDA"):
    _lib.impl("mesh_gather", _mesh_gather, _key)
torch.library.register_fake("bnn_tpu_torch::mesh_gather", _mesh_gather_fake, lib=_lib)
del _key


def mesh_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """:func:`gather` of ``x`` over ``mesh``'s ``axis`` along ``dim``,
    through the ``bnn_tpu_torch::mesh_gather`` operator (no autograd)."""
    names = list(mesh.axis_names)
    return torch.ops.bnn_tpu_torch.mesh_gather(
        x, names, [mesh.size(a) for a in names], axis, dim % x.ndim)
