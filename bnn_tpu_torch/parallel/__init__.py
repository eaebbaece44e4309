"""Parallelism on ``torch.distributed`` (counterpart of ``bnn_tpu/parallel``).

The process model. JAX runs one program over a ``Mesh`` of devices, with
global arrays laid out by ``NamedSharding``. The port runs one process per
device, as PyTorch does:

- **The mesh.** :func:`make_mesh` ``(data, model)`` and
  :func:`make_pipeline_mesh` ``(pipe, data)`` name the axes of
  ``torch.distributed``'s world (a ``DeviceMesh`` underneath), with JAX's
  checks: the axes' product is the world size. Every rank builds the same
  meshes in the same order. ``torch.distributed`` is initialised by the
  caller (``init_process_group``, or ``torchrun``'s environment); without
  either, a mesh makes a world of this one process.
- **The device.** A mesh runs on ``cuda:{LOCAL_RANK}`` over NCCL unless the
  caller passes ``device=``: a CPU device runs over gloo (the tests), and
  ``device='cuda:0'`` on a gloo world puts several ranks on one card.
- **Sharded tensors.** A JAX global array is each rank's local shard plus a
  :class:`Spec` (JAX's ``PartitionSpec``) saying which mesh axis splits
  which dimension. :func:`shard_state`, :func:`shard_model`,
  :func:`shard_optimizer_zero1` and :func:`shard_stacked_state` record it,
  so that ``utils.gather_replicated`` rebuilds the whole tensors. No
  DTensor: plain local tensors with explicit collectives, as JAX's own
  ``shard_map`` code is written.
- **Batches.** :func:`shard_batch` takes the same global batch on every
  rank and returns the rows of the rank's ``data`` coordinate;
  :func:`shard_host_batch` takes each rank's own rows (a
  ``NativeDataLoader`` host shard).
- **What a call returns.** Where JAX returns a global array, the port
  returns the whole tensor on every rank: a pipeline's output, a mesh
  ``Predictor``'s logits (one all-gather over ``data``).

Gradients cross the axes through the autograd Functions of
:mod:`~bnn_tpu_torch.parallel.collectives`, whose backwards are written
out: a tensor-parallel layer's output gather slices the gradient (the
computation after it is replicated), its input sums it.
"""
from .hetero_pipeline import HeteroPipeline
from .mesh import (DEFAULT_TP_RULES, Mesh, Spec, make_mesh, mesh_of,
                   replicate, shard_batch, shard_host_batch, shard_model,
                   shard_optimizer_zero1, shard_state, spec_of)
from .pipeline import (make_pipeline_mesh, make_stage_fn, pipeline_apply,
                       shard_stacked_state, stack_stage_states)
from .trainstep import make_eval_step, make_train_step

__all__ = [
    "make_mesh",
    "shard_batch",
    "shard_host_batch",
    "replicate",
    "shard_state",
    "shard_model",
    "shard_optimizer_zero1",
    "DEFAULT_TP_RULES",
    "make_train_step",
    "make_eval_step",
    "make_pipeline_mesh",
    "HeteroPipeline",
    "stack_stage_states",
    "make_stage_fn",
    "shard_stacked_state",
    "pipeline_apply",
    "Mesh",
    "Spec",
    "spec_of",
    "mesh_of",
]
