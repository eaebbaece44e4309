"""Device meshes and sharding rules (counterpart of ``bnn_tpu/parallel/mesh.py``).

One process per device (see :mod:`bnn_tpu_torch.parallel`): a :class:`Mesh`
names the axes of ``torch.distributed``'s world, and a sharded tensor is each
rank's local shard plus a :class:`Spec`, JAX's ``PartitionSpec``: for each
dimension, the mesh axis (or axes) that splits it, or None.

Axes, as in the JAX package:

- ``data``: the batch axis. Gradients are averaged over it by the train
  step, BatchNorm reduces its statistics over it, ZeRO-1 splits optimizer
  moments over it.
- ``model``: out-channels of kernels and packed weights (tensor
  parallelism). A sharded layer computes its own out-channels and gathers
  its output over the axis.

The rules are JAX's, with one difference forced by the layouts: JAX's
kernels are out-channel-last (HWIO, ``(I, O)``), so its rules name the last
axis; the port's conv weights are OIHW and its linear weights ``(O, I)``,
out-channels first, and a deployed layer's ``w_packed`` is ``(O, ...)`` in
the conv layout and ``(Kw, N)`` in the GEMM layout. Each default rule
therefore names the out-channel axis of the port's layout for its leaf
(:func:`out_channel_axis`), the axis that JAX's last axis maps to.
"""
from __future__ import annotations

import contextlib
import datetime
import math
import os
import re
import types
import weakref
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .collectives import copy_to, gather, gather_from, register_mesh

__all__ = ["Mesh", "Spec", "make_mesh", "shard_batch", "shard_host_batch",
           "replicate", "shard_state", "shard_model", "shard_optimizer_zero1",
           "DEFAULT_TP_RULES", "spec_of", "mesh_of", "out_channel_axis",
           "gather_tensor", "slice_tensor", "cli_world", "rank_device"]


class Spec(tuple):
    """How a tensor lies on the mesh (JAX's ``PartitionSpec``): one entry
    per leading dimension, None (whole on every rank), an axis name or a
    tuple of axis names. ``Spec()`` is replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"

    def axes(self, dim: int) -> Tuple[str, ...]:
        """The mesh axes that split ``dim``, outermost first."""
        e = self[dim] if dim < len(self) else None
        if e is None:
            return ()
        return tuple(e) if isinstance(e, tuple) else (e,)

    def names(self) -> Tuple[str, ...]:
        return tuple(a for d in range(len(self)) for a in self.axes(d))


REPLICATED = Spec()


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the mesh runs on CUDA by default and no CUDA device is available; "
            "pass device='cpu' (the gloo backend)")
    if "LOCAL_RANK" in os.environ:
        local = int(os.environ["LOCAL_RANK"])
    elif dist.is_initialized():
        local = dist.get_rank() % torch.cuda.device_count()
    else:
        local = 0
    return torch.device("cuda", local)


def _ensure_world(device: torch.device, backend: Optional[str] = None) -> bool:
    """Initialise ``torch.distributed``'s default group if nobody has: from
    the launcher's environment (``torchrun`` sets ``WORLD_SIZE`` and the
    rendezvous address), else as a world of this one process. ``backend``:
    by default NCCL for a CUDA device, gloo for the CPU. Returns whether
    this call made the group."""
    if dist.is_initialized():
        return False
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1,
                                timeout=datetime.timedelta(seconds=60))
    return True


def rank_device(device) -> torch.device:
    """The device a rank serves or trains on: ``device`` as given, a bare
    ``'cuda'`` made ``cuda:{LOCAL_RANK}`` (one card a rank, torchrun's
    layout); ``cuda:0`` on every rank puts the ranks on one card (gloo)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = _default_device()
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


@contextlib.contextmanager
def cli_world(device: torch.device, backend: Optional[str] = None):
    """The default process group of a command-line run (the serve CLI and
    the ImageNet trainer): ``torchrun``'s world, or a world of this one
    process, over ``backend`` (``--dist-backend``; NCCL for CUDA, gloo for
    the CPU by default). Two ranks on one card need gloo: NCCL refuses them
    with its own error, which propagates. A group this call made is
    destroyed on exit."""
    made = _ensure_world(device, backend)
    try:
        yield dist.get_rank(), dist.get_world_size()
    finally:
        if made:
            dist.destroy_process_group()


class Mesh:
    """Named axes over ``torch.distributed``'s world, on a
    ``torch.distributed.device_mesh.DeviceMesh``.

    ``shape`` maps axis names to sizes (outermost first, ranks laid out in
    row-major order, as JAX reshapes its device list); their product must
    be the world size. ``device``: this rank's device, by default
    ``cuda:{LOCAL_RANK}`` (NCCL); a CPU device runs over gloo. Every rank
    builds the same mesh, in the same order (the axis groups are made
    collectively)."""

    def __init__(self, shape: Mapping[str, int], device=None):
        names = tuple(shape)
        sizes = tuple(int(shape[n]) for n in names)
        if len(set(names)) != len(names) or not names:
            raise ValueError(f"mesh axes must be distinct names, got {names}")
        self.device = _default_device() if device is None else torch.device(device)
        _ensure_world(self.device)
        world = dist.get_world_size()
        if math.prod(sizes) != world:
            raise ValueError(f"mesh {'x'.join(map(str, sizes))} != {world} devices")
        from torch.distributed.device_mesh import init_device_mesh

        # the DeviceMesh's device type only labels it here: the tensors'
        # device is ``self.device``, and gloo carries CUDA tensors too
        kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
        self.device_mesh = init_device_mesh(kind, sizes, mesh_dim_names=names)
        self.shape: Dict[str, int] = dict(zip(names, sizes))
        register_mesh(self)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def rank(self) -> int:
        return dist.get_rank()

    def size(self, axis: str) -> int:
        """The axis's size (1 for an axis the mesh does not have)."""
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 for an absent axis)."""
        if axis not in self.shape:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        """The process group of the ranks that differ only on ``axis``."""
        return self.device_mesh.get_group(axis)

    def __deepcopy__(self, memo):
        # a process-wide resource: copies of a placed model share it
        return self

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def make_mesh(data: Optional[int] = None, model: int = 1, device=None) -> Mesh:
    """A ``(data, model)`` mesh over the world; ``data=None`` takes every
    rank the model axis leaves."""
    if not dist.is_initialized():
        _ensure_world(_default_device() if device is None else torch.device(device))
    n = dist.get_world_size()
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices do not split over a model axis of {model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return Mesh({"data": data, "model": model}, device)


# -- tensors on the mesh ------------------------------------------------------

def _axis_index(mesh: Mesh, axes: Sequence[str]) -> Tuple[int, int]:
    """(this rank's index, the number of pieces) over ``axes`` combined,
    outermost first."""
    idx, size = 0, 1
    for a in axes:
        idx = idx * mesh.size(a) + mesh.index(a)
        size *= mesh.size(a)
    return idx, size


def slice_tensor(full: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of ``full`` under ``spec`` (a copy)."""
    out = full
    for d in range(len(spec)):
        axes = spec.axes(d)
        if not axes:
            continue
        i, n = _axis_index(mesh, axes)
        if out.shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(full.shape)} does not "
                             f"split over {n} ranks of {axes}")
        step = out.shape[d] // n
        out = out.narrow(d, i * step, step)
    return out.clone() if out is full else out.contiguous().clone()


def gather_tensor(local: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every rank's shard under ``spec``; a collective
    over the axes ``spec`` names."""
    out = local
    for d in range(len(spec)):
        for a in reversed(spec.axes(d)):
            out = gather(out, mesh.group(a), d)
    return out


class _Layouts:
    """``(mesh, spec)`` of tensors, by identity, for as long as each tensor
    lives: kept beside the tensor, not on it, so that ``torch.save`` of a
    shard holds no mesh."""

    def __init__(self):
        self._by_id = {}

    def set(self, t: torch.Tensor, value) -> None:
        key = id(t)
        by_id = self._by_id
        by_id[key] = (weakref.ref(t, lambda _, key=key: by_id.pop(key, None)), value)

    def get(self, t):
        entry = self._by_id.get(id(t))
        return entry[1] if entry is not None and entry[0]() is t else None


_LAYOUTS = _Layouts()


def _tag(t: torch.Tensor, mesh: Mesh, spec: Spec) -> torch.Tensor:
    _LAYOUTS.set(t, (mesh, Spec(*spec)))
    return t


def layout_of(t):
    """``(mesh, spec)`` a shard_* function recorded for ``t``, or None."""
    return _LAYOUTS.get(t) if isinstance(t, torch.Tensor) else None


def spec_of(t) -> Spec:
    """The :class:`Spec` a shard_* function recorded for ``t`` (replicated
    when none did)."""
    layout = layout_of(t)
    return layout[1] if layout else REPLICATED


def global_shape(t: torch.Tensor, spec: Spec, mesh: Mesh) -> Tuple[int, ...]:
    return tuple(s * _axis_index(mesh, spec.axes(d))[1] if d < len(spec) else s
                 for d, s in enumerate(t.shape))


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return fn(torch.from_numpy(tree))
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def shard_batch(batch, mesh: Mesh, axis: str = "data"):
    """This rank's rows of a batch (tensors or arrays with a leading batch
    dimension, in tuples, lists and dicts), on the mesh's device.

    Every rank passes the SAME global batch (JAX's contract,
    ``bnn_tpu/parallel/mesh.py:50-61``) and keeps the rows of its ``axis``
    coordinate: rank ``i`` of ``n`` the ``i``-th of ``n`` equal blocks."""
    return tag_rows(_tree_map(lambda x: batch_rows(x, mesh, axis).to(mesh.device),
                              batch), mesh, axis)


def batch_rows(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """The rows of ``x`` that :func:`shard_batch` keeps on this rank, where
    ``x`` lies (a view)."""
    i, n = mesh.index(axis), mesh.size(axis)
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} does not split over the "
                         f"{n}-way '{axis}' axis")
    step = x.shape[0] // n
    return x.narrow(0, i * step, step)


def tag_rows(batch, mesh: Mesh, axis: str = "data"):
    """Record on each tensor of a batch that it holds this rank's rows."""
    spec = Spec(axis if mesh.size(axis) > 1 else None)
    return _tree_map(lambda x: _tag(x, mesh, spec), batch)


def shard_host_batch(batch, mesh: Mesh, axis: str = "data"):
    """Each rank's own rows, as the shard of a global batch: the multi-host
    ``NativeDataLoader`` contract, where every rank assembles
    ``global_batch / process_count`` rows. Pass the loader the rank's
    ``axis`` coordinate as ``process_index`` and the axis size as
    ``process_count`` where the mesh has other axes (the ranks of one data
    coordinate must see the same rows). The rows move to the mesh's
    device; nothing else happens to them."""
    return tag_rows(_tree_map(lambda x: x.to(mesh.device), batch), mesh, axis)


def replicate(tree, mesh: Mesh):
    """Every tensor of ``tree`` whole on every rank, on the mesh's device."""
    return _tree_map(lambda x: _tag(x.to(mesh.device), mesh, REPLICATED), tree)


# -- tensor-parallel rules ----------------------------------------------------

def out_channel_axis(module: nn.Module, t: torch.Tensor) -> Optional[int]:
    """The out-channel axis of a leaf ``t`` of ``module`` in the port's
    layout, where JAX's out-channel-last layout puts its last axis; None for
    a leaf JAX's rules leave whole (PReLU's slope is JAX's ``weight``, which
    no rule names)."""
    from ..inference.deploy import DeployedConv, DeployedLinear

    if isinstance(module, nn.PReLU):
        return None
    if t.ndim == 1:
        return 0
    if isinstance(module, (DeployedConv, DeployedLinear)):
        # (Kw, N) GEMM words; (O, ...) in the conv layouts
        return 1 if t.ndim == 2 else 0
    if isinstance(module, nn.modules.conv._ConvTransposeNd):
        return 1
    if isinstance(module, (nn.modules.conv._ConvNd, nn.Linear)):
        return 0
    return None


def _out_channels(module: nn.Module, t: torch.Tensor) -> Optional[Spec]:
    axis = out_channel_axis(module, t)
    if axis is None:
        return None
    return Spec(*([None] * axis + ["model"]))


# Tensor-parallel rules: dotted state_dict path regex -> spec factory taking
# the leaf's module and tensor (None: the leaf stays whole). The port's
# names for JAX's leaves: ``weight`` is JAX's ``kernel`` (conv, linear) and
# BatchNorm / LayerNorm ``scale``; ``w_packed``, ``bias``, ``scale``,
# ``add`` keep their names.
DEFAULT_TP_RULES: Tuple[Tuple[str, Callable], ...] = (
    (r"\bweight$", _out_channels),
    (r"\bw_packed$", _out_channels),
    (r"\bbias$", _out_channels),
    (r"\bscale$", _out_channels),
    (r"\badd$", _out_channels),
)


def _leaves(module: nn.Module):
    """``(state_dict name, owning module, leaf name, tensor)`` of every
    parameter and buffer."""
    for mname, m in module.named_modules():
        for leaf, t in list(m._parameters.items()) + list(m._buffers.items()):
            if t is None or (leaf in m._buffers and leaf in m._non_persistent_buffers_set):
                continue
            name = f"{mname}.{leaf}" if mname else leaf
            yield name, m, leaf, t


def _rule_specs(module: nn.Module, mesh: Mesh, rules, min_size: int) -> Dict[str, Spec]:
    specs: Dict[str, Spec] = {}
    for name, m, _, t in _leaves(module):
        spec = REPLICATED
        if t.numel() >= min_size:
            for pat, spec_fn in rules:
                if re.search(pat, name):
                    cand = spec_fn(m, t)
                    if cand is not None:
                        cand = Spec(*cand)
                        # gate and divisibility per the axes THIS spec names
                        sizes = [(_axis_index(mesh, cand.axes(d))[1], d)
                                 for d in range(len(cand)) if cand.axes(d)]
                        if (any(s > 1 for s, _ in sizes)
                                and all(t.shape[d] % s == 0 for s, d in sizes)):
                            spec = cand
                    break
        specs[name] = spec
    return specs


def shard_state(module: nn.Module, mesh: Mesh, rules=DEFAULT_TP_RULES,
                min_size: int = 1024) -> Dict[str, torch.Tensor]:
    """Apply tensor-parallel rules to a module's state: ``{state_dict name:
    this rank's shard}``, each shard carrying its :class:`Spec`
    (:func:`spec_of`). A leaf whose path matches a rule, holds at least
    ``min_size`` elements, and whose dimensions divide over the axes the
    rule's spec names gets that spec; everything else is replicated. The
    module is not changed."""
    specs = _rule_specs(module, mesh, rules, min_size)
    return {name: _tag(slice_tensor(t.detach(), specs[name], mesh), mesh, specs[name])
            for name, _, _, t in _leaves(module)}


class Placement:
    """What :func:`shard_model` recorded on a module: the mesh and each
    state_dict entry's :class:`Spec`."""

    def __init__(self, mesh: Mesh, specs: Dict[str, Spec]):
        self.mesh, self.specs = mesh, specs

    def sharded(self) -> Dict[str, Spec]:
        return {k: s for k, s in self.specs.items() if s.names()}


def placement_of(obj) -> Optional[Placement]:
    return getattr(obj, "_bnn_placement", None)


def mesh_of(obj) -> Optional[Mesh]:
    """The mesh a module (or optimizer) was placed on, or None."""
    p = placement_of(obj)
    if p is not None:
        return p.mesh
    z = getattr(obj, "_bnn_zero1", None)
    return z.mesh if z is not None else None


# -- tensor-parallel forwards -------------------------------------------------

def _layer_forward(self, x):
    """A conv or linear layer whose weight (and maybe bias) is this rank's
    out-channel shard: the local output channels, gathered over the model
    axis. The input's gradient is summed over the axis (each rank holds the
    part from its own channels); the gather's backward is the slice. A
    replicated bias and the binary layers' output scale apply after the
    gather, on the whole channels."""
    mesh, axis, bias_sharded = self._bnn_tp
    group = mesh.group(axis)
    binary = hasattr(self, "weight_pre_process")
    xin = copy_to(x, group)
    if binary:
        xin = self.activation_pre_process(xin)
        w = self.weight_pre_process(self.weight)
    else:
        w = self.weight
    local_bias = self.bias if bias_sharded else None
    if isinstance(self, nn.Linear):
        y = gather_from(F.linear(xin, w, local_bias), group, -1)
    else:
        y = gather_from(self._conv_forward(xin, w, local_bias), group, 1)
    if self.bias is not None and not bias_sharded:
        shape = (-1,) if isinstance(self, nn.Linear) else (1, -1) + (1,) * (y.ndim - 2)
        y = y + self.bias.view(shape)
    if binary:
        y = self.activation_post_process(y, x)
    return y


def _gathered_forward(self, *args, **kwargs):
    """Any other module with sharded leaves: each shard is gathered whole
    before the module's own forward (the gather's backward is the slice)."""
    mesh, leaves = self._bnn_tp
    saved = {}
    for leaf, spec, is_param in leaves:
        store = self._parameters if is_param else self._buffers
        local = store[leaf]
        saved[leaf] = (store, local)
        full = local
        for d in range(len(spec)):
            for a in reversed(spec.axes(d)):
                full = gather_from(full, mesh.group(a), d)
        store[leaf] = full
    try:
        return type(self).forward(self, *args, **kwargs)
    finally:
        for leaf, (store, local) in saved.items():
            store[leaf] = local


def _install_forwards(module: nn.Module, mesh: Mesh, specs: Dict[str, Spec]) -> None:
    from ..inference.deploy import DeployedConv, DeployedLinear

    by_module: Dict[str, list] = {}
    for name, m, leaf, t in _leaves(module):
        spec = specs.get(name, REPLICATED)
        if spec.names():
            by_module.setdefault(id(m), [m]).append((leaf, spec, leaf in m._parameters))
    for entry in by_module.values():
        m, leaves = entry[0], entry[1:]
        named = {leaf: spec for leaf, spec, _ in leaves}
        axes = {a for _, spec, _ in leaves for a in spec.names()}
        if "data" in axes:
            raise ValueError(
                "shard_model runs the computation replicated over the axes it "
                "shards parameters on; the batch axis 'data' cannot be one "
                "(shard_state reports such specs)")
        if isinstance(m, (DeployedConv, DeployedLinear)) and "w_packed" in named:
            (axis,) = named["w_packed"].names()
            m.tp_axis, m.tp_mesh = axis, mesh
        elif (isinstance(m, (nn.modules.conv._ConvNd, nn.Linear))
              and not isinstance(m, nn.modules.conv._ConvTransposeNd)
              and "weight" in named and len(named["weight"].names()) == 1
              and named["weight"].axes(0) and set(named) <= {"weight", "bias"}):
            (axis,) = named["weight"].names()
            m._bnn_tp = (mesh, axis, "bias" in named)
            m.forward = types.MethodType(_layer_forward, m)
        else:
            m._bnn_tp = (mesh, leaves)
            m.forward = types.MethodType(_gathered_forward, m)


def _assign(module: nn.Module, values: Mapping[str, torch.Tensor]) -> None:
    """Put ``values`` (state_dict names) into the module's tensors, shapes
    included: a parameter keeps its identity (optimizers hold it)."""
    owners = {name: (m, leaf) for name, m, leaf, _ in _leaves(module)}
    with torch.no_grad():
        for name, v in values.items():
            m, leaf = owners[name]
            if leaf in m._parameters:
                m._parameters[leaf].data = v
            else:
                m._buffers[leaf] = v


def _set_batch_sync(module: nn.Module, mesh: Mesh) -> None:
    from ..nn import BatchNorm2d

    group_size = mesh.size("data")
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.sync_axis = ("data", mesh) if group_size > 1 else None


def shard_model(obj, mesh: Mesh, rules=DEFAULT_TP_RULES, min_size: int = 1024):
    """Place a module (or an optimizer's state) on the mesh, in place.

    A module moves to the mesh's device; with a ``model`` axis over 1 its
    leaves are sharded by ``rules`` (:func:`shard_state`) and each layer
    with a sharded leaf computes its own part and gathers over the axis;
    with a ``data`` axis over 1 every BatchNorm normalises with the
    statistics of the whole batch over the axis (a differentiable all-reduce
    of its sums), and :func:`~bnn_tpu_torch.parallel.make_train_step`
    averages the gradients over it. The mesh and the specs are recorded on
    the module (:func:`mesh_of`). Placing a module on the mesh it is
    already on changes nothing. An optimizer's moments of a sharded
    parameter are cut to its shard.
    """
    if isinstance(obj, torch.optim.Optimizer):
        localize_optimizer_state(obj)
        return obj
    placement = placement_of(obj)
    if placement is not None:
        if placement.mesh is not mesh:
            raise ValueError("the module is already placed on another mesh")
        return obj
    obj.to(mesh.device)
    specs = _rule_specs(obj, mesh, rules, min_size)
    sharded = {k: s for k, s in specs.items() if s.names()}
    if sharded:
        tensors = {name: t for name, _, _, t in _leaves(obj)}
        _install_forwards(obj, mesh, sharded)
        _assign(obj, {k: slice_tensor(tensors[k].detach(), s, mesh)
                      for k, s in sharded.items()})
        for name, _, _, t in _leaves(obj):
            if name in sharded:
                _tag(t, mesh, sharded[name])
    _set_batch_sync(obj, mesh)
    obj._bnn_placement = Placement(mesh, specs)
    return obj


def localize_state_dict(module: nn.Module, state: Mapping[str, torch.Tensor]) -> Dict:
    """A whole-tensor ``state`` (a checkpoint's) cut to this rank's shards
    of a placed module; unchanged for a module that is not placed."""
    placement = placement_of(module)
    if placement is None:
        return dict(state)
    out = dict(state)
    for k, spec in placement.sharded().items():
        if k in out and isinstance(out[k], torch.Tensor):
            out[k] = slice_tensor(out[k], spec, placement.mesh)
    return out


# -- ZeRO-1 -------------------------------------------------------------------

# JAX -> port axis order of a kernel of each rank (bnn_tpu_torch/utils/
# jax_weights.py's permutation), so that the ZeRO-1 rule walks the axes in
# JAX's order
_KERNEL_PERM = {4: (3, 2, 0, 1), 3: (2, 1, 0), 2: (1, 0)}


def _jax_order(ndim: int) -> Tuple[int, ...]:
    perm = _KERNEL_PERM.get(ndim)
    return tuple(perm.index(j) for j in range(ndim)) if perm else tuple(range(ndim))


def _zero1_dim(shape: Tuple[int, ...], spec: Spec, n: int) -> Optional[int]:
    """JAX's rule (``bnn_tpu/parallel/mesh.py:186-202``) in the port's
    layout: the largest dimension that ``n`` divides and no axis shards yet,
    later JAX axes winning ties."""
    best = None
    for d in _jax_order(len(shape)):
        if not spec.axes(d) and shape[d] % n == 0 and (
                best is None or shape[d] >= shape[best]):
            best = d
    return best


class _Zero1:
    """The ZeRO-1 record of an optimizer: for each split parameter, the dim
    it is cut on and the shard the optimizer steps in its place. Outside
    ``step()`` the optimizer holds its own parameters (``zero_grad`` and
    ``state_dict`` see them) with this rank's slices of their moments; for
    the step, each split parameter and its moments trade places with its
    shard."""

    def __init__(self, mesh: Mesh, axis: str):
        self.mesh, self.axis = mesh, axis
        self.entries = []          # (param, shard, dim, group, index)

    def narrow(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        n, i = self.mesh.size(self.axis), self.mesh.index(self.axis)
        step = t.shape[dim] // n
        return t.narrow(dim, i * step, step)

    def dims(self) -> Dict[int, int]:
        return {id(p): d for p, _, d, _, _ in self.entries}

    def before_step(self, optimizer, *_):
        localize_optimizer_state(optimizer)
        with torch.no_grad():
            for p, s, d, g, j in self.entries:
                s.copy_(self.narrow(p, d))
                s.grad = None if p.grad is None else self.narrow(p.grad, d).contiguous()
                optimizer.param_groups[g]["params"][j] = s
                if p in optimizer.state:
                    optimizer.state[s] = optimizer.state.pop(p)

    def after_step(self, optimizer, *_):
        """Hand the parameters back, and all-gather the updated shards into
        them: one collective per dtype, each shard moved to its cut
        dimension first."""
        group = self.mesh.group(self.axis)
        n = self.mesh.size(self.axis)
        by_dtype: Dict[torch.dtype, list] = {}
        for p, s, d, g, j in self.entries:
            optimizer.param_groups[g]["params"][j] = p
            if s in optimizer.state:
                optimizer.state[p] = optimizer.state.pop(s)
            s.grad = None
            by_dtype.setdefault(s.dtype, []).append((p, s, d))
        with torch.no_grad():
            for entries in by_dtype.values():
                flat = torch.cat([s.movedim(d, 0).reshape(-1) for _, s, d in entries])
                parts = [torch.empty_like(flat) for _ in range(n)]
                dist.all_gather(parts, flat, group=group)
                off = 0
                for p, s, d in entries:
                    moved = s.movedim(d, 0).shape
                    k = s.numel()
                    full = torch.cat([q[off:off + k].reshape(moved) for q in parts])
                    p.copy_(full.movedim(0, d))
                    off += k


def _param_layout(optimizer) -> list:
    """``(param, mesh, Spec of its moments, whole shape, this rank's moment
    shape)`` for each parameter the optimizer steps, in ``state_dict``
    order: a ZeRO-1 parameter's moments lie as its own spec with the data
    axis on the cut dimension."""
    z = getattr(optimizer, "_bnn_zero1", None)
    dims = z.dims() if z is not None else {}
    out = []
    for g in optimizer.param_groups:
        for q in g["params"]:
            mesh, spec = layout_of(q) or (z.mesh if z is not None else None, REPLICATED)
            whole = global_shape(q, spec, mesh) if mesh is not None else tuple(q.shape)
            local = list(q.shape)
            if id(q) in dims:
                d = dims[id(q)]
                entries = list(spec) + [None] * (q.ndim - len(spec))
                entries[d] = z.axis
                spec = Spec(*entries)
                local[d] //= z.mesh.size(z.axis)
            out.append((q, mesh, spec, whole, tuple(local)))
    return out


def localize_optimizer_state(optimizer) -> None:
    """Cut every moment that holds a whole tensor (restored from a gathered
    checkpoint) to this rank's shard; moments already cut stay."""
    for q, mesh, spec, whole, local in _param_layout(optimizer):
        st = optimizer.state.get(q)
        if not st or mesh is None or whole == local:
            continue
        for k, v in list(st.items()):
            if isinstance(v, torch.Tensor) and v.ndim > 0 and tuple(v.shape) == whole:
                st[k] = slice_tensor(v, spec, mesh).to(q.device)


def optimizer_whole_shapes(optimizer) -> list:
    """The whole shape of each stepped parameter, in ``state_dict`` order."""
    return [whole for _, _, _, whole, _ in _param_layout(optimizer)]


def gather_optimizer_state(optimizer) -> Dict:
    """``optimizer.state_dict()`` with every moment whole: a collective over
    the axes the moments are split on."""
    sd = optimizer.state_dict()
    ids = [i for g in sd["param_groups"] for i in g["params"]]
    state = {}
    for i, (q, mesh, spec, _, _) in zip(ids, _param_layout(optimizer)):
        st = sd["state"].get(i)
        if st is None:
            continue
        state[i] = {k: (gather_tensor(v, spec, mesh)
                        if mesh is not None and isinstance(v, torch.Tensor)
                        and v.ndim > 0 and spec.names() else v)
                    for k, v in st.items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def shard_optimizer_zero1(optimizer, mesh: Mesh, axis: str = "data",
                          min_size: int = 1024):
    """ZeRO-1 optimizer-state sharding over the data axis.

    Each parameter of at least ``min_size`` elements with a dimension that
    the axis divides (JAX's rule: the largest such dimension not already
    sharded, later JAX axes winning ties, so the same logical axis as JAX's)
    keeps only this rank's slice of its moments, and ``optimizer.step()``
    updates only that slice: before the step the slice of the parameter and
    of its gradient take the parameter's place in the optimizer, after it
    the updated slices are all-gathered into the parameter (ZeRO stage 1:
    1/n of the moments and of the elementwise update a rank, one all-gather
    of the parameters a step). Any elementwise optimizer works (the recipe
    optimizers, ``torch.optim``'s). Parameters stay whole (or as their
    tensor-parallel spec has them); gradients are averaged over the axis by
    the train step first. ``torch.distributed.optim.ZeroRedundancyOptimizer``
    is another thing: it gives whole parameters to ranks.

    Moments that hold whole tensors (restored from a gathered checkpoint by
    ``restore_optimizer``) are cut at the next step or the next call. A
    second call on the same mesh changes nothing else. Mutates the
    optimizer and returns it."""
    z = getattr(optimizer, "_bnn_zero1", None)
    if z is not None:
        if z.mesh is not mesh or z.axis != axis:
            raise ValueError("the optimizer is already sharded over another mesh axis")
        localize_optimizer_state(optimizer)
        return optimizer
    z = _Zero1(mesh, axis)
    n = mesh.size(axis)
    if n > 1:
        for g, group in enumerate(optimizer.param_groups):
            for j, p in enumerate(group["params"]):
                layout = layout_of(p)
                spec = layout[1] if layout else REPLICATED
                whole = global_shape(p, spec, mesh)
                if axis in spec.names() or p.ndim < 1 or math.prod(whole) < min_size:
                    continue
                d = _zero1_dim(tuple(p.shape), spec, n)
                if d is not None:
                    shard = nn.Parameter(z.narrow(p.detach(), d).clone())
                    z.entries.append((p, shard, d, g, j))
    optimizer._bnn_zero1 = z
    localize_optimizer_state(optimizer)
    optimizer.register_step_pre_hook(z.before_step)
    optimizer.register_step_post_hook(z.after_step)
    return optimizer
