"""Serving-boundary batching and the frozen serving bundle (counterpart of
``bnn_tpu/inference/export.py``).

A ``Predictor`` is frozen into a directory with ``torch.export``: its served
model as one traced program, every kernel a node of the port's own
operators (``kernels/ops.py``), the weights inside::

    predictor = Predictor(model, batch_size=8)
    export_serving(predictor, "r18.bundle", input_shape=(3, 224, 224))

    server = load_serving("r18.bundle")    # builds no model
    logits = server(images)                # Predictor's padding semantics

Design points:

- The program is traced at inference (eval mode, no grad, weights without
  ``requires_grad``), non-strict: ``torch.export`` runs the model's Python
  forward on fake tensors, where each kernel operator answers with its fake
  implementation; nothing is launched and no module state changes, so the
  live predictor serves bit-identically after an export.
- A bundle runs on the device type it was exported on (``meta["platforms"]``):
  the CUDA operators launch the hand kernels and the CPU ones run the plain
  versions, so a ``cuda`` bundle never runs on the CPU unless exported
  there; tensors made during the forward carry their device in the graph
  too. Another ``platforms=`` is refused, as the JAX package refuses a
  Pallas artifact on another platform.
- The batch is static (``batch_size`` rides in ``meta.json``); the loader
  reproduces ``Predictor.__call__``'s pad / split / strip through the
  shared :func:`batched_call`.

Bundle layout (a directory)::

    program.pt2   torch.export.save of the ExportedProgram, weights inside
    meta.json     format_version, batch_size, input_shape (per example,
                  NCHW), layout, input_dtype, platforms, nr_devices, mesh,
                  torch version
    shards.pt     (mesh bundles with sharded weights) each sharded state
                  tensor whole, by the program's state name

Mesh bundles (format 2). A ``Predictor(mesh=...)`` (one process per device,
data- and / or tensor-parallel) freezes as one program that every rank
serves: the forward of one rank on its rows, the batch's ``batch_size /
data`` rows, with each tensor-parallel layer's gather a
``bnn_tpu_torch::mesh_gather`` node that names the mesh by its axes and sizes
(``parallel/collectives.py``), never a rank or a process group. Every rank
calls ``export_serving`` (the sharded weights are gathered whole, a
collective); rank 0 writes. ``meta.json`` records ``nr_devices`` (the world
size) and ``mesh``: ``axis_names``, ``axis_sizes``, ``x_spec`` (the request
batch split over the data axis, as JAX's ``P(batch_axis)``) and
``state_specs``, each state tensor's :class:`~bnn_tpu_torch.parallel.Spec`.
``load_serving`` on every rank of a world of the same size rebuilds the mesh
(``parallel.Mesh``), cuts each sharded tensor to this rank's shard and
serves as the live predictor does: this rank's rows through the program,
the logits gathered over the data axis, ``batched_call``'s pad / split /
strip around it. A world of another size is refused, as JAX refuses too few
devices, and so is ``platforms=`` with a mesh.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import SERVE_CALL, SERVE_COPY_IN, SERVE_FORWARD, span

__all__ = ["batched_call", "data_parallel_call", "export_serving", "load_serving",
           "ExportedServer"]

_FORMAT_VERSION = 1         # one device
_MESH_FORMAT_VERSION = 2    # a mesh of ranks
_PROGRAM = "program.pt2"
_META = "meta.json"
_SHARDS = "shards.pt"


def batched_call(one_batch, x: torch.Tensor, batch_size: int) -> torch.Tensor:
    """Pad ``x`` up to a multiple of ``batch_size`` rows, run ``one_batch``
    on each fixed-size chunk, concatenate and strip the padding rows; shared
    by ``Predictor.__call__`` and :meth:`ExportedServer.__call__` so that the
    two cannot drift apart."""
    n, bs = x.shape[0], batch_size
    if n == 0:
        # fabricating an output for zero rows would run a padded batch for
        # nothing; the contract violation is the caller's to hear about
        raise ValueError("empty request batch (0 rows)")
    padded_n = -(-n // bs) * bs
    if padded_n != n:
        x = F.pad(x, (0, 0) * (x.ndim - 1) + (0, padded_n - n))
    outs = [one_batch(x[i:i + bs]) for i in range(0, padded_n, bs)]
    out = torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]
    return out[:n]


def data_parallel_call(one_batch, x: torch.Tensor, mesh, batch_axis: str) -> torch.Tensor:
    """``one_batch`` on this rank's rows of ``x`` (the ``batch_axis``
    coordinate's share), then every rank's outputs gathered in rank order:
    the whole batch's on every rank. Without a mesh, or on a batch axis of
    one, ``one_batch(x)``. Shared by ``Predictor`` and
    :class:`ExportedServer`."""
    if mesh is None or mesh.size(batch_axis) <= 1:
        return one_batch(x)
    from ..parallel.collectives import gather
    from ..parallel.mesh import batch_rows

    return gather(one_batch(batch_rows(x, mesh, batch_axis)), mesh.group(batch_axis), 0)


def _encode_spec(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _decode_spec(entries):
    from ..parallel.mesh import Spec

    return Spec(*[tuple(e) if isinstance(e, list) else e for e in entries])


def _world_size() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


class _Forward(nn.Module):
    """``Predictor._model_forward`` as a module: the model's first output."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.model(x)
        return out[0] if isinstance(out, tuple) else out


def export_serving(predictor, path: str, input_shape: Sequence[int], *,
                   platforms: Optional[Sequence[str]] = None) -> None:
    """Write ``predictor`` as a self-contained bundle at ``path``.

    ``predictor``: a ``Predictor``, or anything with its ``model``,
    ``batch_size``, ``dtype`` and ``device``. ``input_shape``: the
    per-example shape in the port's NCHW, e.g. ``(3, 224, 224)``.
    ``platforms``: the device type to export for; only the predictor's own
    (``["cuda"]`` or ``["cpu"]``) is accepted, because the program holds
    that device's kernels and tensors.
    """
    device = torch.device(predictor.device)
    mesh = getattr(predictor, "mesh", None)
    if mesh is not None and platforms is not None:
        raise ValueError(
            "platforms= and a mesh predictor are mutually exclusive: a mesh "
            "bundle runs on the device type its ranks serve on")
    if platforms is not None and list(platforms) != [device.type]:
        raise ValueError(
            f"a bundle runs on the device type it is exported on: this "
            f"predictor serves on {device.type!r}, platforms={list(platforms)} "
            "asks for another; build the predictor there and export it there")
    model = predictor.model
    rows = predictor.batch_size
    batch_axis = getattr(predictor, "batch_axis", "data")
    if mesh is not None:
        rows //= mesh.size(batch_axis)
    x = torch.zeros((rows, *input_shape), dtype=predictor.dtype, device=device)
    training = model.training
    needs_grad = [p for p in model.parameters() if p.requires_grad]
    model.eval()
    try:
        for p in needs_grad:
            p.requires_grad_(False)
        with torch.no_grad():
            program = torch.export.export(_Forward(model), (x,), strict=False)
    finally:
        for p in needs_grad:
            p.requires_grad_(True)
        model.train(training)
    meta = {
        "format_version": _FORMAT_VERSION,
        "batch_size": predictor.batch_size,
        "input_shape": list(input_shape),
        "layout": "NCHW",
        "input_dtype": str(predictor.dtype).replace("torch.", ""),
        "platforms": [device.type],
        "nr_devices": 1,
        "mesh": None,
        "torch": torch.__version__,
    }
    if mesh is None:
        _write_bundle(path, program, meta, {})
        return
    _export_mesh(predictor, path, program, meta, batch_axis)


def _write_bundle(path: str, program, meta: dict, shards: dict) -> None:
    os.makedirs(path, exist_ok=True)
    torch.export.save(program, os.path.join(path, _PROGRAM))
    if shards:
        torch.save(shards, os.path.join(path, _SHARDS))
    with open(os.path.join(path, _META), "w") as f:
        json.dump(meta, f, indent=1)


def _export_mesh(predictor, path: str, program, meta: dict, batch_axis: str) -> None:
    """The mesh half of :func:`export_serving`, on every rank: each sharded
    state tensor gathered whole (the program's own are this rank's shards,
    the same shapes on every rank), then rank 0 writes and every rank
    returns once the bundle is in place."""
    import torch.distributed as dist

    from ..parallel.mesh import REPLICATED, gather_tensor

    mesh = predictor.mesh
    # one program file serves every rank only if no rank traced its own
    code = hashlib.sha1(program.graph_module.code.encode()).hexdigest()
    codes = [None] * dist.get_world_size()
    dist.all_gather_object(codes, code)
    if len(set(codes)) > 1:
        raise RuntimeError("the ranks traced different programs: a mesh bundle "
                           "holds one program that every rank serves")
    specs = getattr(predictor, "tp_specs", None) or {}
    state_specs = {k: specs.get(k.removeprefix("model."), REPLICATED)
                   for k in program.state_dict}
    shards = {k: gather_tensor(program.state_dict[k], spec, mesh).cpu()
              for k, spec in sorted(state_specs.items()) if spec.names()}
    meta.update(
        format_version=_MESH_FORMAT_VERSION, nr_devices=dist.get_world_size(),
        device=str(torch.device(predictor.device)),
        mesh={"axis_names": list(mesh.axis_names),
              "axis_sizes": [mesh.size(a) for a in mesh.axis_names],
              "x_spec": [batch_axis] if batch_axis in mesh.shape else [],
              "state_specs": {k: _encode_spec(s) for k, s in state_specs.items()}})
    written = torch.zeros((), device=mesh.device)
    error = None
    if dist.get_rank() == 0:
        try:
            _write_bundle(path, program, meta, shards)
            written.fill_(1)
        except Exception as e:  # raised below, after the other ranks hear of it
            error = e
    dist.broadcast(written, 0)
    if error is not None:
        raise error
    if not written.item():
        raise RuntimeError(f"rank 0 failed to write the serving bundle {path}")


class ExportedServer:
    """A loaded serving bundle: callable with ``Predictor`` semantics. A mesh
    bundle's ``mesh`` is the :class:`~bnn_tpu_torch.parallel.Mesh` rebuilt
    over the current world; ``program`` then holds this rank's shards."""

    def __init__(self, program, meta: dict, device: torch.device, mesh=None):
        self.program = program
        self.meta = meta
        self.batch_size = int(meta["batch_size"])
        self.input_shape: Tuple[int, ...] = tuple(meta["input_shape"])
        self.platforms: Tuple[str, ...] = tuple(meta["platforms"])
        self.dtype = getattr(torch, meta["input_dtype"])
        self.device = device
        self.mesh = mesh
        x_spec = meta["mesh"]["x_spec"] if mesh is not None else []
        self.batch_axis = x_spec[0] if x_spec else None
        self._forward = program.module()

    def _one_batch(self, xb: torch.Tensor) -> torch.Tensor:
        return data_parallel_call(self._forward, xb, self.mesh, self.batch_axis)

    @torch.no_grad()
    def __call__(self, x) -> torch.Tensor:
        with span(SERVE_CALL):
            with span(SERVE_COPY_IN):
                x = torch.as_tensor(x).to(device=self.device, dtype=self.dtype)
            if tuple(x.shape[1:]) != self.input_shape:
                raise ValueError(f"input shape {tuple(x.shape[1:])} != exported "
                                 f"signature {self.input_shape}")
            with span(SERVE_FORWARD):
                return batched_call(self._one_batch, x, self.batch_size)

    def state_bytes(self) -> int:
        """Bytes of the program's weights, buffers and constants: on a mesh,
        this rank's shards."""
        tensors = list(self.program.state_dict.values())
        tensors += list(self.program.constants.values())
        return sum(t.numel() * t.element_size() for t in tensors
                   if isinstance(t, torch.Tensor))


def load_serving(path: str, device=None) -> ExportedServer:
    """Load a bundle written by :func:`export_serving` onto ``device``
    (default: the device type it was exported on). Registers the port's
    operators and loads the program; it builds no model. A device of
    another type than the bundle's is refused, and so is a ``cuda`` bundle
    on a host without a card."""
    meta_path = os.path.join(path, _META)
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"not a serving bundle (no {_META}): {path}")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("format_version") not in (_FORMAT_VERSION, _MESH_FORMAT_VERSION):
        raise ValueError(f"unsupported bundle format {meta.get('format_version')!r} "
                         f"(this loader reads {_FORMAT_VERSION} and "
                         f"{_MESH_FORMAT_VERSION})")
    if meta.get("mesh"):
        n, world = int(meta["nr_devices"]), _world_size()
        if n != world:
            raise ValueError(f"the bundle at {path} was exported for {n} devices "
                             f"and serves on a world of {n} ranks; this world has "
                             f"{world}")
    platforms = list(meta["platforms"])
    if device is None and meta.get("mesh") and platforms[0] == "cuda":
        from ..parallel.mesh import _default_device

        device = _default_device()  # cuda:{LOCAL_RANK}, as the mesh's
    device = torch.device(platforms[0] if device is None else device)
    if device.type not in platforms:
        raise ValueError(f"the bundle at {path} was exported for {platforms} and "
                         f"runs only there, not on {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"the bundle at {path} runs on CUDA and no CUDA "
                           "device is available")
    from ..kernels import ops  # noqa: F401  (the operators the program calls)
    from ..parallel import collectives  # noqa: F401  (mesh_gather)

    program = torch.export.load(os.path.join(path, _PROGRAM))
    if not meta.get("mesh"):
        return ExportedServer(program, meta, device)
    return _load_mesh(path, program, meta, device)


def _load_mesh(path: str, program, meta: dict, device: torch.device) -> ExportedServer:
    """A mesh bundle on this rank: the mesh rebuilt over the world (every
    rank calls this, in the same order as its other meshes), each sharded
    tensor cut to this rank's shard."""
    from ..parallel.mesh import Mesh, slice_tensor

    mm = meta["mesh"]
    mesh = Mesh(dict(zip(mm["axis_names"], mm["axis_sizes"])), device)
    exported_on = torch.device(meta["device"])
    if exported_on != device:
        # a program traced on cuda:0 names cuda:0 in the tensors its forward
        # makes; a rank on another card moves them to its own
        program = torch.export.passes.move_to_device_pass(program, device)
    specs = {k: _decode_spec(v) for k, v in mm["state_specs"].items()}
    if any(s.names() for s in specs.values()):
        whole = torch.load(os.path.join(path, _SHARDS), map_location="cpu",
                           weights_only=True, mmap=True)
        for k, spec in specs.items():
            if spec.names():
                shard = slice_tensor(whole[k], spec, mesh).to(device)
                if isinstance(program.state_dict[k], nn.Parameter):
                    shard = nn.Parameter(shard, requires_grad=False)
                program.state_dict[k] = shard
    return ExportedServer(program, meta, device, mesh)
