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

Multi-device bundles (``mesh``) are not ported yet (``ROADMAP.md`` queue 1,
item 6).
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["batched_call", "export_serving", "load_serving", "ExportedServer"]

_FORMAT_VERSION = 1
_PROGRAM = "program.pt2"
_META = "meta.json"


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


class _Forward(nn.Module):
    """``Predictor._forward`` as a module: the model's first output."""

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
    if platforms is not None and list(platforms) != [device.type]:
        raise ValueError(
            f"a bundle runs on the device type it is exported on: this "
            f"predictor serves on {device.type!r}, platforms={list(platforms)} "
            "asks for another; build the predictor there and export it there")
    if getattr(predictor, "mesh", None) is not None:
        raise NotImplementedError("multi-device bundles are not ported yet "
                                  "(ROADMAP.md queue 1, item 6)")
    model = predictor.model
    x = torch.zeros((predictor.batch_size, *input_shape), dtype=predictor.dtype,
                    device=device)
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
    os.makedirs(path, exist_ok=True)
    torch.export.save(program, os.path.join(path, _PROGRAM))
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
    with open(os.path.join(path, _META), "w") as f:
        json.dump(meta, f, indent=1)


class ExportedServer:
    """A loaded serving bundle: callable with ``Predictor`` semantics."""

    def __init__(self, program, meta: dict, device: torch.device):
        self.program = program
        self.meta = meta
        self.batch_size = int(meta["batch_size"])
        self.input_shape: Tuple[int, ...] = tuple(meta["input_shape"])
        self.platforms: Tuple[str, ...] = tuple(meta["platforms"])
        self.dtype = getattr(torch, meta["input_dtype"])
        self.device = device
        self.mesh = None
        self._forward = program.module()

    @torch.no_grad()
    def __call__(self, x) -> torch.Tensor:
        x = torch.as_tensor(x).to(device=self.device, dtype=self.dtype)
        if tuple(x.shape[1:]) != self.input_shape:
            raise ValueError(f"input shape {tuple(x.shape[1:])} != exported "
                             f"signature {self.input_shape}")
        return batched_call(self._forward, x, self.batch_size)

    def state_bytes(self) -> int:
        """Bytes of the program's weights, buffers and constants."""
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
    if meta.get("format_version") != _FORMAT_VERSION:
        raise ValueError(f"unsupported bundle format {meta.get('format_version')!r} "
                         f"(this loader reads {_FORMAT_VERSION})")
    if meta.get("mesh"):
        raise NotImplementedError("multi-device bundles are not ported yet "
                                  "(ROADMAP.md queue 1, item 6)")
    platforms = list(meta["platforms"])
    device = torch.device(platforms[0] if device is None else device)
    if device.type not in platforms:
        raise ValueError(f"the bundle at {path} was exported for {platforms} and "
                         f"runs only there, not on {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"the bundle at {path} runs on CUDA and no CUDA "
                           "device is available")
    from ..kernels import ops  # noqa: F401  (the operators the program calls)

    program = torch.export.load(os.path.join(path, _PROGRAM))
    return ExportedServer(program, meta, device)
