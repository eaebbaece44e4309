"""One-call serving wrapper (counterpart of ``bnn_tpu/inference/serving.py``).

    predictor = Predictor(model, batch_size=1)          # device="cuda"
    predictor = Predictor.from_checkpoint(path, model_fn, batch_size=8)
    logits = predictor(images)                          # NCHW

Pipeline, in the JAX package's order: deploy (int8 / packed weights, folded
epilogues) -> BN folds -> with ``quantize_float_bits``, the big float layers
(the classifier head) stored as int8 or int4
(:func:`~bnn_tpu_torch.inference.compress.quantize_float_layers`) ->
space-to-depth stem -> with ``fuse``: fused stem, whole-stage kernels
(:func:`~bnn_tpu_torch.inference.stages.fuse_stages`), per-block kernels
under ``max_fused_batch``
(:func:`~bnn_tpu_torch.inference.megablock.fuse_blocks`), the float
classifier head folded into the last stage (a quantized head stays apart,
after the stage's features) -> float state cast to ``dtype``. Requests are
padded and split into ``batch_size`` chunks. Every fused module decides per
forward whether its kernel runs: at batch 1 to 4 a binary ResNet-18 is five
launches (stem, four stages), a binary ResNet-50 the stem and one
``fused_bottleneck`` per stride-1 Bottleneck (13), its three strided blocks
on the deployed convs; at batch 8 the stages and blocks fall back to the
deployed convs, as in the JAX package.

``use_pallas=False`` serves the plain versions on the same device: every
deployed layer calls ``binary_gemm_reference`` / ``popcount_gemm_reference``
in place of the two GEMM kernels, and ``fuse`` (unless given) is off, so no
hand-written kernel runs; the baseline to hold the kernels against in one
process. ``use_pallas=None`` is True on every device, today's behaviour: the
kernels on CUDA tensors, the operators' plain versions on CPU tensors (the
JAX ``Predictor`` resolves it by platform, its Mosaic kernels being
TPU-only). An explicit ``fuse=True`` with ``use_pallas=False`` builds the
fused modules, which run their kernels, as in JAX.

``binary_gemm_impl='popcount'`` serves unfused and switches every
``zero_to_one`` dense layer and pointwise conv to the popcount GEMM after the
BN folds (``popcount_layers`` names them), as the JAX ``Predictor`` does.

:meth:`Predictor.export` writes the frozen serving bundle
(``inference/export.py``), which ``load_serving`` serves without building a
model; a mesh predictor's bundle serves on a world of the same size.

Multi-device serving (one process per device, every rank builds the same
``Predictor`` and calls it with the same requests):

- ``mesh=`` (``parallel.make_mesh``): each forward's ``batch_size`` rows
  split over the mesh's ``data`` axis, weights replicated; each rank serves
  its rows (so the fused kernels decide on its share: at ``batch_size=8``
  over two ranks each runs the batch-4 path) and the logits are
  all-gathered, so ``__call__`` returns the whole batch on every rank, as
  ``np.asarray`` of JAX's output does. A mesh with a model axis only serves
  replicated batches.
- ``tensor_parallel=True`` (a model axis over 1): every eligible deployed
  layer holds its out-channel shard of the packed weights and gathers its
  output over the axis (:mod:`~bnn_tpu_torch.inference.tp`); served unfused,
  since the block kernels reduce over whole channels.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..utils.checkpoint import load_checkpoint, restore_into
from ..utils.precision import cast_floats
from ..utils.profiling import SERVE_CALL, SERVE_COPY_IN, SERVE_FORWARD, span
from .compress import quantize_float_layers, state_bytes
from .deploy import DeployedConv, DeployedLinear, deploy, set_gemm_impl
from .export import batched_call, data_parallel_call, export_serving
from .megablock import fuse_blocks
from .optimize import optimize_deployed
from .stages import fuse_head, fuse_stages
from .stem import fuse_stem, space_to_depth_stem
from .tp import shard_tp_state, tag_tensor_parallel, tp_state_specs

__all__ = ["Predictor"]


class Predictor:
    """Inference endpoint for a (binarized) model, on ``device``."""

    def __init__(self, model: nn.Module, *, batch_size: int = 32,
                 weight_format: str = "int8", dtype=torch.bfloat16,
                 use_pallas: Optional[bool] = None, fold_bn: bool = True,
                 space_to_depth: bool = True, fuse: Optional[bool] = None,
                 max_fused_batch: int = 4,
                 mesh=None, tensor_parallel: bool = False,
                 binary_gemm_impl: str = "mxu",
                 quantize_float_bits: Optional[int] = None,
                 device=None, batch_axis: str = "data",
                 model_axis: str = "model"):
        if tensor_parallel:
            if fuse is True:
                raise ValueError(
                    "tensor_parallel=True is incompatible with fuse=True: "
                    "block megakernels reduce over full channels and "
                    "cannot consume a channel shard")
            if mesh is None or mesh.size(model_axis) <= 1:
                raise ValueError(
                    "tensor_parallel needs a mesh with a >1 model axis")
            fuse = False
        if binary_gemm_impl != "mxu" and fuse is True:
            raise ValueError(
                "binary_gemm_impl='%s' is incompatible with fuse=True: the "
                "stage/block megakernels always run the int8 product, so "
                "fusion would override the requested GEMM implementation"
                % binary_gemm_impl)
        if mesh is not None and batch_size % mesh.size(batch_axis):
            raise ValueError(
                f"batch_size {batch_size} must divide evenly over the "
                f"{mesh.size(batch_axis)}-way '{batch_axis}' mesh axis")
        if binary_gemm_impl != "mxu":
            # the block and stage kernels run the int8 product: serve
            # unfused so that every eligible layer takes the requested form
            fuse = False
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's {mesh.device}")
            device = mesh.device
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Predictor runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' for the plain PyTorch versions")
        use_pallas = True if use_pallas is None else use_pallas
        if fuse is None:  # the fused modules run kernels, like use_pallas
            fuse = use_pallas
        model.eval()
        model = deploy(model.to(device), weight_format=weight_format,
                       use_pallas=use_pallas)
        if fold_bn:
            optimize_deployed(model)
        self.popcount_layers = []
        if binary_gemm_impl != "mxu":
            self.popcount_layers = set_gemm_impl(model, binary_gemm_impl)
        if quantize_float_bits is not None:
            # weight-only storage for the big float layers (the head); the
            # sign-feeding stem stays float (see inference/compress.py)
            model = quantize_float_layers(model, bits=quantize_float_bits)
        if space_to_depth:
            space_to_depth_stem(model)
        if fuse:
            fuse_stem(model)
            # stages with the stage cap's default (batch <= 4), as the JAX
            # Predictor builds them; blocks under max_fused_batch, also
            # inside a stage's fallback
            fuse_stages(model)
            fuse_blocks(model, max_fused_batch=max_fused_batch, strided=True)
            fuse_head(model)
        if dtype is not None:
            cast_floats(model, dtype)
        self.model = model
        self.batch_size = batch_size
        self.dtype = dtype or torch.float32
        self.device = device
        self.mesh = mesh
        self.batch_axis, self.model_axis = batch_axis, model_axis
        self.tensor_parallel = tensor_parallel
        if tensor_parallel:
            # each rank keeps an out-channel shard of every eligible layer's
            # packed weights and epilogue; the forward gathers per layer
            self.tp_layers = tag_tensor_parallel(model, mesh, axis=model_axis)
            self.tp_total = sum(1 for m in model.modules()
                                if isinstance(m, (DeployedConv, DeployedLinear)))
            self.tp_specs = tp_state_specs(model, axis=model_axis)
            shard_tp_state(model, self.tp_specs, mesh)

    def export(self, path: str, input_shape, *, platforms=None) -> None:
        """Freeze this predictor into a serving bundle at ``path``
        (:func:`~bnn_tpu_torch.inference.export.export_serving`;
        ``input_shape`` per example, NCHW, e.g. ``(3, 224, 224)``); serve it
        with :func:`~bnn_tpu_torch.inference.export.load_serving`. The
        predictor serves as before. On a mesh every rank calls it (a
        collective); rank 0 writes the bundle."""
        export_serving(self, path, input_shape, platforms=platforms)

    def served_model(self) -> nn.Module:
        """The deployed model being served."""
        return self.model

    def state_bytes(self) -> int:
        """Logical bytes of every tensor in the served model's state
        (weights, scales, norm statistics, the fused modules' kernel-layout
        copies). With ``tensor_parallel=True`` the tagged layers' shards
        count whole, as in JAX: a rank holds less (``local_state_bytes``)."""
        total = state_bytes(self.model)
        if self.tensor_parallel:
            n = self.mesh.size(self.model_axis)
            sd = self.model.state_dict()
            total += sum((n - 1) * sd[k].numel() * sd[k].element_size()
                         for k, spec in self.tp_specs.items() if spec.names())
        return total

    def local_state_bytes(self) -> int:
        """Bytes of the state this rank holds."""
        return state_bytes(self.model)

    @classmethod
    def from_model(cls, model: nn.Module, **kwargs) -> "Predictor":
        return cls(model, **kwargs)

    @classmethod
    def from_checkpoint(cls, path: str, model_fn: Callable[[], nn.Module],
                        **kwargs) -> "Predictor":
        """Build the QAT model with ``model_fn``, restore the checkpoint at
        ``path`` (:func:`~bnn_tpu_torch.utils.checkpoint.save_checkpoint`'s
        directory) into it, then deploy."""
        model = model_fn()
        restore_into(model, load_checkpoint(path))
        return cls(model, **kwargs)

    def _model_forward(self, xb: torch.Tensor) -> torch.Tensor:
        out = self.model(xb)
        return out[0] if isinstance(out, tuple) else out

    def _forward(self, xb: torch.Tensor) -> torch.Tensor:
        # on a mesh: this rank's rows of the batch, then every rank's logits
        return data_parallel_call(self._model_forward, xb, self.mesh, self.batch_axis)

    @torch.no_grad()
    def __call__(self, x) -> torch.Tensor:
        """Predict on ``(N, C, H, W)`` input; N is padded up to a multiple of
        ``batch_size`` so every forward sees the same batch."""
        with span(SERVE_CALL):
            with span(SERVE_COPY_IN):
                x = torch.as_tensor(x).to(device=self.device, dtype=self.dtype)
            with span(SERVE_FORWARD):
                return batched_call(self._forward, x, self.batch_size)
