"""One-call serving wrapper (counterpart of ``bnn_tpu/inference/serving.py``).

    predictor = Predictor(model, batch_size=1)          # device="cuda"
    logits = predictor(images)                          # NCHW

Pipeline, in the JAX package's order: deploy (int8 / packed weights, folded
epilogues) -> BN folds -> space-to-depth stem -> with ``fuse``: fused stem,
whole-stage kernels (:func:`~bnn_tpu_torch.inference.stages.fuse_stages`),
per-block kernels under ``max_fused_batch``
(:func:`~bnn_tpu_torch.inference.megablock.fuse_blocks`), the classifier
head folded into the last stage -> float state cast to ``dtype``. Requests
are padded and split into ``batch_size`` chunks. Every fused module decides
per forward whether its kernel runs: at batch 1 to 4 a binary ResNet-18 is
five launches (stem, four stages), a binary ResNet-50 the stem and one
``fused_bottleneck`` per stride-1 Bottleneck (13), its three strided blocks
on the deployed convs; at batch 8 the stages and blocks fall back to the
deployed convs, as in the JAX package.

``binary_gemm_impl='popcount'`` serves unfused and switches every
``zero_to_one`` dense layer and pointwise conv to the popcount GEMM after the
BN folds (``popcount_layers`` names them), as the JAX ``Predictor`` does.

Not ported yet, and raising ``NotImplementedError``: multi-device serving
and the quantized float head.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..utils.precision import cast_floats
from .deploy import deploy, set_gemm_impl
from .export import batched_call
from .megablock import fuse_blocks
from .optimize import optimize_deployed
from .stages import fuse_head, fuse_stages
from .stem import fuse_stem, space_to_depth_stem

__all__ = ["Predictor"]


class Predictor:
    """Inference endpoint for a (binarized) model, on ``device``."""

    def __init__(self, model: nn.Module, *, batch_size: int = 32,
                 weight_format: str = "int8", dtype=torch.bfloat16,
                 fold_bn: bool = True, space_to_depth: bool = True,
                 fuse: Optional[bool] = None, max_fused_batch: int = 4,
                 mesh=None, tensor_parallel: bool = False,
                 binary_gemm_impl: str = "mxu",
                 quantize_float_bits: Optional[int] = None,
                 device="cuda"):
        if tensor_parallel:
            if mesh is None:
                raise ValueError(
                    "tensor_parallel needs a mesh with a >1 model axis")
            if fuse is True:
                raise ValueError(
                    "tensor_parallel=True is incompatible with fuse=True: "
                    "block megakernels reduce over full channels and "
                    "cannot consume a channel shard")
        if binary_gemm_impl != "mxu" and fuse is True:
            raise ValueError(
                "binary_gemm_impl='%s' is incompatible with fuse=True: the "
                "stage/block megakernels always run the int8 product, so "
                "fusion would override the requested GEMM implementation"
                % binary_gemm_impl)
        if mesh is not None or tensor_parallel:
            raise NotImplementedError(
                "multi-device serving (mesh=, tensor_parallel=) is not "
                "ported yet")
        if binary_gemm_impl != "mxu":
            # the block and stage kernels run the int8 product: serve
            # unfused so that every eligible layer takes the requested form
            fuse = False
        if quantize_float_bits is not None:
            raise NotImplementedError(
                "quantize_float_bits (bnn_tpu/inference/compress.py) is not "
                "ported yet")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Predictor runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' for the plain PyTorch versions")
        if fuse is None:
            fuse = True
        model.eval()
        model = deploy(model.to(device), weight_format=weight_format)
        if fold_bn:
            optimize_deployed(model)
        self.popcount_layers = []
        if binary_gemm_impl != "mxu":
            self.popcount_layers = set_gemm_impl(model, binary_gemm_impl)
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

    def _forward(self, xb: torch.Tensor) -> torch.Tensor:
        out = self.model(xb)
        return out[0] if isinstance(out, tuple) else out

    @torch.no_grad()
    def __call__(self, x) -> torch.Tensor:
        """Predict on ``(N, C, H, W)`` input; N is padded up to a multiple of
        ``batch_size`` so every forward sees the same batch."""
        x = torch.as_tensor(x).to(device=self.device, dtype=self.dtype)
        return batched_call(self._forward, x, self.batch_size)
