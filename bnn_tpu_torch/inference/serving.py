"""One-call serving wrapper (counterpart of ``bnn_tpu/inference/serving.py``).

    predictor = Predictor(model, batch_size=8)          # device="cuda"
    logits = predictor(images)                          # NCHW

Pipeline, in the JAX package's order: deploy (int8 / packed weights, folded
epilogues) -> BN folds -> space-to-depth stem -> fused stem -> float path
cast to ``dtype``; requests are padded and split into ``batch_size``
chunks.

What is ported so far: the serving path above batch size 4. The stage and
block megakernels that the JAX package runs at smaller batches
(``fused_chain``, ``fused_basic_block``, ``fused_downsample_block``),
multi-device serving, the popcount GEMM and the quantized float head are
not, and asking for them raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..utils.precision import cast_floats
from .deploy import deploy
from .export import batched_call
from .optimize import optimize_deployed
from .stem import fuse_stem, space_to_depth_stem

__all__ = ["Predictor"]

# the JAX package's stage megakernels run at batches up to 4 whatever
# max_fused_batch says (Predictor builds them with fuse_stages' default)
_STAGE_FUSED_BATCH = 4


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
            raise NotImplementedError(
                f"binary_gemm_impl={binary_gemm_impl!r} needs popcount_gemm "
                "(bnn_tpu/kernels/gemm.py), which is not ported yet")
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
        if fuse and batch_size <= max(max_fused_batch, _STAGE_FUSED_BATCH):
            raise NotImplementedError(
                f"fuse=True at batch_size={batch_size} needs the stage and "
                "block megakernels (bnn_tpu/kernels/model.py fused_chain, "
                "block.py fused_basic_block, strided_block.py "
                "fused_downsample_block), which are not ported yet; use a "
                "larger batch_size or fuse=False")
        model.eval()
        model = deploy(model.to(device), weight_format=weight_format)
        if fold_bn:
            optimize_deployed(model)
        if space_to_depth:
            space_to_depth_stem(model)
        if fuse:
            fuse_stem(model)
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
