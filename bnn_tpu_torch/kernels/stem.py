"""Fused ResNet stem (counterpart of ``bnn_tpu/kernels/stem.py``):
``maxpool3x3/s2/p1(relu(conv7x7/s2/p3(x, w) + bias))`` in one kernel.

:func:`fused_stem` launches the hand-written Hopper kernel
``bnn_tpu_torch/csrc/fused_stem.cu`` for CUDA tensors and takes
:func:`fused_stem_reference`, its plain version, only for CPU tensors. The
JAX package has three TPU kernels for this one function (``fused_stem``,
``fused_stem_v2``, ``fused_stem_v3``), each tuned to a geometry; the CUDA
kernel accepts every geometry the widest of them (v1: H % 8, W % 4) does,
so it serves all three.

Bound on an H100 at (8, 224, 224, 3) bf16: 5.6 MB moved (1.7 us) against
1.9 GFLOP (1.9 us at the bf16 tensor-core rate), so the bound is the
arithmetic; the kernel runs it on the f32 CUDA cores (28 us at their peak)
and keeps the 112x112x64 conv map on chip, so device traffic stays at one
read of the input and one write of the pooled output.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ._build import load

__all__ = ["fused_stem", "fused_stem_reference"]

_X_DTYPES = (torch.float32, torch.bfloat16)


def _check_geometry(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"expected NHWC x and HWIO w, got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    _, h, ws, c = x.shape
    if not (c <= 4 and h % 8 == 0 and ws % 4 == 0):
        raise ValueError(f"fused_stem needs C <= 4, H % 8 == 0 and "
                         f"W % 4 == 0; got x {tuple(x.shape)}")
    if tuple(w.shape[:3]) != (7, 7, c):
        raise ValueError(f"fused_stem needs a (7, 7, {c}, O) kernel, got "
                         f"{tuple(w.shape)}")


def _f32_operands(w: torch.Tensor, bias: Optional[torch.Tensor], device):
    """The stem's weights and bias as the kernels take them: contiguous f32,
    a zero bias where there is none."""
    o = w.shape[-1]
    wf = w.to(torch.float32).contiguous()
    bf = (torch.zeros(o, dtype=torch.float32, device=device) if bias is None
          else bias.to(device=device, dtype=torch.float32).reshape(-1).contiguous())
    if bf.shape != (o,):
        raise ValueError(f"bias must have shape ({o},), got {tuple(bf.shape)}")
    return wf, bf


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of ``csrc/fused_stem.cu``, built at first use."""
    fn = load("fused_stem").bnn_fused_stem
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    return fn


def fused_stem(x: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``maxpool3x3/s2/p1(relu(conv7x7/s2/p3(x, w) + bias))``.

    Args:
        x: ``(N, H, W, C)`` NHWC input, f32 or bf16, C <= 4, H % 8 == 0,
            W % 4 == 0.
        w: ``(7, 7, C, O)`` HWIO kernel (BN already folded).
        bias: ``(O,)`` folded bias, or None.
    Returns:
        ``(N, H/4, W/4, O)`` in x's dtype.
    """
    _check_geometry(x, w)
    if x.device.type == "cpu":
        return fused_stem_reference(x, w, bias)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"fused_stem needs x and w on one CUDA device, got "
                         f"{x.device} and {w.device}")
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"fused_stem takes f32/bf16 x, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_stem needs a contiguous NHWC x")
    n, h, ws, c = x.shape
    o = w.shape[-1]
    wf, bf = _f32_operands(w, bias, x.device)
    out = torch.empty((n, h // 4, ws // 4, o), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    err = _kernel()(
        x.data_ptr(), int(x.dtype == torch.bfloat16), wf.data_ptr(),
        bf.data_ptr(), out.data_ptr(), n, h, ws, c, o,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_stem kernel launch failed: CUDA error {err}")
    fused_stem.launches += 1
    return out


fused_stem.launches = 0


def fused_stem_reference(x: torch.Tensor, w: torch.Tensor,
                         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_stem`, computed in f32 and cast
    to x's dtype at the end."""
    y = F.conv2d(x.permute(0, 3, 1, 2).to(torch.float32),
                 w.permute(3, 2, 0, 1).to(torch.float32), stride=2, padding=3)
    if bias is not None:
        y = y + bias.to(torch.float32).reshape(1, -1, 1, 1)
    y = F.max_pool2d(torch.relu(y), 3, 2, 1)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()
