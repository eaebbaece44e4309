"""Fused binary convolution, stride 1 (counterpart of
``bnn_tpu/kernels/conv.py``).

:func:`binary_conv2d_s1` computes ``conv(x >= 0 ? +1 : -1, w) * scale + add``
over an odd square kernel with "same" zero padding, in NHWC: the
hand-written Hopper kernel ``bnn_tpu_torch/csrc/binary_conv2d_s1.cu`` for
CUDA tensors, its plain version :func:`binary_conv2d_s1_reference` only for
CPU tensors. The sign is taken inside with sign(0) = +1, whatever the
layer's ``zero_to_one`` (as the TPU kernel does); the padding is added after
the sign, so padded taps contribute exactly 0. The output is always f32.

Bound on an H100 at (8, 56, 56, 64) with 64 output channels: 3.2 MB of bf16
x in and 6.4 MB of f32 out, 2.9 us at 3.35 TB/s, against 1.85 G int8
operations (0.9 us), so bytes bound it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ._build import load
from .gemm import _epilogue_operand

__all__ = ["supports", "binary_conv2d_s1", "binary_conv2d_s1_reference"]

_X_DTYPES = (torch.float32, torch.bfloat16)


def supports(kernel_size, stride, padding, dilation, groups) -> bool:
    """Whether the kernel computes a conv of this geometry: stride 1, an odd
    square kernel, dilation 1, groups 1 and the symmetric "same" padding."""
    if len(tuple(kernel_size)) != 2 or isinstance(padding, str):
        return False
    kh, kw = kernel_size
    return (kh == kw and kh % 2 == 1
            and tuple(stride) == (1, 1)
            and tuple(dilation) == (1, 1)
            and groups == 1
            and tuple(padding) == (kh // 2, kh // 2))


def _check(x: torch.Tensor, w: torch.Tensor, scale, add) -> None:
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"expected NHWC x and (k, k, C, O) w, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    kh, kw, c, o = w.shape
    if kh != kw or kh % 2 == 0 or c != x.shape[-1]:
        raise ValueError(f"binary_conv2d_s1 needs an odd square (k, k, "
                         f"{x.shape[-1]}, O) kernel, got {tuple(w.shape)}")
    for v in (scale, add):
        if v is not None and tuple(v.shape) != (o,):
            raise ValueError(f"epilogue operands must have shape ({o},), got "
                             f"{tuple(v.shape)}")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of ``csrc/binary_conv2d_s1.cu``, built at first use."""
    fn = load("binary_conv2d_s1").bnn_binary_conv2d_s1
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    return fn


def binary_conv2d_s1(x: torch.Tensor, w_int8: torch.Tensor,
                     scale: Optional[torch.Tensor] = None,
                     add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``conv(sign(x), w_int8) * scale + add`` for a stride-1 odd kernel.

    Args:
        x: ``(N, H, W, C)`` raw activations, f32 or bf16 (signed inside,
            ``sign(0) == +1``).
        w_int8: ``(k, k, C, O)`` int8 +/-1 weights.
        scale, add: ``(O,)`` per-out-channel epilogue (default 1 and 0).
    Returns:
        ``(N, H, W, O)`` f32.
    """
    _check(x, w_int8, scale, add)
    if x.device.type == "cpu":
        return binary_conv2d_s1_reference(x, w_int8, scale, add)
    if x.device.type != "cuda" or w_int8.device != x.device:
        raise ValueError(f"binary_conv2d_s1 needs x and w on one CUDA device, "
                         f"got {x.device} and {w_int8.device}")
    if x.dtype not in _X_DTYPES or w_int8.dtype != torch.int8:
        raise TypeError(f"binary_conv2d_s1 takes f32/bf16 x and int8 w, got "
                        f"{x.dtype} and {w_int8.dtype}")
    if not x.is_contiguous():
        raise ValueError("binary_conv2d_s1 needs a contiguous NHWC x")
    n, h, wd, c = x.shape
    k, o = w_int8.shape[0], w_int8.shape[-1]
    kk = k * k * c
    k4, o4 = -(-kk // 4) * 4, -(-o // 4) * 4
    w2 = w_int8.reshape(kk, o)
    if (k4, o4) != (kk, o):  # zero rows and columns add nothing
        w2 = F.pad(w2, (0, o4 - o, 0, k4 - kk))
    w2 = w2.contiguous()
    scale = _epilogue_operand(scale, o, 1.0, x.device)
    add = _epilogue_operand(add, o, 0.0, x.device)
    out = torch.empty((n, h, wd, o), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    err = _kernel()(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w2.data_ptr(),
        scale.data_ptr(), add.data_ptr(), out.data_ptr(), n, h, wd, c, k, k4,
        o4, o, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"binary_conv2d_s1 kernel launch failed: CUDA error {err}")
    binary_conv2d_s1.launches += 1
    return out


binary_conv2d_s1.launches = 0


def binary_conv2d_s1_reference(x: torch.Tensor, w_int8: torch.Tensor,
                               scale: Optional[torch.Tensor] = None,
                               add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`binary_conv2d_s1`: the integer conv in
    float64 (exact for these sums, rounded in case a device algorithm is
    not), then the f32 epilogue, multiply and add rounded apart."""
    _check(x, w_int8, scale, add)
    k, o = w_int8.shape[0], w_int8.shape[-1]
    xs = torch.where(x >= 0, 1.0, -1.0).to(torch.float64).permute(0, 3, 1, 2)
    acc = F.conv2d(xs, w_int8.to(torch.float64).permute(3, 2, 0, 1),
                   padding=k // 2)
    acc = acc.round().to(torch.float32).permute(0, 2, 3, 1)
    scale = _epilogue_operand(scale, o, 1.0, x.device)
    add = _epilogue_operand(add, o, 0.0, x.device)
    return (acc * scale + add).contiguous()
