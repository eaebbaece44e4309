"""Float layers under ``bnn_tpu.nn``'s names (counterpart of
``bnn_tpu/nn/__init__.py``).

Where ``torch.nn``'s layer computes what the JAX package's does, the name is
torch's class itself (``Conv1d``, ``Conv2d``, ``Linear``, ``AvgPool2d``,
``AdaptiveAvgPool2d``, ``Identity``, ``ReLU``, ``PReLU``, ``Hardtanh``,
``Tanh``, ``Sequential``, ``ModuleList``): the binarization pass maps
``nn.Conv2d`` and ``nn.Linear`` by exact type and the serving passes test
``type(m) is nn.Identity`` / ``nn.AvgPool2d``, so a subclass would drop out
of both. The dense and conv layers take torch's weight layouts, and torch's
``Conv1d`` / ``Conv2d`` refuse ``padding='same'`` at a stride over 1, which
the binary layers and :func:`bnn_tpu_torch.functional.conv` take.

The norms and the max pool subclass the torch layer, so every
``isinstance`` test of the serving passes holds, and differ only where the
JAX package computes differently; ``Flatten`` takes JAX's ``start_axis``.
``MultiheadAttention`` is the JAX package's own (four ``nn.Linear``
projections, which ``prepare_binary_model`` binarizes), not torch's.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .. import functional as F

__all__ = ["Identity", "Linear", "Conv1d", "Conv2d", "BatchNorm1d",
           "BatchNorm2d", "ReLU", "PReLU", "Tanh", "Hardtanh", "MaxPool1d",
           "MaxPool2d", "AvgPool2d", "AdaptiveAvgPool2d", "Flatten",
           "Sequential", "ModuleList", "LayerNorm", "MultiheadAttention"]

Identity = nn.Identity
Linear = nn.Linear
Conv1d = nn.Conv1d
Conv2d = nn.Conv2d
ReLU = nn.ReLU
PReLU = nn.PReLU
Tanh = nn.Tanh
Hardtanh = nn.Hardtanh
AvgPool2d = nn.AvgPool2d
AdaptiveAvgPool2d = nn.AdaptiveAvgPool2d
Sequential = nn.Sequential
ModuleList = nn.ModuleList


class BatchNorm2d(nn.BatchNorm2d):
    """Channels-first batch norm for any rank, with flax's training rules.

    In train mode it normalises with the two-pass batch variance
    ``mean((x - mean)^2)`` computed in at least f32, in flax's order
    (``(x - mean) * (rsqrt(var + eps) * weight) + bias``), and updates the
    running statistics with the *biased* batch variance: torch's own layer
    takes the unbiased one, a factor n / (n - 1) apart. The output keeps the
    input's dtype. In eval mode it is torch's forward; f32 running statistics
    beside a narrower weight and bias (``cast_floats(keep_batch_stats=True)``)
    run with the weight and bias widened to the statistics' dtype.

    ``use_fast_variance``: the train-mode variance in flax's one-pass form
    ``max(0, mean(x^2) - mean(x)^2)``, as the JAX layer's option of that
    name (off by default there too).

    ``sync_axis``: ``(axis, mesh)`` once ``parallel.shard_model`` places the
    model on a mesh whose ``data`` axis is over 1: in train mode the mean and
    the variance are then those of the whole batch over the axis, and the
    running statistics take them on every rank."""

    sync_axis = None

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: Optional[float] = 0.1, affine: bool = True,
                 use_fast_variance: bool = False, **kwargs):
        super().__init__(num_features, eps=eps, momentum=momentum,
                         affine=affine, **kwargs)
        self.use_fast_variance = use_fast_variance

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() < 2:
            raise ValueError(f"expected an input of rank >= 2, got {x.dim()}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        if not self.training and self.running_mean is not None:
            w, b = self.weight, self.bias
            if w is not None and w.dtype != self.running_mean.dtype:
                w, b = w.to(self.running_mean.dtype), b.to(self.running_mean.dtype)
            return nn.functional.batch_norm(x, self.running_mean, self.running_var,
                                            w, b, False, 0.0, self.eps)
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        sync = self.sync_axis if self.training else None
        if sync is None:
            def batch_mean(v):
                return v.mean(dims, keepdim=True)
        else:
            # the statistics of the whole batch over the data axis: each
            # pass's sums all-reduced (differentiably), in the same order
            from ..parallel.collectives import all_reduce_sum

            axis, mesh = sync
            group = mesh.group(axis)
            count = (xf.numel() // xf.shape[1]) * mesh.size(axis)

            def batch_mean(v):
                return all_reduce_sum(v.sum(dims, keepdim=True), group) / count
        mean = batch_mean(xf)
        d = xf - mean
        if self.use_fast_variance:
            var = torch.clamp_min(batch_mean(xf.square()) - mean.square(), 0.0)
        else:
            var = batch_mean(d.square())
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight.view(shape)
        y = d * mul
        if self.bias is not None:
            y = y + self.bias.view(shape)
        if self.training and self.track_running_stats:
            self._update_stats(mean.view(-1), var.view(-1))
        return y.to(x.dtype)

    @torch.no_grad()
    def _update_stats(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.num_batches_tracked.add_(1)
        factor = (self.momentum if self.momentum is not None
                  else 1.0 / float(self.num_batches_tracked))
        keep = 1.0 - factor  # flax's momentum
        for buf, stat in ((self.running_mean, mean), (self.running_var, var)):
            buf.copy_(keep * buf + (1.0 - keep) * stat)


# as in the JAX package, one layer covers every rank
BatchNorm1d = BatchNorm2d


class MaxPool2d(nn.MaxPool2d):
    """``nn.MaxPool2d`` through :func:`bnn_tpu_torch.functional.max_pool`, so
    that its backward follows ``set_pool_grad_mode``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.return_indices:
            return super().forward(x)
        return F.max_pool(x, self.kernel_size, self.stride, self.padding,
                          self.ceil_mode, self.dilation)


# as in the JAX package, one layer covers both ranks (F.max_pool takes either)
MaxPool1d = MaxPool2d


class Flatten(nn.Flatten):
    """``nn.Flatten`` from ``start_axis`` (JAX's name for ``start_dim``) to
    the last axis."""

    def __init__(self, start_axis: int = 1):
        super().__init__(start_dim=start_axis)


class LayerNorm(nn.LayerNorm):
    """Layer norm over the last axis with flax's arithmetic: the statistics
    in at least f32, the variance in flax's default fast form
    ``max(0, mean(x^2) - mean(x)^2)``, then ``(x - mean) * (rsqrt(var + eps)
    * weight) + bias``; the output takes the promoted dtype of the input and
    the parameters."""

    def __init__(self, normalized_shape: int, eps: float = 1e-5,
                 elementwise_affine: bool = True, **kwargs):
        super().__init__(normalized_shape, eps=eps,
                         elementwise_affine=elementwise_affine, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = tuple(range(-len(self.normalized_shape), 0))
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dims, keepdim=True)
        var = torch.clamp_min(xf.square().mean(dims, keepdim=True)
                              - mean.square(), 0.0)
        mul = torch.rsqrt(var + self.eps)
        out_dtype = x.dtype
        if self.weight is not None:
            mul = mul * self.weight
            out_dtype = torch.promote_types(out_dtype, self.weight.dtype)
        y = (xf - mean) * mul
        if self.bias is not None:
            y = y + self.bias
            out_dtype = torch.promote_types(out_dtype, self.bias.dtype)
        return y.to(out_dtype)


class MultiheadAttention(nn.Module):
    """Multi-head attention built from four ``nn.Linear`` projections, so
    that ``prepare_binary_model`` binarizes them like any other dense layer.

    Inputs are ``(N, L, E)``; ``key`` defaults to ``query`` and ``value`` to
    ``key``; ``mask`` is additive, broadcastable to ``(N, heads, L, S)``.
    The logits are scaled after the product ``q k^T``, as in the JAX
    package."""

    def __init__(self, embed_dim: int, num_heads: int, bias: bool = True):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim, bias=bias)
        self.k_proj = nn.Linear(embed_dim, embed_dim, bias=bias)
        self.v_proj = nn.Linear(embed_dim, embed_dim, bias=bias)
        self.out_proj = nn.Linear(embed_dim, embed_dim, bias=bias)

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        n, length, _ = t.shape
        return t.reshape(n, length, self.num_heads, self.head_dim).transpose(1, 2)

    def forward(self, query: torch.Tensor, key: Optional[torch.Tensor] = None,
                value: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        key = query if key is None else key
        value = key if value is None else value
        q = self._heads(self.q_proj(query))
        k = self._heads(self.k_proj(key))
        v = self._heads(self.v_proj(value))
        logits = (q @ k.transpose(-1, -2)) / math.sqrt(self.head_dim)
        if mask is not None:
            logits = logits + mask
        out = torch.softmax(logits, dim=-1) @ v
        n, length = query.shape[:2]
        return self.out_proj(out.transpose(1, 2).reshape(n, length, self.embed_dim))
