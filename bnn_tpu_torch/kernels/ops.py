"""The port's ten kernels as operators of the ``bnn_tpu_torch`` namespace,
so that ``torch.export`` traces a served model with each kernel as one node
(``inference/export.py``) and a loaded program launches the same kernels.

Each operator has three implementations:

- **CUDA**: the hand-written kernel through its ``ctypes`` launcher, on the
  current stream (``*_cuda`` / ``*_planned`` in the kernel modules). It never
  gives way to the plain version: a build or launch error propagates. The
  descriptors and K-major copies a launch reads are kept per weights inside
  it (``_blocks.KEPT``), never on the modules that call it, so a trace
  writes into no Python cache;
- **CPU**: the plain PyTorch version (``*_reference``);
- **fake**: the output's shape and dtype from the inputs' (tracing).

Any other device raises (the dispatcher has no kernel for it). Schemas take
tensors, lists of tensors, ints, bools, strings and dtypes only: a chain's
``BlockParams`` travel as their arrays and kinds (``model.flatten``), the
optional epilogue rows as ``Tensor?``, activation kinds as strings.

The operators are registered with ``torch.library.Library`` (``DEF``, then
``impl`` per dispatch key and ``register_fake``): its dispatch costs less
host time per call than ``@torch.library.custom_op``'s wrapper, and the
flagship at batch 1 makes five calls a forward. Importing this module builds
nothing and imports no ``triton``; the kernel wrappers (``binary_gemm``, ...)
call these operators, and ``kernels/__init__.py`` imports it.
"""
from __future__ import annotations

import torch

from .block import fused_basic_block_cuda, fused_basic_block_reference
from .bottleneck import (ROWS as BOTTLENECK_ROWS, fused_bottleneck_cuda,
                         fused_bottleneck_reference)
from .conv import (binary_conv2d_cpu, binary_conv2d_fake, binary_conv2d_planned,
                   binary_conv2d_s1_planned, binary_conv2d_s1_reference)
from .gemm import (binary_gemm_planned, binary_gemm_reference,
                   popcount_gemm_planned, popcount_gemm_reference)
from .model import (KINDS, fused_chain_cuda, fused_chain_reference,
                    fused_stem_chain_cuda, fused_stem_chain_reference,
                    unflatten)
from .stem import fused_stem_cuda, fused_stem_reference
from .strided_block import (fused_downsample_block_cuda,
                            fused_downsample_block_reference)

__all__ = ["NAMESPACE", "OPS", "SCHEMAS"]

NAMESPACE = "bnn_tpu_torch"
_BASIC_ROWS = "Tensor? scale1, Tensor? add1, Tensor? scale2, Tensor? add2, " \
    "Tensor? prelu1, Tensor? prelu2"
_TAIL = "str act1, str act2, bool pre, bool zero_to_one, ScalarType? out_dtype"
SCHEMAS = {
    "binary_gemm": "binary_gemm(Tensor x, Tensor w_packed, int k, Tensor? scale, "
                   "Tensor? add, bool sign_inputs) -> Tensor",
    "popcount_gemm": "popcount_gemm(Tensor x_packed, Tensor w_packed, int k, "
                     "Tensor? scale, Tensor? add) -> Tensor",
    "binary_conv2d_s1": "binary_conv2d_s1(Tensor x, Tensor w, Tensor? scale, "
                        "Tensor? add) -> Tensor",
    "binary_conv2d": "binary_conv2d(Tensor x, Tensor w, Tensor? threshold, "
                     "Tensor scale, Tensor add, int[] stride, int[] padding, "
                     "bool zero_to_one) -> Tensor",
    "fused_stem": "fused_stem(Tensor x, Tensor w, Tensor? bias, "
                  "ScalarType? out_dtype=None) -> Tensor",
    "fused_chain": "fused_chain(Tensor x, Tensor[] arrays, int[] kinds, "
                   f"Tensor? wfc, Tensor? bfc, {_TAIL}) -> Tensor",
    "fused_stem_chain": "fused_stem_chain(Tensor x, Tensor w, Tensor? bias, "
                        f"Tensor[] arrays, int[] kinds, {_TAIL}) -> Tensor",
    "fused_basic_block": "fused_basic_block(Tensor x, Tensor w1, Tensor w2, "
                         f"{_BASIC_ROWS}, Tensor? threshold, Tensor? threshold2, "
                         f"{_TAIL}) -> Tensor",
    "fused_downsample_block": "fused_downsample_block(Tensor x, Tensor w1, "
                              "Tensor w2, Tensor wd, Tensor? scale1, Tensor? add1, "
                              "Tensor? scale2, Tensor? add2, Tensor? scaled, "
                              "Tensor? addd, Tensor? prelu1, Tensor? prelu2, "
                              "Tensor? threshold1, Tensor? threshold2, "
                              f"Tensor? thresholdd, {_TAIL}) -> Tensor",
    "fused_bottleneck": "fused_bottleneck(Tensor x, Tensor w1, Tensor w2, Tensor w3, "
                        "Tensor? wd, Tensor?[] rows, str act1, str act2, str act3, "
                        "bool zero_to_one, ScalarType? out_dtype) -> Tensor",
}


# -- CPU: the plain versions, on the operators' arguments ---------------------

def _binary_gemm_cpu(x, w_packed, k, scale, add, sign_inputs):
    return binary_gemm_reference(x, w_packed, k, scale, add, sign_inputs=sign_inputs)


def _fused_stem_cpu(x, w, bias, out_dtype=None):
    return fused_stem_reference(x, w, bias, out_dtype=out_dtype)


def _fused_chain_cpu(x, arrays, kinds, wfc, bfc, act1, act2, pre, zero_to_one,
                     out_dtype):
    return fused_chain_reference(x, unflatten(arrays, kinds), wfc, bfc,
                                 act=(act1, act2), pre=pre,
                                 zero_to_one=zero_to_one, out_dtype=out_dtype)


def _fused_stem_chain_cpu(x, w, bias, arrays, kinds, act1, act2, pre,
                          zero_to_one, out_dtype):
    return fused_stem_chain_reference(x, w, bias, unflatten(arrays, kinds),
                                      act=(act1, act2), pre=pre,
                                      zero_to_one=zero_to_one, out_dtype=out_dtype)


def _fused_basic_block_cpu(x, w1, w2, scale1, add1, scale2, add2, prelu1, prelu2,
                           threshold, threshold2, act1, act2, pre, zero_to_one,
                           out_dtype):
    return fused_basic_block_reference(
        x, w1, w2, scale1, add1, scale2, add2, act=(act1, act2), prelu1=prelu1,
        prelu2=prelu2, threshold=threshold, threshold2=threshold2, pre=pre,
        zero_to_one=zero_to_one, out_dtype=out_dtype)


def _fused_downsample_block_cpu(x, w1, w2, wd, scale1, add1, scale2, add2,
                                scaled, addd, prelu1, prelu2, threshold1,
                                threshold2, thresholdd, act1, act2, pre,
                                zero_to_one, out_dtype):
    return fused_downsample_block_reference(
        x, w1, w2, wd, scale1, add1, scale2, add2, scaled, addd,
        act=(act1, act2), prelu1=prelu1, prelu2=prelu2, threshold1=threshold1,
        threshold2=threshold2, thresholdd=thresholdd, pre=pre,
        zero_to_one=zero_to_one, out_dtype=out_dtype)


def _fused_bottleneck_cpu(x, w1, w2, w3, wd, rows, act1, act2, act3,
                          zero_to_one, out_dtype):
    return fused_bottleneck_reference(
        x, w1, w2, w3, wd=wd, act=(act1, act2, act3), zero_to_one=zero_to_one,
        out_dtype=out_dtype, **dict(zip(BOTTLENECK_ROWS, rows)))


# -- fake: the output's shape and dtype --------------------------------------

def _gemm_fake(x, w_packed, k, scale, add, *rest):
    return x.new_empty((x.shape[0], w_packed.shape[1]), dtype=torch.float32)


def _conv_fake(x, w, scale, add):
    return x.new_empty(tuple(x.shape[:3]) + (w.shape[-1],), dtype=torch.float32)


def _stem_fake(x, w, bias, out_dtype=None):
    n, h, ws, _ = x.shape
    return x.new_empty((n, h // 4, ws // 4, w.shape[-1]),
                       dtype=x.dtype if out_dtype is None else out_dtype)


def _chain_out_channels(arrays, kinds) -> int:
    # a block's w2 is its second array, (9 * C_out, C_out) in either kind
    last = sum(3 if KINDS[k] == "basic" else 5 for k in kinds[:-1])
    return arrays[last + 1].shape[1]


def _fused_chain_fake(x, arrays, kinds, wfc, bfc, act1, act2, pre, zero_to_one,
                      out_dtype):
    n, h, w, _ = x.shape
    if wfc is not None:
        return x.new_empty((n, wfc.shape[-1]),
                           dtype=torch.float32 if out_dtype is None else out_dtype)
    if KINDS[kinds[0]] == "down":
        h, w = h // 2, w // 2
    return x.new_empty((n, h, w, _chain_out_channels(arrays, kinds)),
                       dtype=x.dtype if out_dtype is None else out_dtype)


def _fused_stem_chain_fake(x, w, bias, arrays, kinds, act1, act2, pre,
                           zero_to_one, out_dtype):
    n, h, ws, _ = x.shape
    return x.new_empty((n, h // 4, ws // 4, _chain_out_channels(arrays, kinds)),
                       dtype=x.dtype if out_dtype is None else out_dtype)


def _fused_basic_block_fake(x, *args):
    out_dtype = args[-1]
    return x.new_empty(x.shape, dtype=x.dtype if out_dtype is None else out_dtype)


def _fused_downsample_block_fake(x, w1, w2, *args):
    out_dtype = args[-1]
    n, h, w, _ = x.shape
    return x.new_empty((n, h // 2, w // 2, w2.shape[-1]),
                       dtype=x.dtype if out_dtype is None else out_dtype)


def _fused_bottleneck_fake(x, w1, w2, w3, wd, rows, act1, act2, act3,
                           zero_to_one, out_dtype):
    return x.new_empty(tuple(x.shape[:3]) + (w3.shape[-1],),
                       dtype=x.dtype if out_dtype is None else out_dtype)


# name: (CUDA, CPU, fake)
OPS = {
    "binary_gemm": (
        lambda x, w, k, scale, add, sign_inputs: binary_gemm_planned(
            x, w, k, scale, add, sign_inputs=sign_inputs),
        _binary_gemm_cpu, _gemm_fake),
    "popcount_gemm": (popcount_gemm_planned, popcount_gemm_reference, _gemm_fake),
    "binary_conv2d_s1": (binary_conv2d_s1_planned, binary_conv2d_s1_reference,
                         _conv_fake),
    "binary_conv2d": (binary_conv2d_planned, binary_conv2d_cpu, binary_conv2d_fake),
    "fused_stem": (fused_stem_cuda, _fused_stem_cpu, _stem_fake),
    "fused_chain": (fused_chain_cuda, _fused_chain_cpu, _fused_chain_fake),
    "fused_stem_chain": (fused_stem_chain_cuda, _fused_stem_chain_cpu,
                         _fused_stem_chain_fake),
    "fused_basic_block": (fused_basic_block_cuda, _fused_basic_block_cpu,
                          _fused_basic_block_fake),
    "fused_downsample_block": (fused_downsample_block_cuda,
                               _fused_downsample_block_cpu,
                               _fused_downsample_block_fake),
    "fused_bottleneck": (fused_bottleneck_cuda, _fused_bottleneck_cpu,
                         _fused_bottleneck_fake),
}

_lib = torch.library.Library(NAMESPACE, "DEF")
for _name, (_cuda, _cpu, _fake) in OPS.items():
    _lib.define(SCHEMAS[_name])
    _lib.impl(_name, _cuda, "CUDA")
    _lib.impl(_name, _cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{_name}", _fake, lib=_lib)
del _name, _cuda, _cpu, _fake
