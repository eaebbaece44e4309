"""The frozen arithmetic: the H100's published peaks, each kernel call's
least time from the configuration's shapes, and the forward's and the
training step's least time for MFU.

Every count comes from :mod:`portbench.arch` (the configuration's layers,
from its family), never from a kernel's buffers, so a change to a kernel's storage format or
tiling leaves the yardstick where it was. The least time of a call is the
larger of

- operations: 2 x MACs, binary layers at the int8 peak and float layers at
  the bf16 peak;
- bytes: the call's activations in and out, read and written once at the
  configuration's dtype, plus binary weights at one bit each with one f32
  scale per output channel, and float weights at the configuration's dtype.

Peaks: NVIDIA H100 SXM data sheet, dense (989 TFLOP/s bf16, 1,979 TOP/s
int8, 3.35 TB/s HBM3). This module imports neither torch nor the program.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from . import arch

PEAK_OPS_PER_S = {"bfloat16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}
SCALE_BYTES = 4  # one f32 scale per output channel of a binary layer


def macs(config: dict) -> Dict[str, int]:
    """Multiply-accumulates per image, split into ``binary`` and ``float``."""
    out = {"binary": 0, "float": 0}
    for layer in arch.conv_layers(config):
        out[layer["kind"]] += layer["macs"]
    return out


def _ops_s(layers: List[dict]) -> float:
    return sum(2 * l["macs"] / PEAK_OPS_PER_S["int8" if l["kind"] == "binary"
                                              else "bfloat16"] for l in layers)


def _weight_bytes(layers: List[dict], dtype: str) -> float:
    total = 0.0
    for l in layers:
        n = l["cout"] * l["cin"] * l["k"] * l["k"]
        if l["kind"] == "binary":
            total += n / 8 + l["cout"] * SCALE_BYTES
        else:
            total += (n + l["cout"]) * DTYPE_BYTES[dtype]
    return total


def call_bound_s(layers: List[dict], batch: int, act_in: int, act_out: int,
                 dtype: str) -> float:
    """Least time of one call that computes ``layers`` for ``batch`` images,
    reading ``act_in`` and writing ``act_out`` activation elements an image."""
    t_ops = batch * _ops_s(layers)
    nbytes = (batch * (act_in + act_out) * DTYPE_BYTES[dtype]
              + _weight_bytes(layers, dtype))
    return max(t_ops, nbytes / HBM_BYTES_PER_S)


def _act(layer: dict, side: str) -> int:
    h = layer["h_in"] if side == "in" else layer["h_out"]
    return (layer["cin"] if side == "in" else layer["cout"]) * h * h


def binary_gemm_bound(config: dict, shapes: list, batch: int) -> Optional[float]:
    """Least time of one ``binary_gemm`` call of input shapes ``shapes``
    (``x`` ``(M, K)``, the packed weights ``(words, N)``) in a forward of
    ``batch`` images: the binary layer it computes is the configuration's
    with ``K = cin k k`` and ``N = cout`` whose ``batch`` maps make ``M``
    rows. None where no layer does."""
    try:
        (m, k), n = shapes[0], shapes[1][1]
    except (IndexError, TypeError, ValueError):
        return None
    for l in arch.conv_layers(config):
        if (l["kind"] == "binary" and l["cin"] * l["k"] ** 2 == k and l["cout"] == n
                and batch * l["h_out"] ** 2 == m):
            return call_bound_s([l], batch, _act(l, "in"), _act(l, "out"), config["dtype"])
    return None


def binary_conv2d_bound(config: dict, shapes: list, batch: int) -> Optional[float]:
    """Least time of one ``binary_conv2d`` call of input shapes ``shapes``
    (``x`` ``(N, H, W, C)``, the weights ``(O, C, k, k)`` as int8 or
    ``(O, ceil(C / 32), k, k)`` as packed words) in a forward of ``batch``
    images: the configuration's binary layer with ``cin = C``, ``cout = O``,
    that ``k`` and ``H x W`` input. None where no layer matches, or layers
    that match differ in their bound (their stride or padding)."""
    try:
        (n, h, w, c), (o, cw, kh, kw) = shapes[0], shapes[1]
    except (IndexError, TypeError, ValueError):
        return None
    if n != batch or h != w or kh != kw or cw not in (c, -(-c // 32)):
        return None
    found = {call_bound_s([l], batch, _act(l, "in"), _act(l, "out"), config["dtype"])
             for l in arch.conv_layers(config)
             if l["kind"] == "binary" and l["cin"] == c and l["cout"] == o and l["k"] == kh
             and l["h_in"] == h}
    return found.pop() if len(found) == 1 else None


def _block_bound(config: dict, shapes: list, batch: int, kernel: str) -> Optional[float]:
    """Least time of one ``kernel`` call that computes a whole block on
    NHWC input of shape ``shapes[0]``: the first of the configuration's
    blocks that ``kernel`` computes (:func:`portbench.arch.fused_blocks`)
    with that input. None for a family with no such blocks."""
    candidates = arch.fused_blocks(config, kernel)
    if not candidates:
        return None
    try:
        n, h, _, c = shapes[0]
    except (IndexError, TypeError, ValueError):
        return None
    if n != batch:
        return None
    for layers, first, last in candidates:
        if first["cin"] == c and first["h_in"] == h:
            return call_bound_s(layers, batch, _act(first, "in"), _act(last, "out"),
                                config["dtype"])
    return None


def fused_basic_block_bound(config: dict, shapes: list, batch: int) -> Optional[float]:
    """``fused_basic_block``: a basic block with an identity shortcut."""
    return _block_bound(config, shapes, batch, "fused_basic_block")


def fused_downsample_block_bound(config: dict, shapes: list, batch: int) -> Optional[float]:
    """``fused_downsample_block``: a basic block with its projection shortcut."""
    return _block_bound(config, shapes, batch, "fused_downsample_block")


# a kernel's bound per traced call, keyed by the call's input shapes: which
# layer a call computes is read from the call, never from the program's
# routing rules, so a call the program routes elsewhere is counted where it goes
KERNEL_BOUNDS = {"binary_gemm": binary_gemm_bound,
                 "binary_conv2d": binary_conv2d_bound,
                 "fused_basic_block": fused_basic_block_bound,
                 "fused_downsample_block": fused_downsample_block_bound}


def forward_min_s(config: dict) -> float:
    """One image's forward at the peaks: binary MACs at int8, float at bf16."""
    return _ops_s(arch.conv_layers(config))


def train_min_s(config: dict) -> float:
    """One image's training step at the bf16 peak: forward and backward are
    3 x the forward's MACs, every layer at bf16 (QAT computes on floats)."""
    m = macs(config)
    return 3 * 2 * (m["binary"] + m["float"]) / PEAK_OPS_PER_S["bfloat16"]
