"""The frozen arithmetic: MACs from the configurations' shapes, and
rooflines that no kernel's buffers enter."""
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import arch, roofline

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("name, total, floats", [
    ("resnet18-flagship", 1.814e9, 118.53e6),
    ("resnet50-flagship", 4.089e9, 120.06e6),
])
def test_macs_at_224(name, total, floats):
    m = roofline.macs(arch.load_config(name))
    assert sum(m.values()) == pytest.approx(total, rel=1e-3)
    # the float stem (7x7 conv) and head; the rest is binary
    assert m["float"] == pytest.approx(floats, rel=1e-3)
    assert m["binary"] == sum(m.values()) - m["float"]


def test_layers_follow_the_published_shapes():
    layers = arch.conv_layers(arch.load_config("resnet50-flagship"))
    assert [l["h_out"] for l in layers if l["name"].endswith(".0.conv2")] == [56, 28, 14, 7]
    assert layers[0]["name"] == "conv1" and layers[-1]["name"] == "fc"
    assert sum(l["kind"] == "binary" for l in layers) == 52
    spec = arch.state_spec(arch.load_config("resnet18-flagship"))
    assert sum(1 for n, _, _ in spec if n.endswith("alpha")) == 19


def test_kernel_bounds_are_keyed_by_the_calls_shapes():
    r18, r50 = arch.load_config("resnet18-flagship"), arch.load_config("resnet50-flagship")
    # bytes bound: R18 layer4's shortcut conv at batch 64, in and out in bf16,
    # 1 bit a weight and an f32 scale a channel; the call names it by its
    # (M, K) input and its packed weights' N, whatever buffers it holds
    bound = roofline.binary_gemm_bound(r18, [[64 * 49, 256], [8, 512]], 64)
    nbytes = 64 * (256 * 7 * 7 + 512 * 7 * 7) * 2 + 256 * 512 / 8 + 512 * 4
    ops = 2 * 64 * 7 * 7 * 256 * 512 / roofline.PEAK_OPS_PER_S["int8"]
    assert bound == pytest.approx(max(nbytes / roofline.HBM_BYTES_PER_S, ops))
    assert roofline.binary_gemm_bound(r18, [[64 * 49, 256], [99, 512]], 64) == bound
    # a 3x3 conv routed to the GEMM (K = 9 cin) is counted as that layer
    assert roofline.binary_gemm_bound(r18, [[64 * 49, 9 * 512], [144, 512]], 64) > 0
    # a call no layer explains has no bound
    assert roofline.binary_gemm_bound(r18, [[100, 256], [8, 512]], 64) is None
    assert roofline.binary_gemm_bound(r50, [[64 * 3136, 256], [8, 64]], 64) > 0
    basic = roofline.fused_basic_block_bound(r18, [[8, 56, 56, 64], [3, 3, 64, 64]], 8)
    ops = 8 * 2 * 2 * 56 * 56 * 64 * 64 * 9 / roofline.PEAK_OPS_PER_S["int8"]
    nbytes = 8 * 2 * 64 * 56 * 56 * 2 + 2 * (64 * 64 * 9 / 8 + 64 * 4)
    assert basic == pytest.approx(max(ops, nbytes / roofline.HBM_BYTES_PER_S))
    assert roofline.fused_basic_block_bound(r18, [[4, 56, 56, 64]], 8) is None
    down = roofline.fused_downsample_block_bound(r18, [[8, 56, 56, 64]], 8)
    assert down > 0 and roofline.fused_downsample_block_bound(r18, [[8, 28, 28, 64]], 8) is None
    assert roofline.fused_basic_block_bound(r50, [[8, 56, 56, 256]], 8) is None


def test_mfu_yardsticks():
    r18 = arch.load_config("resnet18-flagship")
    m = roofline.macs(r18)
    assert roofline.forward_min_s(r18) == pytest.approx(
        2 * m["binary"] / 1979e12 + 2 * m["float"] / 989e12)
    assert roofline.train_min_s(r18) == pytest.approx(6 * sum(m.values()) / 989e12)


def test_arithmetic_imports_neither_torch_nor_the_program():
    code = ("import sys; import portbench.roofline, portbench.arch; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'bnn_tpu_torch', 'bnn_tpu', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"
