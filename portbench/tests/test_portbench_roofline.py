"""The frozen arithmetic: MACs from the configurations' shapes, and
rooflines that no kernel's buffers enter."""
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import arch, roofline, run
from portbench.trace import PORT_KERNELS, Trace, port_kernel

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


def test_binary_conv2d_bound_is_keyed_by_the_calls_shapes(monkeypatch):
    r18 = arch.load_config("resnet18-flagship")
    # R18 layer1's 3x3 convs at batch 64: x (N, H, W, C), w (O, C, k, k)
    bound = roofline.binary_conv2d_bound(r18, [[64, 56, 56, 64], [64, 64, 3, 3]], 64)
    ops = 2 * 64 * 56 * 56 * 64 * 64 * 9 / roofline.PEAK_OPS_PER_S["int8"]
    nbytes = 64 * 2 * 64 * 56 * 56 * 2 + 64 * 64 * 9 / 8 + 64 * 4
    assert bound == pytest.approx(max(ops, nbytes / roofline.HBM_BYTES_PER_S))
    # the weights' words packed over the in-channels name the same layer
    assert roofline.binary_conv2d_bound(r18, [[64, 56, 56, 64], [64, 2, 3, 3]], 64) == bound
    # a shortcut's 1x1 conv reads the pooled map
    assert roofline.binary_conv2d_bound(r18, [[64, 28, 28, 64], [128, 64, 1, 1]], 64) > 0
    for shapes, batch in [([[8, 56, 56, 64], [64, 64, 3, 3]], 64),   # another batch
                          ([[64, 56, 56, 64], [64, 63, 3, 3]], 64),  # no such weights
                          ([[64, 57, 57, 64], [64, 64, 3, 3]], 64),  # no such input
                          ([[64, 56, 56, 64]], 64)]:
        assert roofline.binary_conv2d_bound(r18, shapes, batch) is None
    # two layers of one shape but another stride: no single layer, no bound
    layer = next(l for l in arch.conv_layers(r18) if l["name"] == "layer1.0.conv1")
    strided = dict(layer, stride=2, h_out=28, macs=layer["macs"] // 4)
    monkeypatch.setattr(arch, "conv_layers", lambda config: [layer, strided])
    assert roofline.binary_conv2d_bound(r18, [[64, 56, 56, 64], [64, 64, 3, 3]], 64) is None


@pytest.mark.parametrize("cell, name, bound_us", [("r50-serve-b64", "resnet50-flagship", 403.1),
                                                   ("r18-serve-b64", "resnet18-flagship", 158.9)])
def test_binary_conv2d_bounds_every_call_a_batch_64_forward_makes(cell, name, bound_us):
    # the calls one request made on the card (``frozen_resnet.json``), against
    # the kernel's bound over a forward that gemm_shapes.py --conv2d reports
    calls = json.loads((Path(__file__).parent / "frozen_resnet.json").read_text())["conv2d_calls"]
    bounds = [roofline.binary_conv2d_bound(arch.load_config(name), shapes, 64)
              for shapes in calls[cell]]
    assert None not in bounds and len(bounds) == {"r50-serve-b64": 25, "r18-serve-b64": 18}[cell]
    assert 1e6 * sum(bounds) == pytest.approx(bound_us, abs=0.05)


def test_binary_conv2d_is_a_port_kernel():
    assert "binary_conv2d" in PORT_KERNELS
    conv = "void (anonymous namespace)::binary_conv2d_kernel<(anonymous namespace)::T>(Params)"
    s1 = "void (anonymous namespace)::binary_conv2d_s1_kernel<__nv_bfloat16>(Params)"
    assert port_kernel(conv) == "binary_conv2d"
    assert port_kernel(s1) == "binary_conv2d_s1"
    assert port_kernel("void at::native::im2col_kernel<float>(long)") is None
    # its device time no longer counts among the torch kernels
    trace = Trace([(conv, 0.0, 400.0), ("Memcpy HtoD (Pageable -> Device)", 500.0, 600.0)],
                  [], 0.0, 1000.0, units=2, slices=1, whole=True)
    read = run.readers()["torch_kernels_ms.serve"].read
    assert read(SimpleNamespace(kind="serve", trace=trace)) == pytest.approx(0.05)


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


def test_the_families_arithmetic_imports_neither_torch_nor_the_program():
    code = ("import sys; from portbench import arch, roofline; "
            "c = arch.load_config('resnet18-flagship'); roofline.macs(c); "
            "roofline.fused_basic_block_bound(c, [[8, 56, 56, 64]], 8); arch.state_spec(c); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'bnn_tpu_torch', 'bnn_tpu', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"
