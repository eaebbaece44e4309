"""The port's frozen serving bundle (bnn_tpu_torch/inference/export.py) on
the CPU, at 32x32 with 10 classes: tests/test_export.py's cases that apply
to one device, on every serving path of the port (the fused ResNet-18 at
batch 1 and 8, fuse_entry, ResNet-34's per-block layer4, ResNet-50's
Bottlenecks, pallas-conv, popcount, the int8 head). Each bundle round-trips
bit for bit; its graph holds the path's kernel operators, counted, and no
inlined plain version; the live predictor serves as before the export; and
the port's bundle matches the JAX package's bundle of the same weights."""
import copy
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import bnn_tpu
import bnn_tpu_torch as bt
from bnn_tpu.inference import Predictor as JPredictor
from bnn_tpu.inference import export_serving as jexport_serving
from bnn_tpu.inference import load_serving as jload_serving
from bnn_tpu.ops import binarizers as jops
from bnn_tpu_torch import layers
from bnn_tpu_torch.binarize import set_module_by_name
from bnn_tpu_torch.inference import (DeployedConv, ExportedServer, Predictor,
                                     deploy, export_serving, fuse_entry,
                                     load_serving, optimize_deployed,
                                     space_to_depth_stem)
from bnn_tpu_torch.ops import binarizers as tops
from bnn_tpu_torch.utils import cast_floats, load_jax_state
from test_torch_serving import _flat, _nchw, _randomized, _write_flat

SIZE = 32


def _qat(depth, z1_prelu=False, classes=10):
    """The flagship recipe's binary ResNet of ``depth`` (float first and
    last layers; ``z1_prelu``: zero_to_one signs and PReLU), with random BN
    statistics, alphas and slopes from a seed."""
    gen = torch.Generator().manual_seed(depth)
    kw = dict(activation=torch.nn.PReLU) if z1_prelu else {}
    sign = (tops.BasicInputBinarizer.with_args(zero_to_one=True) if z1_prelu
            else tops.BasicInputBinarizer)
    model = getattr(bt.models, f"resnet{depth}")(num_classes=classes, generator=gen,
                                                 **kw)
    model = bt.prepare_binary_model(
        model, bt.BConfig(sign, tops.BasicScaleBinarizer, tops.XNORWeightBinarizer),
        ignore_layers_name=["_first_", "_last_"])
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(0.3 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.5 + 1.5 * torch.rand(c, generator=gen))
                m.weight.copy_(1.0 + 0.3 * torch.randn(c, generator=gen))
                m.bias.copy_(0.3 * torch.randn(c, generator=gen))
            elif isinstance(m, tops.BasicScaleBinarizer):
                m.alpha.copy_(0.5 + torch.rand(m.alpha.shape, generator=gen))
            elif isinstance(m, torch.nn.PReLU):
                m.weight.copy_(0.05 + 0.45 * torch.rand(m.weight.shape, generator=gen))
    return model.eval()


class Served:
    """Path B's model served as a ``Predictor`` serves (what
    ``export_serving`` reads of one: model, batch_size, dtype, device)."""

    def __init__(self, model, batch_size, dtype):
        self.model, self.batch_size, self.dtype = model, batch_size, dtype
        self.device = torch.device("cpu")

    @torch.no_grad()
    def __call__(self, x):
        from bnn_tpu_torch.inference import batched_call
        return batched_call(self.model, torch.as_tensor(x).to(self.dtype),
                            self.batch_size)


def _pallas_conv(dtype=torch.bfloat16):
    """Path B: the Z1-PReLU ResNet-18 deployed with every stride-1 3x3
    binary conv in mode pallas-conv (binary_conv2d_s1), at batch 8."""
    qat = _qat(18, z1_prelu=True)
    model = deploy(copy.deepcopy(qat), weight_format="int8")
    for name, m in qat.named_modules():
        if (isinstance(m, layers.Conv2d) and tuple(m.kernel_size) == (3, 3)
                and tuple(m.stride) == (1, 1)):
            set_module_by_name(model, name, DeployedConv(
                m, mode="pallas-conv", weight_format="int8"))
    optimize_deployed(model)
    space_to_depth_stem(model)
    cast_floats(model, dtype)
    return Served(model.eval(), 8, dtype)


def _entry():
    pred = Predictor(_qat(18), batch_size=1, device="cpu")
    assert fuse_entry(pred.model) == 1
    return pred


# path: (how to build its predictor, kernel operators per forward)
PATHS = {
    "r18_b1": (lambda: Predictor(_qat(18), batch_size=1, device="cpu"),
               {"fused_stem": 1, "fused_chain": 4}),
    "r18_b8": (lambda: Predictor(_qat(18), batch_size=8, device="cpu"),
               {"fused_stem": 1, "binary_gemm": 1}),
    "entry_b1": (_entry, {"fused_stem_chain": 1, "fused_chain": 3}),
    "r34_b1": (lambda: Predictor(_qat(34), batch_size=1, device="cpu"),
               {"fused_stem": 1, "fused_chain": 3, "fused_downsample_block": 1,
                "fused_basic_block": 2}),
    "r50_b1": (lambda: Predictor(_qat(50), batch_size=1, device="cpu"),
               {"fused_stem": 1, "fused_bottleneck": 13, "binary_gemm": 8}),
    "pallas_conv_b8": (_pallas_conv, {"binary_conv2d_s1": 13, "binary_gemm": 1}),
    "popcount_b8": (lambda: Predictor(_qat(50, z1_prelu=True), batch_size=8,
                                      binary_gemm_impl="popcount", device="cpu"),
                    {"popcount_gemm": 36}),
    # 32 classes: an fc of 2 ** 14 weights, the fewest quantize_float_layers
    # takes (the serve CLI's 1000-class head is 512,000)
    "int8_head_b1": (lambda: Predictor(_qat(18, classes=32), batch_size=1,
                                       device="cpu", quantize_float_bits=8),
                     {"fused_stem": 1, "fused_chain": 4}),
    "int8_head_b8": (lambda: Predictor(_qat(18, classes=32), batch_size=8,
                                       device="cpu", quantize_float_bits=8),
                     {"fused_stem": 1, "binary_gemm": 1}),
}
_IMAGES = torch.from_numpy(
    np.random.RandomState(0).randn(10, 3, SIZE, SIZE).astype(np.float32))


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """Per path, built once: (predictor, its logits before the export,
    after it, the loaded bundle)."""
    out = {}

    def get(path):
        if path not in out:
            pred = PATHS[path][0]()
            x = _IMAGES[:pred.batch_size]
            before = pred(x), [p.requires_grad for p in pred.model.parameters()]
            where = str(tmp_path_factory.mktemp(path) / "bundle")
            export_serving(pred, where, (3, SIZE, SIZE))
            after = pred(x), [p.requires_grad for p in pred.model.parameters()]
            out[path] = (pred, before, after, load_serving(where), where)
        return out[path]

    return get


@pytest.mark.parametrize("path", sorted(PATHS))
def test_round_trip_exact(bundles, path):
    pred, (before, _), _, server, _ = bundles(path)
    assert isinstance(server, ExportedServer)
    got = server(_IMAGES[:pred.batch_size])
    assert got.dtype == before.dtype and got.shape == before.shape
    assert torch.equal(got, before)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_graph_holds_the_kernels(bundles, path):
    """The exported graph holds the path's kernel operators, as many as a
    forward launches, and none of the plain versions' arithmetic: no bit
    shifts (unpacking words), no rounding and no float64 (their exact
    integer sums)."""
    server = bundles(path)[3]
    ours, plain = {}, []
    for node in server.program.graph.nodes:
        if node.op != "call_function":
            continue
        target = str(node.target)
        if target.startswith("bnn_tpu_torch."):
            name = target.split(".")[1]
            ours[name] = ours.get(name, 0) + 1
        val = node.meta.get("val")
        if (any(s in target for s in ("rshift", "right_shift", "round"))
                or getattr(val, "dtype", None) == torch.float64):
            plain.append(target)
    assert ours == PATHS[path][1]
    assert not plain


@pytest.mark.parametrize("path", sorted(PATHS))
def test_live_predictor_unchanged_after_export(bundles, path):
    """The export leaves the live predictor as it was: the same logits bit
    for bit, and each parameter's requires_grad."""
    _, (before, grads), (after, grads_after), _, _ = bundles(path)
    assert torch.equal(after, before)
    assert grads_after == grads


def test_padding_and_multi_batch(bundles):
    """Ragged requests pad to the bundle's batch and split into as many
    forwards, as the live predictor does."""
    for path in ("r18_b1", "r18_b8"):
        pred, _, _, server, _ = bundles(path)
        for n in (3, 10):
            got = server(_IMAGES[:n])
            assert got.shape == (n, 10) and torch.equal(got, pred(_IMAGES[:n]))


def test_bf16_weights_survive(bundles):
    pred, _, _, server, _ = bundles("r18_b1")
    live = {k: v for k, v in pred.model.state_dict().items()}
    saved = {k.removeprefix("model."): v for k, v in server.program.state_dict.items()}
    bf16 = [k for k, v in saved.items() if v.dtype == torch.bfloat16]
    assert len(bf16) > 10
    for k in bf16:
        assert torch.equal(saved[k], live[k]), k
    assert server.state_bytes() == pred.state_bytes()


def test_bundle_layout_and_meta(bundles):
    pred, _, _, server, where = bundles("r18_b8")
    assert sorted(os.listdir(where)) == ["meta.json", "program.pt2"]
    meta = json.load(open(os.path.join(where, "meta.json")))
    assert meta["format_version"] == 1 and meta["batch_size"] == 8
    assert meta["input_shape"] == [3, SIZE, SIZE] and meta["layout"] == "NCHW"
    assert meta["input_dtype"] == "bfloat16" and meta["platforms"] == ["cpu"]
    assert meta["nr_devices"] == 1 and meta["mesh"] is None
    assert meta["torch"] == torch.__version__
    assert (server.batch_size, server.input_shape, server.platforms, server.dtype,
            server.mesh) == (8, (3, SIZE, SIZE), ("cpu",), torch.bfloat16, None)


def test_int8_head_exports(bundles):
    from bnn_tpu_torch.inference import QuantizedLinear
    pred, _, _, server, _ = bundles("int8_head_b1")
    assert isinstance(pred.model.fc, QuantizedLinear)
    assert any(v.dtype == torch.int8 and k.endswith("w_q")
               for k, v in server.program.state_dict.items())
    assert server.state_bytes() == pred.state_bytes()
    assert not any(k.endswith("fc.weight") for k in server.program.state_dict)


def test_other_platforms_are_refused(bundles, tmp_path):
    """A bundle runs on the device type it was exported on: another
    ``platforms=`` is refused at export, another device at load, and a
    ``cuda`` bundle on a host without a card, with no move to the CPU."""
    pred, _, _, _, where = bundles("r18_b1")
    with pytest.raises(ValueError, match="device type"):
        pred.export(str(tmp_path / "x"), (3, SIZE, SIZE), platforms=["cuda"])
    with pytest.raises(ValueError, match="device type"):
        pred.export(str(tmp_path / "x"), (3, SIZE, SIZE), platforms=["cpu", "cuda"])
    pred.export(str(tmp_path / "ok"), (3, SIZE, SIZE), platforms=["cpu"])
    with pytest.raises(ValueError, match="runs only there"):
        load_serving(where, device="cuda")
    meta = json.load(open(os.path.join(where, "meta.json")))
    cuda = tmp_path / "cuda"
    cuda.mkdir()
    json.dump(dict(meta, platforms=["cuda"]), open(cuda / "meta.json", "w"))
    with pytest.raises(ValueError, match="runs only there"):
        load_serving(str(cuda), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_serving(str(cuda))


def test_loader_validates(bundles, tmp_path):
    with pytest.raises(FileNotFoundError):
        load_serving(str(tmp_path / "nothing"))
    where = bundles("r18_b1")[4]
    meta = json.load(open(os.path.join(where, "meta.json")))
    bad = tmp_path / "bad"
    bad.mkdir()
    json.dump(dict(meta, format_version=99), open(bad / "meta.json", "w"))
    with pytest.raises(ValueError, match="format"):
        load_serving(str(bad))
    server = bundles("r18_b1")[3]
    with pytest.raises(ValueError, match="input shape"):
        server(torch.zeros(1, 3, SIZE + 2, SIZE))


def test_mesh_bundle_waits_for_mesh_serving(bundles, tmp_path):
    meta = json.load(open(os.path.join(bundles("r18_b1")[4], "meta.json")))
    mesh = tmp_path / "mesh"
    mesh.mkdir()
    json.dump(dict(meta, mesh={"axis_names": ["data"], "axis_sizes": [2]},
                   nr_devices=2), open(mesh / "meta.json", "w"))
    # a mesh bundle serves on a world of its size; this process is a world of one
    with pytest.raises(ValueError, match="2 devices.*this world has 1"):
        load_serving(str(mesh))


def test_bundle_matches_the_jax_bundle(tmp_path):
    """Both packages' bundles of the same weights (carried by
    load_jax_state), each exported and loaded: logits within 1e-4."""
    jm = bnn_tpu.prepare_binary_model(
        bnn_tpu.models.resnet18(num_classes=10, rngs=nnx.Rngs(7)),
        bnn_tpu.BConfig(jops.BasicInputBinarizer, jops.BasicScaleBinarizer,
                        jops.XNORWeightBinarizer),
        ignore_layers_name=["_first_", "_last_"])
    flat = _randomized(_flat(jm), np.random.RandomState(7))
    _write_flat(jm, flat)
    tm = bt.prepare_binary_model(
        bt.models.resnet18(num_classes=10),
        bt.BConfig(tops.BasicInputBinarizer, tops.BasicScaleBinarizer,
                   tops.XNORWeightBinarizer),
        ignore_layers_name=["_first_", "_last_"])
    load_jax_state(tm, flat)
    jexport_serving(JPredictor(jm, use_pallas=False, fuse=False, dtype=None,
                               batch_size=8), str(tmp_path / "jax"),
                    input_shape=(SIZE, SIZE, 3))
    Predictor(tm, batch_size=8, device="cpu", dtype=None).export(
        str(tmp_path / "port"), (3, SIZE, SIZE))
    x = np.random.RandomState(8).randn(10, SIZE, SIZE, 3).astype(np.float32)
    want = np.asarray(jload_serving(str(tmp_path / "jax"))(jnp.asarray(x)))
    got = load_serving(str(tmp_path / "port"))(_nchw(x)).numpy()
    assert got.shape == want.shape == (10, 10)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
