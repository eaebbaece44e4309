"""A deployed conv's mode ``conv`` (bnn_tpu_torch/kernels/conv.py
``binary_conv2d``): its plain version against the patch-matrix arithmetic
``DeployedConv`` computed before the kernel, bit for bit; the routing of a
deployed conv between the kernel, its plain version and ``binary_gemm``; the
operator under ``torch.export``. The ``card`` tests hold the kernel against
its plain version at the flagships' geometries and a batch-64 ``Predictor``
against ``Predictor(use_pallas=False)``; they skip without a CUDA device
(on the card: ``python -m pytest tests/test_torch_binary_conv2d.py -m card
--noconftest``). This file imports no JAX."""
import copy
import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import bnn_tpu_torch as bt
from bnn_tpu_torch import kernels, layers as tlayers
from bnn_tpu_torch.inference import deploy as deploy_model
from bnn_tpu_torch.inference.deploy import DeployedConv
from bnn_tpu_torch.kernels import conv as kconv
from bnn_tpu_torch.ops import binarizers as tops


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# -- the arithmetic DeployedConv._call_conv computed before the kernel ---------

def _old_sign(x, thr, zero_to_one, dtype):
    if zero_to_one:
        return torch.where(x >= thr, 1, -1).to(dtype)
    return (x > thr).to(dtype) - (x < thr).to(dtype)


def _old_int_mm(a, w):
    m, k = a.shape
    n = w.shape[0]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w = F.pad(w, (0, kp - k, 0, np_ - n))
    return torch._int_mm(a.contiguous(), w.contiguous().t())[:m, :n]


def _old_call_conv(x, w_int8, scale, add, kernel_size, stride, padding, dilation,
                   groups, threshold, zero_to_one):
    from bnn_tpu_torch.utils.padding import pad_same

    per = lambda v: v.reshape((1, -1) + (1,) * (x.ndim - 2))  # noqa: E731
    thr = 0.0 if threshold is None else per(threshold)
    xs = _old_sign(x, thr, zero_to_one, torch.bfloat16)
    if padding == "same":
        xs = pad_same(xs, kernel_size, stride, dilation)
        padding = (0,) * len(kernel_size)
    x4, ks, st, pd, dl = xs, kernel_size, stride, padding, dilation
    if len(kernel_size) == 1:
        x4, ks, st, pd, dl = (xs.unsqueeze(2), (1,) + tuple(ks), (1,) + tuple(st),
                              (0,) + tuple(pd), (1,) + tuple(dl))
    n, _, h, w = x4.shape
    oh = (h + 2 * pd[0] - dl[0] * (ks[0] - 1) - 1) // st[0] + 1
    ow = (w + 2 * pd[1] - dl[1] * (ks[1] - 1) - 1) // st[1] + 1
    cols = F.unfold(x4, ks, dilation=dl, padding=pd, stride=st)
    out_sp = (oh, ow) if len(kernel_size) == 2 else (ow,)
    a = cols.transpose(1, 2).reshape(n * oh * ow, -1).to(torch.int8)
    wm = w_int8.reshape(w_int8.shape[0], -1)
    kg, og = a.shape[1] // groups, wm.shape[0] // groups
    acc = torch.cat([_old_int_mm(a[:, i * kg:(i + 1) * kg], wm[i * og:(i + 1) * og])
                     for i in range(groups)], dim=1) if groups > 1 else _old_int_mm(a, wm)
    y = acc.reshape((x.shape[0],) + tuple(out_sp) + (-1,))
    acc = y.permute((0, y.ndim - 1) + tuple(range(1, y.ndim - 1)))
    return acc.to(scale.dtype) * per(scale) + per(add)


# -- inputs with exact ties ----------------------------------------------------

def _values(rng, shape, dtype):
    """Multiples of 1/8 in [-1, 1] (exact in bf16): many exact zeros and
    exact ties with thresholds drawn from the same set."""
    return torch.from_numpy(rng.randint(-8, 9, size=shape) / 8.0).to(dtype)


def _pm1(rng, *shape):
    return torch.from_numpy(np.where(rng.randn(*shape) >= 0, 1, -1).astype(np.int8))


def _store(w_int8, fmt):
    """The deployed conv's storage of ``w_int8``: itself, or its words packed
    over the in-channels."""
    return w_int8 if fmt == "int8" else kernels.pack_bits(w_int8.float(), axis=1)


GRID = list(itertools.product((1, 3), (1, 2), (False, True), (None, "f32", "bf16"),
                              ("int8", "packed"), ("f32", "bf16"), ("nchw", "nhwc")))
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.parametrize("k,stride,zero_to_one,thr,fmt,dtype,layout", GRID)
def test_plain_version_is_the_old_path(k, stride, zero_to_one, thr, fmt, dtype, layout):
    """binary_conv2d_reference, and the operator's CPU implementation on the
    layer's storage, equal the pre-kernel _call_conv bit for bit: odd H and
    W, C and O off multiples of 8 and 32, padded taps, exact ties."""
    rng = np.random.RandomState(GRID.index((k, stride, zero_to_one, thr, fmt, dtype, layout)))
    n, c, h, w, o = 2, 13, 7, 9, 11
    dt = DTYPES[dtype]
    x = _values(rng, (n, c, h, w), dt)
    if layout == "nhwc":
        x = x.contiguous(memory_format=torch.channels_last)
    w_int8 = _pm1(rng, o, c, k, k)
    w8 = w_int8 if fmt == "int8" else kernels.unpack_bits(
        _store(w_int8, fmt), c, axis=1, dtype=torch.int8)[:, :c]
    assert torch.equal(w8, w_int8)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, o)).to(dt)
    add = torch.from_numpy(rng.uniform(-0.5, 0.5, o)).to(dt)
    threshold = None if thr is None else _values(rng, (c,), DTYPES[thr])
    pad = (k // 2, k // 2)
    want = _old_call_conv(x, w_int8, scale, add, (k, k), (stride, stride), pad,
                          (1, 1), 1, threshold, zero_to_one)
    got = kconv.binary_conv2d_reference(x, w8, scale, add, stride=(stride, stride),
                                        padding=pad, threshold=threshold,
                                        zero_to_one=zero_to_one)
    assert got.dtype == want.dtype == dt and got.stride() == want.stride()
    assert torch.equal(got, want)
    op = kconv.binary_conv2d(x.permute(0, 2, 3, 1).contiguous(), _store(w_int8, fmt),
                             scale, add, stride=(stride, stride), padding=pad,
                             threshold=threshold, zero_to_one=zero_to_one)
    assert op.is_contiguous() and torch.equal(op, want.permute(0, 2, 3, 1))


OTHER_GEOMETRIES = {
    "grouped": dict(k=(3, 3), stride=(1, 1), padding=(1, 1), dilation=(1, 1), groups=2),
    "dilated": dict(k=(3, 3), stride=(1, 1), padding=(2, 2), dilation=(2, 2), groups=1),
    "same_stride2": dict(k=(4, 4), stride=(2, 2), padding="same", dilation=(1, 1), groups=1),
    "conv1d": dict(k=(3,), stride=(2,), padding=(1,), dilation=(1,), groups=1),
}


@pytest.mark.parametrize("name", sorted(OTHER_GEOMETRIES))
def test_plain_version_keeps_the_other_geometries(name):
    """Grouped, dilated, per-call 'same' and 1-D convs, which the kernel does
    not take, keep the old arithmetic bit for bit in the plain version."""
    g = OTHER_GEOMETRIES[name]
    rng = np.random.RandomState(sorted(OTHER_GEOMETRIES).index(name))
    c, o = 6, 10
    spatial = (9, 11)[:len(g["k"])]
    x = _values(rng, (2, c) + spatial, torch.float32)
    w_int8 = _pm1(rng, o, c // g["groups"], *g["k"])
    scale, add = (torch.from_numpy(rng.uniform(0.5, 1.5, o)).float(),
                  torch.from_numpy(rng.uniform(-0.5, 0.5, o)).float())
    threshold = _values(rng, (c,), torch.float32)
    want = _old_call_conv(x, w_int8, scale, add, g["k"], g["stride"], g["padding"],
                          g["dilation"], g["groups"], threshold, False)
    got = kconv.binary_conv2d_reference(
        x, w_int8, scale, add, stride=g["stride"], padding=g["padding"],
        dilation=g["dilation"], groups=g["groups"], threshold=threshold)
    assert torch.equal(got, want)


# -- routing -------------------------------------------------------------------

def _deployed(cin, cout, k, stride, padding, *, mode="auto", groups=1, dilation=1,
              zero_to_one=False, seed=0, **kw):
    torch.manual_seed(seed)
    bc = bt.BConfig(tops.BasicInputBinarizer.with_args(zero_to_one=zero_to_one),
                    tops.BasicScaleBinarizer, tops.XNORWeightBinarizer)
    layer = tlayers.Conv2d(cin, cout, k, stride, padding, groups=groups,
                           dilation=dilation, bconfig=bc)
    with torch.no_grad():
        layer.activation_post_process.alpha.uniform_(0.5, 1.5)
    return DeployedConv(layer, mode=mode, **kw)


@pytest.fixture
def unfolds(monkeypatch):
    """The number of F.unfold calls since the fixture was made."""
    calls = []
    real = F.unfold

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(F, "unfold", spy)
    return calls


@pytest.mark.parametrize("mode", ["gemm", "im2col"])
def test_pointwise_gemm_layers_never_unfold(unfolds, mode):
    """A pointwise conv in a GEMM mode hands binary_gemm its channels-last
    input as rows, no patch matrix, with the old output."""
    layer = _deployed(300, 24, 1, 1, 0, mode=mode)
    rng = np.random.RandomState(1)
    x = _values(rng, (2, 300, 5, 7), torch.float32).contiguous(
        memory_format=torch.channels_last)
    got = layer(x)
    assert not unfolds
    xs = _old_sign(x, 0.0, False, torch.bfloat16)
    cols = F.unfold(xs, (1, 1)).transpose(1, 2).reshape(70, 300)
    y = kernels.binary_gemm_reference(cols, layer.w_packed, layer.k, layer.scale,
                                      layer.add, sign_inputs=False)
    want = layer._to_nc(y.to(layer.scale.dtype), 2, (5, 7))
    assert torch.equal(got, want) and got.stride() == want.stride()


@pytest.mark.parametrize("name,kw,takes_kernel", [
    ("3x3", dict(cin=8, cout=8, k=3, stride=1, padding=1), True),
    ("strided", dict(cin=8, cout=8, k=3, stride=2, padding=1), True),
    ("pointwise", dict(cin=8, cout=16, k=1, stride=1, padding=0), True),
    ("grouped", dict(cin=8, cout=8, k=3, stride=1, padding=1, groups=2), False),
    ("dilated", dict(cin=8, cout=8, k=3, stride=1, padding=2, dilation=2), False),
    ("same_per_call", dict(cin=8, cout=8, k=4, stride=2, padding="same"), False),
])
def test_conv_mode_routing_by_geometry(unfolds, name, kw, takes_kernel):
    """Mode conv takes the kernel where its geometry allows (groups 1,
    dilation 1, static padding) on CUDA tensors; grouped, dilated and
    per-call 'same' layers keep the plain path, as does every layer on the
    CPU, and the plain path unfolds."""
    layer = _deployed(**kw, mode="conv")
    assert layer.mode == "conv" and layer._kernel_geometry is takes_kernel
    x = _values(np.random.RandomState(2), (2, 8, 9, 9), torch.float32)
    layer(x)
    assert len(unfolds) == 1


@pytest.mark.card
def test_kernel_call_on_cuda_tensors(card, unfolds):
    """On the card a layer whose geometry allows it is one kernel launch and
    no unfold; a grouped one unfolds and launches nothing."""
    layer = _deployed(64, 64, 3, 1, 1, mode="conv").to(card)
    grouped = _deployed(64, 64, 3, 1, 1, mode="conv", groups=2).to(card)
    x = _values(np.random.RandomState(3), (4, 64, 14, 14), torch.float32).to(card)
    before = kernels.binary_conv2d.launches
    layer(x)
    assert kernels.binary_conv2d.launches == before + 1 and not unfolds
    grouped(x)
    torch.cuda.synchronize()
    assert kernels.binary_conv2d.launches == before + 1 and len(unfolds) == 1


# -- export --------------------------------------------------------------------

class _Conv(torch.nn.Module):
    def __init__(self, layer):
        super().__init__()
        self.layer = layer

    def forward(self, x):
        return self.layer(x)


def test_operator_traces_under_export():
    """torch.export traces the operator as one node through its fake
    implementation, and the program computes what the operator does."""
    rng = np.random.RandomState(4)
    w = _store(_pm1(rng, 12, 10, 3, 3), "packed")
    scale, add = torch.rand(12) + 0.5, torch.rand(12) - 0.5
    threshold = _values(rng, (10,), torch.float32)

    class Call(torch.nn.Module):
        def forward(self, x):
            return kconv.binary_conv2d(x, w, scale, add, stride=(2, 2), padding=(1, 1),
                                       threshold=threshold, zero_to_one=True)

    x = _values(rng, (2, 9, 7, 10), torch.float32)
    program = torch.export.export(Call(), (x,), strict=False)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("bnn_tpu_torch.binary_conv2d.default") == 1
    assert not any("im2col" in t or "unfold" in t for t in targets)
    assert torch.equal(program.module()(x), Call()(x))


# -- on the card ---------------------------------------------------------------

# (C, O, k, stride, input side) of every mode-conv layer of the flagships at
# 224 x 224: ResNet-18's 3x3 convs and its two pointwise shortcuts with
# K < 256; ResNet-50's 3x3 convs and its pointwise convs with K < 256
FLAGSHIP_CONVS = {
    "resnet18": [(64, 64, 3, 1, 56), (64, 128, 3, 2, 56), (128, 128, 3, 1, 28),
                 (64, 128, 1, 1, 28), (128, 256, 3, 2, 28), (256, 256, 3, 1, 14),
                 (128, 256, 1, 1, 14), (256, 512, 3, 2, 14), (512, 512, 3, 1, 7)],
    "resnet50": [(64, 64, 1, 1, 56), (64, 64, 3, 1, 56), (64, 256, 1, 1, 56),
                 (128, 128, 3, 2, 56), (128, 128, 3, 1, 28), (128, 512, 1, 1, 28),
                 (256, 256, 3, 2, 28), (256, 256, 3, 1, 14), (512, 512, 3, 2, 14),
                 (512, 512, 3, 1, 7)],
}
CARD_CASES = [(arch, geo, batch) for arch, geos in FLAGSHIP_CONVS.items()
              for geo in geos for batch in (64, 3, 1)]


def _card_call(card, geo, batch, *, dtype=torch.bfloat16, zero_to_one=False,
               fmt="packed", thr=True, seed=0):
    c, o, k, stride, side = geo
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(batch, side, side, c).astype(np.float32))
    x = torch.where(torch.rand(x.shape, generator=torch.Generator().manual_seed(seed))
                    < 0.1, 0.0, x).to(dtype).to(card)
    w = _store(_pm1(rng, o, c, k, k), fmt).to(card)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, o)).to(dtype).to(card)
    add = torch.from_numpy(rng.uniform(-0.5, 0.5, o)).to(dtype).to(card)
    threshold = (torch.from_numpy(rng.randn(c) * 0.1).to(dtype).to(card)
                 if thr else None)
    return (x, w, threshold, scale, add, (stride, stride), (k // 2, k // 2), zero_to_one)


def _plain(args):
    x, w, threshold, scale, add, stride, padding, zero_to_one = args
    return kconv.binary_conv2d_cpu(x, w, threshold, scale, add, stride, padding,
                                   zero_to_one)


@pytest.mark.card
@pytest.mark.parametrize("arch,geo,batch", CARD_CASES)
def test_kernel_is_its_plain_version_at_the_flagships(card, arch, geo, batch):
    """Every mode-conv geometry of both flagships, bf16 as served, at batch
    64 and at 3 and 1 (ragged tiles): the kernel equals its plain version
    (unfold + torch._int_mm on the card) bit for bit."""
    args = _card_call(card, geo, batch, seed=batch)
    x, w, threshold, scale, add, stride, padding, zero_to_one = args
    got = kconv.binary_conv2d(x, w, scale, add, stride=stride, padding=padding,
                              threshold=threshold, zero_to_one=zero_to_one)
    assert torch.equal(got, _plain(args))


INSTANCE_CASES = [(tile, loader, dtype, zto, fmt)
                  for tile in kconv.CONV2D_TILES for loader in ("vector", "scalar")
                  for dtype in ("f32", "bf16") for zto in (False, True)
                  for fmt in ("int8", "packed")]


@pytest.mark.card
@pytest.mark.parametrize("tile,loader,dtype,zto,fmt", INSTANCE_CASES)
def test_every_instance_is_its_plain_version(card, tile, loader, dtype, zto, fmt):
    """Each tile and loader, in f32 and bf16, both sign conventions and both
    storages, at a ragged strided shape and one with C off 8 (the scalar
    loader): bit for bit."""
    dt = DTYPES[dtype]
    for geo, batch in (((128, 72, 3, 2, 15), 3), ((40, 24, 3, 1, 9), 2)):
        args = _card_call(card, geo, batch, dtype=dt, zero_to_one=zto, fmt=fmt,
                          seed=len(geo) + batch)
        if loader == "vector" and not kconv._vector_ok(geo[0], dt.itemsize,
                                                       args[0].data_ptr()):
            continue
        got = kconv.binary_conv2d_planned(*args, plan=(tile, loader))
        assert torch.equal(got, _plain(args))
    odd = _card_call(card, (13, 11, 3, 1, 7), 2, dtype=dt, zero_to_one=zto, fmt=fmt)
    assert torch.equal(kconv.binary_conv2d_planned(*odd, plan=(tile, "scalar")), _plain(odd))


@pytest.mark.card
def test_one_launch_a_call(card):
    args = _card_call(card, (64, 64, 3, 1, 14), 4)
    x, w, threshold, scale, add, stride, padding, zero_to_one = args
    before = kernels.binary_conv2d.launches
    for _ in range(3):
        kconv.binary_conv2d(x, w, scale, add, stride=stride, padding=padding,
                            threshold=threshold, zero_to_one=zero_to_one)
    torch.cuda.synchronize()
    assert kernels.binary_conv2d.launches == before + 3


def _flagship(arch):
    torch.manual_seed(0)
    model = getattr(bt.models, arch)(num_classes=1000)
    model = bt.prepare_binary_model(
        model, bt.BConfig(activation_pre_process=tops.BasicInputBinarizer,
                          activation_post_process=tops.BasicScaleBinarizer,
                          weight_pre_process=tops.XNORWeightBinarizer),
        ignore_layers_name=["_first_", "_last_"])
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.7, 1.3)
                m.bias.uniform_(-0.3, 0.3)
                m.running_mean.uniform_(-0.3, 0.3)
                m.running_var.uniform_(0.5, 2.0)
            post = getattr(m, "activation_post_process", None)
            if post is not None and hasattr(post, "alpha"):
                post.alpha.uniform_(0.5, 1.5)
    return model.eval()


@pytest.mark.card
@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_batch64_predictor_is_the_plain_predictor(card, arch):
    """A batch-64 Predictor of each flagship (bf16, its binary convs on the
    kernel) gives the logits of Predictor(use_pallas=False) bit for bit."""
    from bnn_tpu_torch.inference import Predictor

    model = _flagship(arch)
    x = torch.randn(64, 3, 224, 224, generator=torch.Generator().manual_seed(1))
    before = kernels.binary_conv2d.launches
    fast = Predictor(copy.deepcopy(model), batch_size=64, dtype=torch.bfloat16,
                     device=card)(x)
    launched = kernels.binary_conv2d.launches - before
    plain = Predictor(copy.deepcopy(model), batch_size=64, dtype=torch.bfloat16,
                      device=card, use_pallas=False)(x)
    assert launched == len([m for m in deploy_model(copy.deepcopy(model)).modules()
                            if isinstance(m, DeployedConv) and m.mode == "conv"])
    assert torch.equal(fast, plain)
