"""The port's fused_bottleneck against the JAX kernel, and the binary
ResNet-50's fused serving path against the JAX unfused Predictor.

The JAX Pallas kernel runs in interpret mode, as
tests/test_bottleneck_kernel.py runs it; the port takes its plain version, as
its wrapper does for CPU tensors. The CUDA kernel itself is held against the
plain version on the card by chip_smoke.py.

Tolerances: the integer parts (unit epilogues, identity activations) are
exact sums on both sides, so they must be equal. The f32 epilogues and the
residual add are the same operations in both, but XLA may contract a multiply
and an add into one rounding, so f32 outputs are held to 1e-5, and bf16
outputs to one bf16 ulp (such a difference can round to the neighbouring
bf16 value). Whole-model logits are held to 1e-4, as in
tests/test_torch_small_batch.py: the stem's float convolution sums in
another order than XLA's.
"""
import copy
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bnn_tpu_torch as bt
from bnn_tpu.kernels import bottleneck as jbn
from bnn_tpu_torch.inference import (FusedBottleneck, Predictor, deploy,
                                     fuse_blocks, optimize_deployed)
from bnn_tpu_torch.kernels import (BottleneckDesc, fused_bottleneck,
                                   fused_bottleneck_reference)
from bnn_tpu_torch.kernels import _blocks
from bnn_tpu_torch.kernels import bottleneck as tbn
from bnn_tpu_torch.models.layers import Bottleneck
from bnn_tpu_torch.ops import binarizers as tops
from test_torch_small_batch import _IMAGES, _jax_logits, _models, _nchw


def _pm1(rng, *shape):
    return np.where(rng.randn(*shape) >= 0, 1, -1).astype(np.int8)


def _vec(rng, c, loc=0.0, scale=0.1):
    return (loc + scale * rng.randn(c)).astype(np.float32)


def _case(rng, n, h, w, c, width, cout, act, thresholds, zeros, projection):
    """(positional args, keyword args) of one call, as numpy arrays."""
    x = rng.randn(n, h, w, c).astype(np.float32)
    if zeros:  # ReLU-like input: exact zeros, where sign(0) conventions differ
        x = np.maximum(x, 0.0)
    else:
        x += 0.01
    args = [x, _pm1(rng, c, width), _pm1(rng, 3, 3, width, width),
            _pm1(rng, width, cout),
            _vec(rng, width, 1.0), _vec(rng, width), _vec(rng, width, 1.0),
            _vec(rng, width), _vec(rng, cout, 1.0), _vec(rng, cout)]
    kw = {}
    if projection:
        kw.update(wd=_pm1(rng, c, cout), scaled=_vec(rng, cout, 1.0),
                  addd=_vec(rng, cout))
    if "prelu" in act:
        kw.update(prelu1=_vec(rng, width, 0.25), prelu2=_vec(rng, width, 0.25),
                  prelu3=_vec(rng, cout, 0.25))
    if thresholds:
        kw.update(threshold1=_vec(rng, c, 0.0, 0.05),
                  threshold2=_vec(rng, width, 0.0, 0.05),
                  threshold3=_vec(rng, width, 0.0, 0.05))
        if projection:
            kw["thresholdd"] = _vec(rng, c, 0.0, 0.05)
    return args, kw


def _j(v):
    return None if v is None else jnp.asarray(v)


def _t(v):
    return None if v is None else torch.from_numpy(np.asarray(v))


_OPTIONS = [(act, z21, thr, False, 8, False)
            for act, z21, thr in itertools.product(
                ("relu", "prelu", "identity"), (True, False), (True, False))]
_OPTIONS += [
    # (act, zero_to_one, thresholds, projection, H, bf16)
    ("prelu", False, True, True, 8, False),             # layer1.0's projection
    ("relu", True, False, True, 6, False),
    (("prelu", "identity", "relu"), True, True, False, 7, False),  # odd H
    ("relu", False, True, False, 8, True),              # bf16 in and out
    ("prelu", True, True, True, 7, True),
]


@pytest.mark.parametrize("opts", _OPTIONS, ids=str)
def test_fused_bottleneck_matches_jax_kernel(opts):
    act, z21, thresholds, projection, h, bf16 = opts
    rng = np.random.RandomState(len(str(opts)))
    c, width = 16, 8
    cout = 32 if projection else c
    args, kw = _case(rng, 2, h, 8, c, width, cout, act, thresholds,
                     zeros=not z21, projection=projection)
    jargs = list(map(_j, args))
    targs, tkw = list(map(_t, args)), {k: _t(v) for k, v in kw.items()}
    if bf16:
        jargs[0] = jargs[0].astype(jnp.bfloat16)
        targs[0] = targs[0].to(torch.bfloat16)
    jkw = {k: _j(v) for k, v in kw.items()}
    want = np.asarray(jbn.fused_bottleneck(
        *jargs, act=act, zero_to_one=z21, interpret=True, **jkw).astype(jnp.float32))
    oracle = np.asarray(jbn.fused_bottleneck_reference(
        *jargs, act=act, zero_to_one=z21, **jkw).astype(jnp.float32))
    got_t = fused_bottleneck_reference(*targs, act=act, zero_to_one=z21, **tkw)
    assert got_t.shape == (2, h, 8, cout)
    assert got_t.dtype == (torch.bfloat16 if bf16 else torch.float32)
    got = got_t.float().numpy()
    tol = dict(rtol=2.0 ** -8, atol=1e-5) if bf16 else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(got, oracle, **tol)
    # on CPU tensors the wrapper is the plain version, and launches nothing
    before = fused_bottleneck.launches
    torch.testing.assert_close(
        fused_bottleneck(*targs, act=act, zero_to_one=z21, **tkw), got_t,
        rtol=0, atol=0)
    assert fused_bottleneck.launches == before


@pytest.mark.parametrize("projection", [False, True])
@pytest.mark.parametrize("z21", [True, False])
def test_fused_bottleneck_integer_part_is_exact(z21, projection):
    """Unit epilogues and identity activations: every value is an exact
    integer sum plus x, equal on both sides."""
    rng = np.random.RandomState(5 + 2 * projection + z21)
    c, width = 12, 8
    cout = 20 if projection else c
    x = np.maximum(rng.randn(1, 6, 10, c), 0.0).astype(np.float32)
    ws = [_pm1(rng, c, width), _pm1(rng, 3, 3, width, width), _pm1(rng, width, cout)]
    wd = _pm1(rng, c, cout) if projection else None
    units = [np.ones(width, np.float32), np.zeros(width, np.float32)] * 2 + \
        [np.ones(cout, np.float32), np.zeros(cout, np.float32)]
    want = np.asarray(jbn.fused_bottleneck(
        jnp.asarray(x), *map(jnp.asarray, ws), *map(jnp.asarray, units),
        wd=_j(wd), act="identity", zero_to_one=z21, interpret=True))
    got = fused_bottleneck_reference(
        torch.from_numpy(x), *map(torch.from_numpy, ws),
        *map(torch.from_numpy, units), wd=_t(wd), act="identity",
        zero_to_one=z21).numpy()
    np.testing.assert_array_equal(got, want)


def test_fused_bottleneck_rejects_bad_shapes_and_acts():
    one = torch.ones(8)
    x = torch.zeros(1, 4, 4, 8)
    w1, w2 = torch.ones(8, 4, dtype=torch.int8), torch.ones(3, 3, 4, 4, dtype=torch.int8)
    w3 = torch.ones(4, 8, dtype=torch.int8)
    args = (w1, w2, w3, one[:4], one[:4], one[:4], one[:4], one, one)
    with pytest.raises(ValueError):  # w2 not (3, 3, width, width)
        fused_bottleneck(x, w1, torch.ones(3, 3, 4, 8, dtype=torch.int8), w3,
                         *args[3:])
    with pytest.raises(ValueError):  # identity shortcut with C_out != C
        fused_bottleneck(x, w1, w2, torch.ones(4, 16, dtype=torch.int8),
                         *args[3:])
    with pytest.raises(ValueError):
        fused_bottleneck(x, *args, act=("relu", "relu"))
    with pytest.raises(ValueError):
        fused_bottleneck(x, *args, act="gelu")


def test_fused_bottleneck_refuses_other_devices():
    """Off the CPU the operator launches its kernel or raises: its CUDA
    implementation refuses weights on another device than x before anything
    is built, and so channel counts the kernel's 4-byte gathers cannot take,
    and a device that is not CUDA. Without a card here, the meta device
    stands in for it."""
    def call(x, c, width, dev):
        # the operator's CUDA implementation, as the dispatcher calls it
        w1 = torch.ones(c, width, dtype=torch.int8, device=dev)
        w2 = torch.ones(3, 3, width, width, dtype=torch.int8, device=dev)
        w3 = torch.ones(width, c, dtype=torch.int8, device=dev)
        one = torch.ones(c, device=dev)
        rows = [one if r in ("scale3", "add3") else None for r in tbn.ROWS]
        return tbn.fused_bottleneck_cuda(x, w1, w2, w3, None, rows, "relu",
                                         "relu", "relu", True, None)

    with pytest.raises(ValueError, match="every tensor on meta"):
        call(torch.zeros(1, 4, 4, 8, device="meta"), 8, 4, "cpu")
    with pytest.raises(ValueError, match="divisible by 4"):
        call(torch.zeros(1, 4, 4, 6, device="meta"), 6, 4, "meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        call(torch.zeros(1, 4, 4, 8, device="meta"), 8, 4, "meta")


def test_bottleneck_desc_runs_the_wrapper_on_kept_weights():
    """A kept BottleneckDesc computes what the wrapper computes from the
    same tensors (on the CPU, the plain version: no launch) and refuses a
    row name the kernel does not take."""
    rng = np.random.RandomState(11)
    args, kw = _case(rng, 2, 6, 8, 16, 8, 32, "prelu", True, True, True)
    targs, tkw = list(map(_t, args)), {k: _t(v) for k, v in kw.items()}
    names = ("scale1", "add1", "scale2", "add2", "scale3", "add3")
    rows = dict(zip(names, targs[4:]), **{k: v for k, v in tkw.items() if k != "wd"})
    desc = BottleneckDesc(16, *targs[1:4], tkw["wd"], rows)
    before = fused_bottleneck.launches
    got = desc(targs[0], "prelu", False)
    want = fused_bottleneck(*targs, act="prelu", zero_to_one=False, **tkw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(desc.reference(targs[0], "prelu", False), want,
                               rtol=0, atol=0)
    assert fused_bottleneck.launches == before
    with pytest.raises(ValueError, match="takes the rows"):
        BottleneckDesc(16, *targs[1:4], tkw["wd"], dict(scale4=targs[4]))


def _resnet50():
    model = bt.models.resnet50(num_classes=10,
                               generator=torch.Generator().manual_seed(0))
    return bt.prepare_binary_model(
        model, bt.BConfig(tops.BasicInputBinarizer, tops.BasicScaleBinarizer,
                          tops.XNORWeightBinarizer),
        ignore_layers_name=["_first_", "_last_"]).eval()


def test_fuse_blocks_wraps_resnet50s_stride1_bottlenecks(monkeypatch):
    """13 of ResNet-50's 16 blocks: layer1.0's stride-1 projection included,
    the three strided blocks left on the deployed convs. The wrapper's
    descriptor hands the kernel each row at its place in the kernel's order,
    and is replaced at the next forward when a cast replaces the tensors it
    was made from (its key differs)."""
    model = deploy(_resnet50(), weight_format="int8")
    optimize_deployed(model)
    assert fuse_blocks(model) == 13
    stages = [getattr(model, f"layer{i}") for i in (1, 2, 3, 4)]
    for stage in stages:
        assert isinstance(stage[0], Bottleneck if stage is not stages[0]
                          else FusedBottleneck)
        assert all(isinstance(b, FusedBottleneck) for b in stage[1:])
    first = model.layer1[0]
    assert first.wd is not None and tuple(first.wd.shape) == (64, 256)
    assert model.layer1[1].wd is None
    assert (tuple(first.w1.shape), tuple(first.w2.shape), tuple(first.w3.shape)) == \
        ((64, 64), (3, 3, 64, 64), (64, 256))
    assert first.w1.dtype == torch.int8
    x = torch.randn(1, 64, 8, 8)
    want = first.block(x)
    torch.testing.assert_close(first(x), want, rtol=1e-5, atol=1e-5)
    # what the operator's CUDA implementation keeps for the module's tensors
    monkeypatch.setattr(_blocks, "_check_cuda", lambda name, device: None)

    def kept():
        rows = first._rows()
        return tbn.kept_args(first.w1, first.w2, first.w3, first.wd,
                             [rows.get(r) for r in tbn.ROWS], torch.device("cpu"))

    rows = first._rows()
    assert rows["scaled"] is first.block.downsample[1].scale
    args = kept()
    # the rows are read where the module holds them: no copies
    assert [p == (0 if rows.get(r) is None else rows[r].data_ptr()) for r, p in
            zip(tbn.ROWS, args.ptrs[8:])] == [True] * len(tbn.ROWS)
    first(x)
    assert kept() is args  # made once
    model.to(torch.bfloat16)
    first(x.to(torch.bfloat16))
    again = kept()
    assert again is not args and again.dtype == torch.bfloat16


@pytest.mark.parametrize("batch", [1, 4])
def test_fused_resnet50_predictor_matches_jax(batch):
    """The fused port Predictor (13 fused_bottleneck calls per forward, the
    strided blocks on deployed convs) against the JAX unfused Predictor, with
    the JAX QAT state (BN statistics and alphas randomised) carried across."""
    _, tm, _ = _models("resnet50")
    pred = Predictor(copy.deepcopy(tm), batch_size=batch, device="cpu",
                     dtype=None)
    assert sum(isinstance(m, FusedBottleneck) for m in pred.model.modules()) == 13
    got = pred(_nchw(_IMAGES)).numpy()
    want = _jax_logits("resnet50")
    assert got.shape == (4, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
