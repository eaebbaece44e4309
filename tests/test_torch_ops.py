"""The port's kernels as operators (bnn_tpu_torch/kernels/ops.py), on the
CPU: each of the ten passes torch.library.opcheck (schema, fake
implementation against the real one, tracing) at small shapes, and its CPU
implementation is its wrapper's plain version bit for bit; importing the
operators builds nothing; the arguments the CUDA implementations keep per
weights (kernels/_blocks.Kept) go with their weights and are replaced by an
in-place update."""
import gc
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bnn_tpu_torch import kernels
from bnn_tpu_torch.kernels import _blocks, ops
from bnn_tpu_torch.kernels.bottleneck import ROWS as BOTTLENECK_ROWS
from bnn_tpu_torch.kernels.model import BlockParams, flatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pm1(rng, *shape):
    return torch.from_numpy(np.where(rng.randn(*shape) >= 0, 1, -1).astype(np.int8))


def _f(rng, *shape, loc=0.0, scale=1.0):
    return torch.from_numpy((loc + scale * rng.randn(*shape)).astype(np.float32))


def _rows(rng, c, prelu=True):
    rows = dict(scale1=_f(rng, c, loc=1.0, scale=0.3), add1=_f(rng, c, scale=0.1),
                scale2=_f(rng, c, loc=1.0, scale=0.3), add2=_f(rng, c, scale=0.1))
    if prelu:
        rows.update(prelu1=_f(rng, c, loc=0.25, scale=0.1),
                    prelu2=_f(rng, c, loc=0.25, scale=0.1))
    return rows


def _block(rng, kind, ci, co):
    extra = {}
    if kind == "down":
        extra = dict(wd=_pm1(rng, ci, co), scaled=_f(rng, co, loc=1.0, scale=0.3),
                     addd=_f(rng, co, scale=0.1))
    return BlockParams(kind, _pm1(rng, 3, 3, ci, co), _pm1(rng, 3, 3, co, co),
                       threshold=_f(rng, ci, scale=0.05), **_rows(rng, co), **extra)


def _case(name):
    """``(operator arguments, the wrapper's plain version on them)``."""
    # the nine operators before binary_conv2d keep their seeds
    older = sorted(n for n in ops.OPS if n != "binary_conv2d")
    rng = np.random.RandomState(older.index(name) if name in older else len(older))
    if name in ("binary_gemm", "popcount_gemm"):
        x, w = _f(rng, 5, 70), kernels.pack_bits(_f(rng, 70, 12), axis=-2)
        scale, add = _f(rng, 12, loc=1.0), _f(rng, 12)
        if name == "binary_gemm":
            return ((x, w, 70, scale, add, True),
                    lambda: kernels.binary_gemm_reference(x, w, 70, scale, add))
        xp = kernels.pack_bits(x, axis=-1)
        return ((xp, w, 70, scale, add),
                lambda: kernels.popcount_gemm_reference(xp, w, 70, scale, add))
    if name == "binary_conv2d_s1":
        x, w = _f(rng, 2, 6, 5, 8), _pm1(rng, 3, 3, 8, 4)
        scale, add = _f(rng, 4, loc=1.0), _f(rng, 4)
        return ((x, w, scale, add),
                lambda: kernels.binary_conv2d_s1_reference(x, w, scale, add))
    if name == "binary_conv2d":
        x, w = _f(rng, 2, 9, 7, 10), kernels.pack_bits(_f(rng, 12, 10, 3, 3), axis=1)
        t, scale, add = _f(rng, 10, scale=0.1), _f(rng, 12, loc=1.0), _f(rng, 12)
        return ((x, w, t, scale, add, [2, 1], [1, 1], False),
                lambda: kernels.binary_conv2d_reference(
                    x.permute(0, 3, 1, 2), kernels.unpack_bits(w, 10, axis=1,
                                                               dtype=torch.int8)[:, :10],
                    scale, add, stride=(2, 1), padding=(1, 1),
                    threshold=t).permute(0, 2, 3, 1))
    if name == "fused_stem":
        x, w, b = _f(rng, 1, 16, 12, 3), _f(rng, 7, 7, 3, 16, scale=0.1), _f(rng, 16)
        return (x, w, b), lambda: kernels.fused_stem_reference(x, w, b)
    if name == "fused_chain":
        blocks = [_block(rng, "down", 8, 16), _block(rng, "basic", 16, 16)]
        x, wfc, bfc = _f(rng, 2, 8, 8, 8), _f(rng, 16, 5, scale=0.1), _f(rng, 5)
        arrays, kinds = flatten(blocks)
        return ((x, arrays, kinds, wfc, bfc, "prelu", "relu", False, True, None),
                lambda: kernels.fused_chain_reference(
                    x, blocks, wfc, bfc, act=("prelu", "relu"), zero_to_one=True))
    if name == "fused_stem_chain":
        blocks = [_block(rng, "basic", 8, 8), _block(rng, "basic", 8, 8)]
        x, w, b = _f(rng, 1, 32, 16, 3), _f(rng, 7, 7, 3, 8, scale=0.1), _f(rng, 8)
        arrays, kinds = flatten(blocks)
        return ((x, w, b, arrays, kinds, "relu", "relu", False, False, None),
                lambda: kernels.fused_stem_chain_reference(
                    x, w, b, blocks, zero_to_one=False))
    if name == "fused_basic_block":
        x, w1, w2 = _f(rng, 1, 6, 6, 8), _pm1(rng, 3, 3, 8, 8), _pm1(rng, 3, 3, 8, 8)
        r = _rows(rng, 8)
        t1, t2 = _f(rng, 8, scale=0.05), _f(rng, 8, scale=0.05)
        return ((x, w1, w2, r["scale1"], r["add1"], r["scale2"], r["add2"],
                 r["prelu1"], r["prelu2"], t1, t2, "prelu", "prelu", True, False,
                 None),
                lambda: kernels.fused_basic_block_reference(
                    x, w1, w2, r["scale1"], r["add1"], r["scale2"], r["add2"],
                    act="prelu", prelu1=r["prelu1"], prelu2=r["prelu2"],
                    threshold=t1, threshold2=t2, pre=True, zero_to_one=False))
    if name == "fused_downsample_block":
        x = _f(rng, 1, 6, 6, 8)
        w1, w2, wd = _pm1(rng, 3, 3, 8, 16), _pm1(rng, 3, 3, 16, 16), _pm1(rng, 8, 16)
        r = _rows(rng, 16, prelu=False)
        sd, ad = _f(rng, 16, loc=1.0), _f(rng, 16)
        return ((x, w1, w2, wd, r["scale1"], r["add1"], r["scale2"], r["add2"],
                 sd, ad, None, None, None, None, None, "relu", "relu", False, True,
                 torch.bfloat16),
                lambda: kernels.fused_downsample_block_reference(
                    x, w1, w2, wd, r["scale1"], r["add1"], r["scale2"], r["add2"],
                    sd, ad, out_dtype=torch.bfloat16))
    assert name == "fused_bottleneck"
    x = _f(rng, 1, 5, 5, 16)
    w1, w2, w3, wd = (_pm1(rng, 16, 8), _pm1(rng, 3, 3, 8, 8), _pm1(rng, 8, 32),
                      _pm1(rng, 16, 32))
    named = {r: _f(rng, 8 if r[-1] in "12" else 32, loc=1.0 if "scale" in r else 0.0,
                   scale=0.3) for r in BOTTLENECK_ROWS
             if r.startswith(("scale", "add"))}
    rows = [named.get(r) for r in BOTTLENECK_ROWS]
    return ((x, w1, w2, w3, wd, rows, "relu", "relu", "relu", False, None),
            lambda: kernels.fused_bottleneck_reference(x, w1, w2, w3, wd=wd,
                                                       zero_to_one=False, **named))


NAMES = sorted(ops.OPS)


def test_nine_operators_in_one_namespace():
    assert NAMES == sorted(["binary_gemm", "popcount_gemm", "binary_conv2d_s1",
                            "binary_conv2d",
                            "fused_stem", "fused_chain", "fused_stem_chain",
                            "fused_basic_block", "fused_downsample_block",
                            "fused_bottleneck"])
    for name in NAMES:
        op = getattr(torch.ops.bnn_tpu_torch, name).default
        assert op._schema.name == f"{ops.NAMESPACE}::{name}"


@pytest.mark.parametrize("name", NAMES)
def test_operator_passes_opcheck(name):
    """Schema, the fake implementation against the CPU one (shape, dtype,
    strides) and tracing, at small shapes."""
    args, _ = _case(name)
    torch.library.opcheck(getattr(torch.ops.bnn_tpu_torch, name).default, args)


@pytest.mark.parametrize("name", NAMES)
def test_cpu_implementation_is_the_plain_version(name):
    """Through the dispatcher, a CPU tensor runs the plain version, bit for
    bit, and the fake implementation gives its shape and dtype."""
    args, plain = _case(name)
    got = getattr(torch.ops.bnn_tpu_torch, name)(*args)
    want = plain()
    assert got.dtype == want.dtype and torch.equal(got, want)
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = getattr(torch.ops.bnn_tpu_torch, name)(
            *[mode.from_tensor(a) if isinstance(a, torch.Tensor) else
              [mode.from_tensor(t) if isinstance(t, torch.Tensor) else t for t in a]
              if isinstance(a, list) else a for a in args])
    assert fake.shape == want.shape and fake.dtype == want.dtype


def test_importing_the_operators_builds_nothing(tmp_path):
    """Importing the package registers the ten operators, compiles nothing
    and leaves triton out, on a host with no nvcc."""
    code = ("import sys, torch, bnn_tpu_torch\n"
            "from bnn_tpu_torch.kernels import _build, ops\n"
            "assert 'triton' not in sys.modules\n"
            "assert not _build._libs\n"
            "print(len([n for n in ops.OPS if hasattr(torch.ops.bnn_tpu_torch, n)]))\n")
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME=str(tmp_path))
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.split() == ["10"]


def test_kept_arguments_go_with_their_weights():
    """A kept entry holds what was derived, never its sources: it goes when
    the first of their storages is freed, and a view of the same storage
    finds the same entry."""
    kept = _blocks.Kept()
    w, b = torch.randn(4, 4), torch.randn(4)
    made = []

    def build():
        made.append(1)
        return [w.t().contiguous()]

    first = kept.get([w.permute(1, 0), b], ("x",), build)
    assert kept.get([w.permute(1, 0), b], ("x",), build) is first
    assert len(made) == 1 and len(kept) == 1
    del w, build
    gc.collect()
    assert len(kept) == 0


def test_kept_arguments_follow_in_place_updates():
    """An in-place update makes a new key; its entry replaces the old
    version's, so one set of weights holds one entry."""
    kept = _blocks.Kept()
    w = torch.randn(3)
    one = kept.get([w], (), lambda: [w * 2])
    with torch.no_grad():
        w.add_(1.0)
    two = kept.get([w], (), lambda: [w * 2])
    assert two is not one and torch.equal(two[0], w * 2) and len(kept) == 1
    assert kept.get([w], ("other",), lambda: [w]) is not two and len(kept) == 2
