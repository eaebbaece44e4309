"""The port's precision casts (bnn_tpu_torch.utils.precision) against
bnn_tpu.utils.precision's: cast_float_tree's rule, and cast_floats with
keep_batch_stats, whose model trains in bf16 with f32 BN statistics."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import bnn_tpu
from bnn_tpu_torch.utils import cast_float_tree, cast_floats
from test_torch_training import _batches, _nchw, _pair

_STATS = ("running_mean", "running_var")


def _bf16_close(got, want, tol=2e-2):
    """Within ``tol`` of the largest |JAX| value: a few bf16 roundings."""
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), \
        np.abs(got - want).max() / np.abs(want).max()


def test_cast_float_tree_casts_floats_only():
    tree = {"w": torch.ones(2), "packed": torch.ones(2, dtype=torch.int8),
            "nest": [torch.zeros(1, dtype=torch.float64), (torch.arange(3), 7)],
            "name": "x"}
    out = cast_float_tree(tree, torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16
    assert out["packed"].dtype == torch.int8
    assert out["nest"][0].dtype == torch.bfloat16
    assert out["nest"][1][0].dtype == torch.int64 and out["nest"][1][1] == 7
    assert out["name"] == "x" and isinstance(out["nest"][1], tuple)


@pytest.mark.parametrize("keep", [False, True])
def test_cast_floats_dtypes(keep):
    _, tm = _pair("fp32")
    assert cast_floats(tm, torch.bfloat16, keep_batch_stats=keep) is tm
    for name, v in tm.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            assert v.dtype == torch.int64
        elif leaf in _STATS and keep:
            assert v.dtype == torch.float32, name
        else:
            assert v.dtype == torch.bfloat16, name


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_keep_batch_stats_forward_matches_jax(mode):
    """A bf16 model with f32 BN statistics: BN outputs in bf16, the logits
    within bf16 rounding of JAX's, and in train mode the statistics updated
    in f32 as JAX updates them, with no warning raised."""
    jm, tm = _pair("fp32")
    bnn_tpu.utils.cast_floats(jm, jnp.bfloat16, keep_batch_stats=True)
    cast_floats(tm, torch.bfloat16, keep_batch_stats=True)
    getattr(jm, mode)()
    getattr(tm, mode)()
    x, _ = _batches(1)[0]
    want = jm(jnp.asarray(x, jnp.bfloat16))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = tm(_nchw(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _bf16_close(got, want)
    bn = tm.layer1[0].bn1
    for stat, jstat in zip(_STATS, ("mean", "var")):
        t = getattr(bn, stat)
        assert t.dtype == torch.float32
        _bf16_close(t, getattr(getattr(jm.layer1, "0").bn1, jstat)[...])
    assert bn(torch.ones(2, 64, 3, 3, dtype=torch.bfloat16)).dtype == torch.bfloat16
