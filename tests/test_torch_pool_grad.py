"""The port's max-pool gradient modes (bnn_tpu_torch.functional) against
bnn_tpu.functional's on the same inputs (numpy, from a seed), the zoo's
MaxPool2d through them, and fuse_stem still fusing a stem whose max-pool is
the port's MaxPool2d."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bnn_tpu.functional as JF
import bnn_tpu_torch as bt
import bnn_tpu_torch.functional as TF
from bnn_tpu_torch.inference import FusedStem
from bnn_tpu_torch.inference.stem import fuse_stem

# name -> (N, C, H, W, kernel, stride, padding); each tiles its rows
# exactly ((H + 2p - k) % s == 0) or leaves only padding uncovered
_GEOMETRIES = {
    "zoo": (2, 3, 16, 16, 3, 2, 1),
    "odd": (2, 3, 11, 9, 3, 2, 1),
    "ties": (2, 4, 12, 12, 3, 2, 1),
}


@contextlib.contextmanager
def _modes(jax_mode, port_mode):
    jprev, tprev = JF.set_pool_grad_mode(jax_mode), TF.set_pool_grad_mode(port_mode)
    try:
        yield
    finally:
        JF.set_pool_grad_mode(jprev)
        TF.set_pool_grad_mode(tprev)


def _input(name, n, c, h, w, seed=0):
    x = np.random.RandomState(seed).randn(n, c, h, w).astype(np.float32)
    if name == "ties":  # post-ReLU: windows of exact zeros, and repeats
        x = np.maximum(x, 0.0)
        x[:, :, ::3, 1::2] = x[:, :, 1::3, 1::2]
    return x


def _pool_grads(x, k, s, p, jax_mode, port_mode):
    """(port, JAX) outputs and input gradients of sum(max_pool(x) * r)."""
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    with _modes(jax_mode, port_mode):
        out = JF.max_pool(xj, k, s, p)
        r = np.random.RandomState(1).randn(*out.shape).astype(np.float32)
        gj = jax.grad(lambda v: jnp.sum(JF.max_pool(v, k, s, p) * r))(xj)
        xt = torch.from_numpy(x).requires_grad_(True)
        ot = TF.max_pool(xt, k, s, p)
        (ot * torch.from_numpy(r.transpose(0, 3, 1, 2))).sum().backward()
    return ((ot.detach().numpy(), np.asarray(out).transpose(0, 3, 1, 2)),
            (xt.grad.numpy(), np.asarray(gj).transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("geometry", sorted(_GEOMETRIES))
@pytest.mark.parametrize("mode", ["exact", "index", "all_ties"])
def test_pool_grad_matches_jax(mode, geometry):
    n, c, h, w, k, s, p = _GEOMETRIES[geometry]
    x = _input(geometry, n, c, h, w)
    (out, jout), (g, jg) = _pool_grads(x, k, s, p, mode, mode)
    np.testing.assert_array_equal(out, jout)
    if mode == "index":
        # JAX's 'index' adds each window slot's plane in turn where windows
        # overlap; torch's backward scatters in another order (1 ulp)
        np.testing.assert_allclose(g, jg, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(g, jg)
    if geometry == "ties" and mode == "all_ties":
        # every tied maximum took the whole window's gradient
        _, (g_first, _) = _pool_grads(x, k, s, p, "exact", "exact")
        assert np.abs(g).sum() > np.abs(g_first).sum()


@pytest.mark.parametrize("port_mode", ["index", "exact"])
def test_uncovered_tail_routes_as_jax_index(port_mode):
    """k=2, s=2 on 5 rows leaves the last real row in no window: it takes
    no gradient in JAX's 'index' and in the port's 'index' and 'exact'
    (torch's backward), which differ there from JAX's 'exact' only."""
    x = _input("odd", 2, 3, 5, 7)
    (out, jout), (g, jg) = _pool_grads(x, 2, 2, 0, "index", port_mode)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(g, jg)  # windows do not overlap
    assert not g[:, :, 4, :].any() and not g[:, :, :, 6].any()


def test_unknown_pool_grad_mode_raises():
    before = TF.set_pool_grad_mode("index")
    try:
        with pytest.raises(ValueError, match="unknown pool grad mode"):
            TF.set_pool_grad_mode("first")
        assert TF.set_pool_grad_mode(before) == "index"
    finally:
        TF.set_pool_grad_mode(before)


def test_maxpool_module_follows_the_mode():
    pool = bt.nn.MaxPool2d(kernel_size=3, stride=2, padding=1)
    x = torch.from_numpy(_input("ties", 2, 4, 12, 12))
    grads = {}
    for mode in ("exact", "all_ties"):
        prev = TF.set_pool_grad_mode(mode)
        try:
            xt = x.clone().requires_grad_(True)
            pool(xt).sum().backward()
            grads[mode] = xt.grad
        finally:
            TF.set_pool_grad_mode(prev)
    xt = x.clone().requires_grad_(True)
    torch.nn.functional.max_pool2d(xt, 3, 2, 1).sum().backward()
    torch.testing.assert_close(grads["exact"], xt.grad, rtol=0, atol=0)
    assert grads["all_ties"].sum() > grads["exact"].sum()


def test_fuse_stem_fuses_the_zoo_maxpool():
    """The zoo's max-pool is the port's MaxPool2d; fuse_stem takes it as it
    takes nn.MaxPool2d, and the fused stem computes what the unfused did."""
    model = bt.models.resnet18(num_classes=10,
                               generator=torch.Generator().manual_seed(0)).eval()
    assert type(model.maxpool) is bt.nn.MaxPool2d
    x = torch.from_numpy(_input("zoo", 2, 3, 64, 64))
    with torch.no_grad():
        want = model(x)
        assert fuse_stem(model) == 1
        assert isinstance(model.conv1, FusedStem)
        torch.testing.assert_close(model(x), want, rtol=1e-4, atol=1e-4)
