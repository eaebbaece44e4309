"""The port's multi-device serving (Predictor(mesh=, tensor_parallel=),
bnn_tpu_torch.inference.tp and .tp_packed) against bnn_tpu's, with gloo
ranks on the CPU: one world of two ranks (a data axis of 2, a model axis
of 2, the packed chain over 2) and one of four (data 4, 2x2, a model axis
of 4 alone, ResNet-18 under tensor parallelism, the chain over 4 and over
the 2x2 mesh's model axis), both running while the JAX side runs here.

Tolerances: the Predictor's rtol 1e-4 / atol 1e-4, as
tests/test_torch_serving.py:118; the packed chain bit for bit against
JAX's packed_tp_chain and the port's reference_chain; the tensor-parallel
ResNet-18 bit for bit against the replicated unfused Predictor.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import bnn_tpu
import test_tp_packed as jtpk
import test_tp_serving as jts
from bnn_tpu.inference import Predictor as JaxPredictor
from bnn_tpu.inference import ici_bytes_per_layer as jax_ici
from bnn_tpu.inference import packed_tp_chain as jax_chain
from bnn_tpu.ops import binarizers as jops
from bnn_tpu.parallel import make_mesh as jax_mesh
from test_torch_small_batch import _randomized, _write_flat
from test_torch_training import _flat
from torch_distributed_worker import start_world

CHAIN = (512, 768, 512, 256)
COMMON = dict(batch_size=8, use_pallas=False, dtype=None, fuse=False, space_to_depth=False)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _tensors(flat):
    return {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rng = np.random.RandomState(0)
    jm = jts._bin_model()
    flat = _randomized(_flat(nnx.state(jm)), rng)
    x = np.asarray(jts._rand_no_zeros(jax.random.key(0), (8, 8, 8, 3)))
    r18 = bnn_tpu.prepare_binary_model(
        bnn_tpu.models.resnet18(num_classes=16, rngs=nnx.Rngs(0)),
        bnn_tpu.BConfig(jops.BasicInputBinarizer, jops.BasicScaleBinarizer,
                        jops.XNORWeightBinarizer),
        ignore_layers_name=["_first_", "_last_"])
    r18_flat = _randomized(_flat(nnx.state(r18)), rng)
    chain = jtpk.make_chain(CHAIN)
    chain_x = np.asarray(jax.random.normal(jax.random.key(0), (16, CHAIN[0])))
    inputs = {"flat": _tensors(flat), "x": _nchw(x),
              "r18_flat": _tensors(r18_flat), "r18_x": _nchw(
                  np.asarray(jts._rand_no_zeros(jax.random.key(1), (8, 32, 32, 3)))),
              "chain_sizes": torch.tensor(CHAIN), "chain_x": torch.from_numpy(chain_x),
              # JAX's packed words, read back as the float +/-1 weights
              "chain_w": [torch.from_numpy(np.asarray(bnn_tpu.kernels.packing.unpack_bits(
                  l.w_packed, l.k, axis=-2))[:l.k]) for l in chain],
              "chain_s": [torch.from_numpy(np.asarray(l.scale)) for l in chain],
              "chain_a": [torch.from_numpy(np.asarray(l.add)) for l in chain]}
    root = tmp_path_factory.mktemp("tp_serving")
    worlds = {n: start_world("tp_serving", n, root / f"world{n}", inputs) for n in (2, 4)}
    try:
        ref = _jax_side(flat, x, chain, chain_x)
        return {n: w.results() for n, w in worlds.items()}, ref, chain
    finally:
        for w in worlds.values():
            w.__exit__(None, None, None)


def _jax_side(flat, x, chain, chain_x):
    ref = {}

    def model():
        m = jts._bin_model()
        _write_flat(m, flat)
        return m

    ref["replicated"] = np.asarray(JaxPredictor.from_model(model(), **COMMON)(x))
    for n in (2, 4):
        dev = jax.devices()[:n]
        ref[f"dp_{n}"] = np.asarray(JaxPredictor.from_model(
            model(), mesh=jax_mesh(data=n, devices=dev), **COMMON)(x))
        mesh = jax.make_mesh((n,), ("model",), devices=dev)
        ref[f"tp_model_{n}"] = np.asarray(JaxPredictor.from_model(
            model(), mesh=mesh, tensor_parallel=True, **COMMON)(x))
        ref[f"chain_{n}"] = np.asarray(jax_chain(chain, jax_mesh(data=1, model=n, devices=dev))(
            jnp.asarray(chain_x)))
        ref[f"ici_{n}"] = [jax_ici(16, k, n)["packed_ring"] for k in CHAIN[:-1]]
    mesh22 = jax_mesh(data=2, model=2, devices=jax.devices()[:4])
    ref["tp_2x2"] = np.asarray(JaxPredictor.from_model(
        model(), mesh=mesh22, tensor_parallel=True, **COMMON)(x))
    ref["chain_2x2"] = np.asarray(jax_chain(chain, mesh22)(jnp.asarray(chain_x)))
    jtp = JaxPredictor.from_model(model(), mesh=jax_mesh(data=1, model=4,
                                                         devices=jax.devices()[:4]),
                                  tensor_parallel=True, **COMMON)
    ref["tp_layers"] = jtp.tp_layers
    return ref


def _ranks(run, n):
    return run[0][n]


@pytest.mark.parametrize("n", [2, 4])
def test_ranks_import_no_jax(run, n):
    assert all(r["jax_imported"] == [] for r in _ranks(run, n))


@pytest.mark.parametrize("n", [2, 4])
def test_data_parallel_predictor_matches_jax(run, n):
    _, ref, _ = run
    for r in _ranks(run, n):
        np.testing.assert_allclose(r["dp_dp"].numpy(), ref[f"dp_{n}"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["replicated"].numpy(), ref["replicated"], rtol=1e-4,
                                   atol=1e-4)
        torch.testing.assert_close(r["dp_dp"], r["replicated"], rtol=0, atol=0)


@pytest.mark.parametrize("n,tag", [(2, "model"), (4, "model"), (4, "2x2")])
def test_tensor_parallel_predictor_matches_jax(run, n, tag):
    """The model-only mesh serves replicated batches; on 2x2 the batch
    splits over data and each layer over model."""
    _, ref, _ = run
    want = ref[f"tp_model_{n}"] if tag == "model" else ref["tp_2x2"]
    for r in _ranks(run, n):
        np.testing.assert_allclose(r[f"tp_{tag}"].numpy(), want, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(r[f"tp_{tag}"], r["replicated"], rtol=0, atol=0)
        assert r[f"tp_layers_{tag}"] == ref["tp_layers"]
    np.testing.assert_allclose(ref[f"tp_model_{n}"], ref["replicated"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,tag", [(2, "model"), (4, "model"), (4, "2x2")])
def test_packed_bytes_per_rank_are_one_over_p(run, n, tag):
    """Each rank holds 1/P of every tagged layer's packed words; the
    logical state_bytes is the replicated predictor's, as in JAX."""
    p = n if tag == "model" else 2
    for r in _ranks(run, n):
        total, local = r[f"tp_bytes_{tag}"]
        assert total == r["replicated_bytes"] and local < total
        assert len(r[f"tp_packed_{tag}"]) >= 2
        for name, (nbytes, _) in r[f"tp_packed_{tag}"].items():
            assert nbytes * p == r["replicated_packed"][name], name


def test_untagged_when_channels_do_not_divide(run):
    for n in (2, 4):
        for r in _ranks(run, n):
            assert r["untagged"] == ([] if n == 4 else ["0", "3"])


def test_tensor_parallel_resnet18_is_bit_identical_to_replicated(run):
    for r in _ranks(run, 4):
        assert r["r18_layers"] >= 16
        torch.testing.assert_close(r["r18_tp"], r["r18_ref"], rtol=0, atol=0)


@pytest.mark.parametrize("n,tag", [(2, "model"), (4, "model"), (4, "2x2")])
def test_packed_chain_is_bit_exact(run, n, tag):
    _, ref, _ = run
    want = ref[f"chain_{n}"] if tag == "model" else ref["chain_2x2"]
    for r in _ranks(run, n):
        np.testing.assert_array_equal(r[f"chain_{tag}"].numpy(), want)
        np.testing.assert_array_equal(r[f"chain_{tag}"].numpy(), r["chain_ref"].numpy())


@pytest.mark.parametrize("n,tag", [(2, "model"), (4, "model"), (4, "2x2")])
def test_chain_transport_is_packed_words_of_jax_bytes(run, n, tag):
    """What each rank hands its collectives: int32 ring hops of exactly
    ici_bytes_per_layer's packed_ring a layer (JAX's number), and one f32
    all-gather of the final output."""
    _, ref, _ = run
    p = n if tag == "model" else 2
    for r in _ranks(run, n):
        transport = r[f"chain_transport_{tag}"]
        rings = [t for t in transport if t["collective"] == "ring"]
        assert [t["bytes"] for t in rings] == r[f"chain_ici_{tag}"] == ref[f"ici_{p}"]
        assert {t["dtype"] for t in rings} == {"torch.int32"}
        floats = [t for t in transport if t["dtype"] != "torch.int32"]
        assert [t["collective"] for t in floats] == ["all_gather"]


def test_ici_bytes_equal_jax():
    from bnn_tpu_torch.inference import ici_bytes_per_layer

    for m, k, p in ((16, 512, 8), (64, 4096, 8), (1, 2048, 8), (16, 512, 2), (8, 4096, 4)):
        assert ici_bytes_per_layer(m, k, p) == jax_ici(m, k, p)
    with pytest.raises(ValueError, match="packed-TP-legal"):
        ici_bytes_per_layer(16, 100, 8)


@pytest.mark.parametrize("n", [2, 4])
def test_guards_raise(run, n):
    for r in _ranks(run, n):
        tp_mesh, tp_fuse, batch = r["predictor_errors"]
        assert "needs a mesh with a >1 model axis" in tp_mesh
        assert "incompatible with fuse=True" in tp_fuse
        assert "must divide evenly" in batch
        chain, ici = r["chain_errors"]
        assert "whole-word" in chain and "packed-TP-legal" in ici
