"""Mesh serving bundles (bnn_tpu_torch.inference.export, format 2) against
bnn_tpu's, in one world of four gloo ranks on the CPU: a data axis of 4, a
data 2 x model 2 mesh with tensor parallelism and a model axis of 4, each
Predictor(mesh=) exported, then loaded in the same world as a fresh
ExportedServer, while the JAX side exports and loads its own on four virtual
devices (tests/test_export.py's round trips).

Tolerances: the loaded bundle bit for bit against the live mesh predictor
(a ragged request of 6 rows over batch 4 included, as JAX's
test_mesh_dp_round_trip), and within rtol/atol 1e-4 of JAX's loaded bundle
(tests/test_torch_export.py's bound for the single-device bundles).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch
from flax import nnx

import test_tp_serving as jts
from bnn_tpu.inference import Predictor as JaxPredictor
from bnn_tpu.inference import export_serving as jax_export
from bnn_tpu.inference import load_serving as jax_load
from bnn_tpu.parallel import make_mesh as jax_mesh
from bnn_tpu_torch.inference import load_serving
from test_torch_small_batch import _randomized, _write_flat
from test_torch_training import _flat
from torch_distributed_worker import start_world

COMMON = dict(batch_size=4, use_pallas=False, dtype=None, fuse=False, space_to_depth=False)
MESHES = {"dp4": (dict(data=4), False), "2x2": (dict(data=2, model=2), True),
          "model4": (dict(data=1, model=4), True)}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rng = np.random.RandomState(0)
    flat = _randomized(_flat(nnx.state(jts._bin_model())), rng)
    x = np.asarray(jts._rand_no_zeros(jax.random.key(0), (8, 8, 8, 3)))
    root = tmp_path_factory.mktemp("mesh_bundle")
    bundles = root / "bundles"
    bundles.mkdir()
    inputs = {"flat": {k: torch.from_numpy(np.array(v)) for k, v in flat.items()},
              "x": _nchw(x), "dir": str(bundles)}
    with start_world("mesh_bundle", 4, root / "world", inputs) as world:
        ref = _jax_side(flat, x, root)
        return world.results(), ref, bundles


def _jax_side(flat, x, root):
    """JAX's bundle of each mesh on the first four virtual devices, loaded:
    its output on the 8 and 6 rows, and its meta."""
    ref = {}
    for tag, (shape, tp) in MESHES.items():
        m = jts._bin_model()
        _write_flat(m, flat)
        pred = JaxPredictor.from_model(
            m, mesh=jax_mesh(devices=jax.devices()[:4], **shape), tensor_parallel=tp,
            **COMMON)
        path = str(root / f"jax_{tag}")
        jax_export(pred, path, input_shape=(8, 8, 3))
        server = jax_load(path)
        ref[tag] = np.asarray(server(x))
        ref[f"{tag}6"] = np.asarray(server(x[:6]))
        ref[f"{tag}_meta"] = json.load(open(os.path.join(path, "meta.json")))
    return ref


def test_ranks_import_no_jax(run):
    assert all(r["jax_imported"] == [] for r in run[0])


@pytest.mark.parametrize("tag", list(MESHES))
def test_loaded_bundle_is_the_live_mesh_predictor(run, tag):
    """Exported, then loaded in the same world as a fresh ExportedServer:
    bit for bit on a full request and on a ragged one (6 rows, padded to 8
    and split into two batches); the live predictor serves as before."""
    for r in run[0]:
        assert r[f"{tag}_loaded"].shape == (8, 16)
        torch.testing.assert_close(r[f"{tag}_loaded"], r[f"{tag}_live"], rtol=0, atol=0)
        torch.testing.assert_close(r[f"{tag}_loaded6"], r[f"{tag}_live6"], rtol=0, atol=0)
        torch.testing.assert_close(r[f"{tag}_live_after"], r[f"{tag}_live"], rtol=0, atol=0)
        torch.testing.assert_close(r[f"{tag}_loaded"], run[0][0][f"{tag}_loaded"],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("tag", list(MESHES))
def test_loaded_bundle_matches_the_jax_bundle(run, tag):
    ranks, ref, _ = run
    for r in ranks:
        np.testing.assert_allclose(r[f"{tag}_loaded"].numpy(), ref[tag], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(r[f"{tag}_loaded6"].numpy(), ref[f"{tag}6"],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tag", list(MESHES))
def test_meta_matches_the_jax_meta(run, tag):
    """nr_devices, the mesh's axes and sizes and the request batch's spec are
    JAX's; the sharded state tensors are the tensor-parallel layers'."""
    ranks, ref, bundles = run
    meta = json.load(open(bundles / tag / "meta.json"))
    jmeta = ref[f"{tag}_meta"]
    assert meta["format_version"] == 2 == jmeta["format_version"]
    assert meta["nr_devices"] == jmeta["nr_devices"] == 4
    for key in ("axis_names", "axis_sizes", "x_spec"):
        assert meta["mesh"][key] == jmeta["mesh"][key], key
    assert ranks[0][f"{tag}_mesh"] == [meta["mesh"]["axis_names"],
                                      meta["mesh"]["axis_sizes"]]
    sharded = {k: v for k, v in meta["mesh"]["state_specs"].items() if v}
    tp = MESHES[tag][1]
    # w_packed, scale and add of each tagged layer, split on model
    assert len(sharded) == 3 * ranks[0][f"{tag}_tp_layers"]
    assert all("model" in v for v in sharded.values())
    jax_sharded = [s for s in jmeta["mesh"]["leaf_specs"] if any(s)]
    assert len(jax_sharded) == len(sharded)
    assert os.path.exists(bundles / tag / "shards.pt") == tp


@pytest.mark.parametrize("tag", list(MESHES))
def test_one_program_with_a_gather_node_per_sharded_layer(run, tag):
    """The program holds a bnn_tpu_torch::mesh_gather node per tensor-parallel
    layer (none on the data-parallel mesh), and each rank holds its shards:
    state_bytes is the rank's, the live predictor's local bytes."""
    for r in run[0]:
        assert r[f"{tag}_gathers"] == r[f"{tag}_tp_layers"]
        loaded, local, logical = r[f"{tag}_bytes"]
        assert loaded == local
        assert (loaded < logical) == MESHES[tag][1]


def test_a_world_of_another_size_is_refused(run):
    """This process is a world of one; the bundles were made for four."""
    with pytest.raises(ValueError, match=r"4 devices.*this world has 1"):
        load_serving(str(run[2] / "2x2"))


def test_platforms_with_a_mesh_is_refused(run):
    for r in run[0]:
        assert "mutually exclusive" in r["platforms_error"]


def test_exportable_gather_is_gather(run):
    for r in run[0]:
        assert r["gather_equal"] == [True] * 6
        assert r["gather_fake_shape"] == [2, 6, 4]
