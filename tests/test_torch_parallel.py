"""The port's mesh, sharding rules, data- and tensor-parallel training and
ZeRO-1 (bnn_tpu_torch.parallel.mesh, .trainstep) against bnn_tpu's, with
four gloo ranks on the CPU.

One world of four ranks (tests/torch_distributed_worker.py, suite
'parallel') runs every case; the JAX side runs here, on the first four
devices of the virtual CPU mesh, while the ranks work. Each test asserts
one part. Tolerances are JAX's own tests': the data-parallel step loss rtol
1e-5 and parameters rtol 1e-4 / atol 1e-5 (tests/test_parallel.py:112-117),
the tensor-parallel forward rtol 1e-4 / atol 1e-5. The tensor-parallel
gradient and the ZeRO-1 steps run in float64, as the port's other
multi-step optimizer comparisons do: in f32 a noise-level gradient (an
output scale's under a train-mode BN) becomes a whole Adam step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

import bnn_tpu
import bnn_tpu_torch as bt
from bnn_tpu.ops import binarizers as jops
from bnn_tpu.parallel import make_mesh as jax_mesh
from bnn_tpu.parallel import make_train_step as jax_train_step
from bnn_tpu.parallel import shard_batch as jax_shard_batch
from bnn_tpu.parallel import shard_model as jax_shard_model
from bnn_tpu.parallel import shard_optimizer_zero1 as jax_zero1
from bnn_tpu.parallel import shard_state as jax_shard_state
from bnn_tpu_torch.utils import jax_to_port
from test_parallel import make_model as jax_make_model
from test_torch_small_batch import _randomized, _write_flat
from test_torch_training import _flat
from torch_distributed_worker import make_model, start_world

WORLD = 4
# JAX -> port axis order of a kernel (and a conv-layout w_packed) of each rank
_KP = {4: (3, 2, 0, 1), 3: (2, 1, 0), 2: (1, 0)}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _devices():
    return jax.devices()[:WORLD]


def port_name(jname, port_names):
    """The port's state_dict name of a JAX leaf path."""
    prefix, _, leaf = jname.rpartition(".")
    for cand in (leaf, bt.utils.jax_weights._LEAF.get(leaf)):
        name = f"{prefix}.{cand}" if prefix else cand
        if cand and name in port_names:
            return name
    raise KeyError(jname)


def port_axis(leaf, ndim, jaxis):
    """The port's axis of JAX axis ``jaxis`` of a leaf."""
    if jaxis is None:
        return None
    if leaf == "alpha":  # JAX's (C,) output scale is the port's [1, C, 1, 1]
        return 1
    if (leaf in ("kernel", "w_packed") and ndim in (3, 4)) or (leaf == "kernel" and ndim == 2):
        return _KP[ndim].index(jaxis)
    return jaxis


def _jpath(path) -> str:
    """A JAX state path as its dotted name (``bnn_tpu/parallel/mesh.py``'s
    ``_path_str``)."""
    parts = [str(getattr(p, "key", getattr(p, "name", getattr(p, "idx", p)))) for p in path]
    if parts and parts[-1] == "value":
        parts.pop()
    return ".".join(parts)


def _jax_axis(spec, axis):
    hits = [d for d, e in enumerate(spec)
            if e == axis or (isinstance(e, tuple) and axis in e)]
    return hits[0] if hits else None


def _port_axis(spec, axis):
    hits = [d for d, e in enumerate(spec)
            if e == axis or (isinstance(e, list) and axis in e)]
    return hits[0] if hits else None


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Start the ranks, compute JAX's side meanwhile, return both."""
    rng = np.random.RandomState(0)
    jm = jax_make_model(0)
    flat = _randomized(_flat(nnx.state(jm)), rng)
    x = rng.randn(16, 8, 8, 3).astype(np.float32)
    y = rng.randint(0, 10, 16).astype(np.int32)
    x32 = rng.randn(32, 8, 8, 3).astype(np.float32)
    y32 = rng.randint(0, 10, 32).astype(np.int32)
    w = rng.randn(3, 3, 32, 64).astype(np.float32)
    inputs = {"flat": {k: torch.from_numpy(v) for k, v in flat.items()},
              "x": _nchw(x), "y": torch.from_numpy(y).long(),
              "x32": _nchw(x32), "y32": torch.from_numpy(y32).long(),
              "xnor_w": torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))}
    world = start_world("parallel", WORLD, tmp_path_factory.mktemp("parallel"), inputs)
    with world:
        ref = _jax_side(flat, x, y, w)
        return world.results(), ref, flat


def _jax_side(flat, x, y, w):
    ref = {}
    mesh4 = jax_mesh(devices=_devices())
    mesh22 = jax_mesh(data=2, model=2, devices=_devices())
    ref["shapes"] = [dict(jax_mesh(devices=_devices()).shape),
                     dict(jax_mesh(model=2, devices=_devices()).shape),
                     dict(mesh22.shape)]
    for tag, mesh in (("dp", mesh4), ("tp", mesh22)):
        xs = jax_shard_batch(jnp.arange(16), mesh)
        ref[f"rows_{tag}"] = {s.device.id: np.asarray(s.data) for s in xs.addressable_shards}

    def built():
        m = jax_make_model(0)
        _write_flat(m, flat)
        return m

    # the rules on the zoo's shapes
    for tag, min_size in (("1024", 1024), ("64", 64)):
        qat = bnn_tpu.prepare_binary_model(
            bnn_tpu.models.resnet18(num_classes=16, rngs=nnx.Rngs(0)),
            bnn_tpu.BConfig(jops.BasicInputBinarizer, jops.BasicScaleBinarizer,
                            jops.XNORWeightBinarizer),
            ignore_layers_name=["_first_", "_last_"])
        qat.eval()
        for kind in ("qat", "dep"):
            if kind == "dep":
                qat = bnn_tpu.inference.deploy(qat, use_pallas=False)
            leaves = jax.tree_util.tree_leaves_with_path(
                jax_shard_state(nnx.state(qat), mesh22, min_size=min_size))
            ref[f"rules_{kind}_{tag}"] = {_jpath(p): x for p, x in leaves
                                          if hasattr(x, "sharding")}

    # the data-parallel step: single device and over four devices
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    for tag, dp in (("single", False), ("dp", True)):
        m = built()
        m.train()
        opt = nnx.Optimizer(m, optax.sgd(0.1), wrt=nnx.Param)
        xb, yb = xj, yj
        if dp:
            jax_shard_model(m, mesh4)
            jax_shard_model(opt, mesh4)
            xb, yb = jax_shard_batch((xj, yj), mesh4)
        ref[f"{tag}_loss"] = float(jax_train_step()(m, opt, xb, yb)["loss"])
        ref[f"{tag}_state"] = _flat(nnx.state(m))

    # the tensor-parallel forward, and the train-mode gradient in float64
    for tag, min_size in (("1024", 1024), ("64", 64)):
        m = built()
        m.eval()
        jax_shard_model(m, mesh22, min_size=min_size)
        ref[f"tp_fwd_{tag}"] = np.asarray(nnx.jit(lambda mm, v: mm(v))(
            m, jax_shard_batch(xj, mesh22)))
    with jax.enable_x64(True):
        m = built()
        bnn_tpu.utils.cast_floats(m, jnp.float64)
        m.train()

        def loss_fn(mm):
            logits = mm(xj.astype(jnp.float64))
            return optax.softmax_cross_entropy_with_integer_labels(logits, yj).mean()

        loss, grads = nnx.value_and_grad(loss_fn)(m)
        ref["tp_loss"] = float(loss)
        ref["tp_grads"] = _flat(grads)
    ref["xnor"] = np.asarray(jops.XNORWeightBinarizer()(jnp.asarray(w)))

    # ZeRO-1, data-only and composed with TP: the dimension each moment is
    # cut on, and two AdamW steps in float64 (the port's arms, on the same
    # weights and batch)
    with jax.enable_x64(True):
        for tag, mesh in (("dp", mesh4), ("tp", mesh22)):
            m = built()
            bnn_tpu.utils.cast_floats(m, jnp.float64)
            m.train()
            opt = nnx.Optimizer(m, optax.adamw(1e-3, weight_decay=1e-4), wrt=nnx.Param)
            min_size = 64 if tag == "tp" else 1024
            jax_shard_model(m, mesh, min_size=min_size)
            jax_shard_model(opt, mesh, min_size=min_size)
            jax_zero1(opt, mesh, min_size=64)
            dims = {}
            for p, leaf in jax.tree_util.tree_leaves_with_path(nnx.state(opt)):
                keys = _jpath(p).split(".")
                if "mu" not in keys or not hasattr(leaf, "sharding"):
                    continue
                jname = ".".join(keys[keys.index("mu") + 1:])
                spec = tuple(getattr(leaf.sharding, "spec", ()))
                dims[jname] = (_jax_axis(spec, "data"), leaf.ndim)
            ref[f"zero1_{tag}"] = dims
            xb, yb = jax_shard_batch((xj.astype(jnp.float64), yj), mesh)
            step = jax_train_step()
            ref[f"zero1_losses_{tag}"] = [float(step(m, opt, xb, yb)["loss"]) for _ in range(2)]
            ref[f"zero1_state_{tag}"] = _flat(nnx.state(m))

    # the loader's host shards (test_distributed.py's check, four processes)
    ref["loader"] = [_jax_epoch(r) for r in range(WORLD)]
    return ref


def _jax_epoch(rank):
    loader = bnn_tpu.data.NativeDataLoader(
        np.zeros((32, 8, 8, 3), np.uint8), np.zeros((32,), np.int64), batch_size=4,
        seed=0, process_index=rank, process_count=WORLD, pad=0, flip=False)
    loader.set_epoch(3)
    return loader._epoch_indices()


def test_ranks_import_no_jax(run):
    ranks, _, _ = run
    assert all(r["jax_imported"] == [] for r in ranks)


def test_mesh_shapes_and_guards(run):
    ranks, ref, _ = run
    for r in ranks:
        assert r["shapes"] == ref["shapes"]
        assert r["mesh_errors"][0] == "mesh 3x1 != 4 devices"
        assert "model axis of 3" in r["mesh_errors"][1]
        assert r["mesh_errors"][2] == "mesh 2x4 != 4 devices"


def test_shard_batch_rows_match_jax(run):
    ranks, ref, _ = run
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(r["rows_dp"].numpy(), ref["rows_dp"][rank])
        np.testing.assert_array_equal(r["rows_tp"].numpy(), ref["rows_tp"][rank])
        np.testing.assert_array_equal(r["host_rows"].numpy(), np.arange(16)[rank::WORLD])
        assert r["rows_spec"] == [["data"], ["data"]]


@pytest.mark.parametrize("kind", ["qat", "dep"])
@pytest.mark.parametrize("min_size", ["1024", "64"])
def test_rules_choose_jax_axis_under_the_layout_map(run, kind, min_size):
    """Each leaf of a QAT and a deployed ResNet-18 is split on the port's
    axis that JAX's choice maps to: OIHW / (O, I) / conv-layout w_packed
    out-channels first, GEMM-layout w_packed and 1-D leaves as in JAX."""
    ranks, ref, _ = run
    port = ranks[0][f"rules_{kind}_{min_size}"]
    want, sharded = {}, 0
    for jname, arr in ref[f"rules_{kind}_{min_size}"].items():
        name = port_name(jname, port)
        leaf = jname.rsplit(".", 1)[-1]
        jaxis = _jax_axis(tuple(arr.sharding.spec), "model")
        want[name] = port_axis(leaf, arr.ndim, jaxis)
        sharded += jaxis is not None
    got = {k: _port_axis(v, "model") for k, v in port.items() if k in want}
    assert got == want
    assert sharded > 10
    # leaves only the port has (BatchNorm's counters) stay whole
    assert all(not v for k, v in port.items() if k not in want)


def test_rules_honor_other_axes(run):
    """A rule naming the data axis shards (JAX's FSDP-style test)."""
    ranks, _, _ = run
    custom = ranks[0]["rules_custom"]
    assert custom["3.weight"] == ["data"]
    assert custom["0.weight"] == []  # 864 elements, under the gate
    assert custom["1.weight"] == []


def test_dp_step_matches_jax(run):
    ranks, ref, _ = run
    np.testing.assert_allclose(ref["dp_loss"], ref["single_loss"], rtol=1e-5)
    model = make_model(*_bt_bc())
    for r in ranks:
        np.testing.assert_allclose(float(r["dp_loss"]), ref["dp_loss"], rtol=1e-5)
        for tag in ("dp", "single"):
            want = jax_to_port(model, {k: v for k, v in ref[f"{tag}_state"].items()})
            for k, v in r["dp_params"].items():
                np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4,
                                           atol=1e-5, err_msg=k)


def test_dp_batchnorm_statistics_are_the_global_batch(run):
    ranks, ref, _ = run
    model = make_model(*_bt_bc())
    want = jax_to_port(model, ref["single_state"])
    for r in ranks:
        for k in ("1.running_mean", "1.running_var", "4.running_mean", "4.running_var"):
            np.testing.assert_allclose(r["dp_state"][k].numpy(), want[k].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("min_size", ["1024", "64"])
def test_tp_forward_matches_jax(run, min_size):
    ranks, ref, _ = run
    for r in ranks:
        np.testing.assert_allclose(r[f"tp_fwd_{min_size}"].numpy(),
                                   ref[f"tp_fwd_{min_size}"], rtol=1e-4, atol=1e-5)
    specs = ranks[0][f"tp_specs_{min_size}"]
    assert specs["3.weight"] == ["model"]
    if min_size == "64":  # conv1, the BN of 64, the classifier too
        assert specs["0.weight"] == ["model"] and specs["8.weight"] == ["model"]
        assert specs["4.weight"] == ["model"] and specs["4.running_mean"] == []


def test_tp_gradient_matches_jax(run):
    """A 2x2 mesh, every leaf of 64 elements split: the whole gradient of
    the train-mode loss (BatchNorm over the data axis, each split layer's
    gather backward the slice) against JAX's single device, float64."""
    ranks, ref, _ = run
    model = make_model(*_bt_bc())
    want = jax_to_port(model, ref["tp_grads"])
    for r in ranks:
        # the step's loss is f32, as the single-device step's
        np.testing.assert_allclose(float(r["tp_loss"]), ref["tp_loss"], rtol=1e-6)
        assert set(r["tp_grads"]) == set(want)
        for k, g in r["tp_grads"].items():
            scale = max(float(want[k].abs().max()), 1e-3)
            np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-4,
                                       atol=1e-5 * scale, err_msg=k)


def test_xnor_alpha_invariant_under_out_channel_sharding(run):
    ranks, ref, _ = run
    want = torch.from_numpy(np.ascontiguousarray(ref["xnor"].transpose(3, 2, 0, 1)))
    for rank, r in enumerate(ranks):
        assert r["xnor_spec"] == ["model"]
        torch.testing.assert_close(r["xnor_local"], r["xnor_slice"], rtol=0, atol=0)
        i = rank % 2
        np.testing.assert_allclose(r["xnor_local"].numpy(), want[i * 32:(i + 1) * 32].numpy(),
                                   rtol=1e-6)


@pytest.mark.parametrize("tag", ["dp", "tp"])
def test_zero1_cuts_jax_dimension(run, tag):
    """The dimension each moment is cut on is JAX's under the layout map,
    composed with the tensor-parallel split on the 2x2 mesh; each moment
    is a 1/n shard."""
    ranks, ref, _ = run
    got = ranks[0][f"zero1_dims_{tag}"]
    names = set(make_model(*_bt_bc()).state_dict())
    want = {}
    for jname, (jaxis, ndim) in ref[f"zero1_{tag}"].items():
        if jaxis is not None:
            want[port_name(jname, names)] = port_axis(jname.rsplit(".", 1)[-1], ndim, jaxis)
    assert got == want and len(want) >= 4
    n = 4 if tag == "dp" else 2
    shapes = ranks[0][f"zero1_moment_shapes_{tag}"]
    full = {k: v.shape for k, v in ranks[0][f"zero1_params_{tag}"].items()}
    for k, d in got.items():
        tp = 2 if tag == "tp" and k in ("0.weight", "3.weight", "8.weight") else 1
        expect = list(full[k])
        expect[0] //= tp
        expect[d] //= n
        assert shapes[k] == expect, k


@pytest.mark.parametrize("tag", ["dp", "tp"])
def test_zero1_two_steps_equal_unsharded(run, tag):
    """Two ZeRO-1 AdamW steps (float64) against JAX's ZeRO-1 steps on the
    same mesh, weights and batch, and against the port's unsharded step."""
    ranks, ref, _ = run
    want = jax_to_port(make_model(*_bt_bc()), ref[f"zero1_state_{tag}"])
    for r in ranks:
        np.testing.assert_allclose(r[f"zero1_losses_{tag}"], ref[f"zero1_losses_{tag}"],
                                   rtol=1e-6)
        np.testing.assert_allclose(r[f"zero1_losses_{tag}"], r["zero1_ref_losses"], rtol=1e-6)
        assert set(r[f"zero1_params_{tag}"]) <= set(want)
        for k, v in r[f"zero1_params_{tag}"].items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)
            np.testing.assert_allclose(v.numpy(), r["zero1_ref_params"][k].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


def test_zero1_checkpoint_roundtrip_continuity(run):
    """tests/test_parallel.py:428 on four ranks: the sharded run saved
    (gathered, rank 0 writes), restored into a fresh sharded pair, resumed:
    the loss trajectory continues the uninterrupted one."""
    ranks, _, _ = run
    for r in ranks:
        assert r["ckpt_skipped"] == []
        np.testing.assert_allclose(r["ckpt_resumed"], r["ckpt_full"][6:], rtol=2e-4)
        assert np.isfinite(r["ckpt_full"]).all()
    saved = ranks[0]["ckpt_saved_shapes"]
    # the moments are saved whole
    assert [32, 3, 3, 3] in saved.values() and [64, 32, 3, 3] in saved.values()


def test_save_checkpoint_is_a_collective(run):
    """A placed save returns on every rank only once rank 0 has put the
    file in place, and a write that fails on rank 0 raises on every rank."""
    ranks, _, _ = run
    assert all(r["ckpt_in_place"] for r in ranks)
    assert ranks[0]["ckpt_failed_write"] == "NotADirectoryError"
    assert all(r["ckpt_failed_write"] == "RuntimeError" for r in ranks[1:])


def test_prefetch_host_shards_are_disjoint_and_cover(run):
    ranks, ref, _ = run
    seen = set()
    for rank, r in enumerate(ranks):
        idx = r["loader_indices"].numpy()
        np.testing.assert_array_equal(np.sort(idx), np.sort(ref["loader"][rank]))
        np.testing.assert_array_equal(np.sort(r["loader_labels"].numpy()), np.sort(idx))
        assert r["loader_spec"] == ["data"]
        assert seen.isdisjoint(idx.tolist())
        seen |= set(idx.tolist())
        for k, rows in enumerate(r["prefetch_rows"]):
            np.testing.assert_array_equal(rows.numpy(), np.arange(8)[2 * rank:2 * rank + 2]
                                          * 10 + k)
    assert seen == set(range(32))


def _bt_bc():
    from bnn_tpu_torch.ops import binarizers as tops

    return bt, bt.BConfig(tops.BasicInputBinarizer, tops.BasicScaleBinarizer,
                          tops.XNORWeightBinarizer)
