"""The port's GPipe pipelines (bnn_tpu_torch.parallel.pipeline and
.hetero_pipeline) against bnn_tpu's, with four gloo ranks on the CPU.

One world of four ranks (tests/torch_distributed_worker.py, suite
'pipeline') runs every case: the homogeneous pipeline over pipe=4 and over
pipe=2 x data=2, the heterogeneous one over pipe=4 (the ResNet-like binary
stages, float stages, BatchNorm stages in train mode) and, with the
BatchNorm stages merged in pairs, over pipe=2 x data=2. The JAX side runs
here on the first four devices of the virtual CPU mesh. f32 throughout:
forwards rtol 1e-5, gradients rtol 1e-5 (JAX's atol 1e-5) against JAX's
pipeline and the sequential stages; the binary stages' gradients with
JAX's own criteria (cosine > 0.999, relative L2 < 0.05), since an STE
boundary flips under another summation order.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

import bnn_tpu
import bnn_tpu_torch as bt
import test_hetero_pipeline as jhp
import test_parallel as jtp
from bnn_tpu.parallel import (HeteroPipeline, make_pipeline_mesh, make_stage_fn,
                              pipeline_apply, shard_stacked_state, stack_stage_states)
from bnn_tpu_torch.utils import jax_to_port
from test_torch_training import _flat
from torch_distributed_worker import _hetero_stages, _merge_pairs, _port, start_world

WORLD = 4


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _tensors(flat):
    return {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}


def _float_stages():
    """tests/test_hetero_pipeline.py's float stages."""
    nn, rngs = bnn_tpu.nn, nnx.Rngs(0)
    return [nn.Sequential(nn.Conv2d(3, 8, 3, padding=1, rngs=rngs), nn.Tanh()),
            nn.Sequential(nn.Conv2d(8, 16, 3, stride=2, padding=1, rngs=rngs), nn.Tanh()),
            nn.Sequential(nn.Conv2d(16, 32, 3, stride=2, padding=1, rngs=rngs), nn.Tanh()),
            nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(32, 5, rngs=rngs))]


def _bn_stages():
    return jhp.TestPipelinedBNStats._stages(jhp.TestPipelinedBNStats())


def _jstages(name):
    return {"resnet": lambda: list(jhp._resnet_like_stages()), "float": _float_stages,
            "bn": _bn_stages}[name]()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rng = np.random.RandomState(0)
    lin = jtp.TestPipelineParallel._stages(4)
    lin_x = rng.randn(16, 16).astype(np.float32)
    inputs = {"lin_x": torch.from_numpy(lin_x),
              "lin_flats": [_tensors(_flat(nnx.state(s))) for s in lin]}
    xs, jstages = {}, {}
    for name in ("resnet", "float", "bn"):
        jstages[name] = _jstages(name)
        inputs[f"h_{name}_flats"] = [_tensors(_flat(nnx.state(s))) for s in jstages[name]]
        shape = (8, 8, 8, 3) if name == "bn" else (8, 16, 16, 3)
        xs[name] = (rng.randn(*shape) * (1.0 if name == "bn" else 0.5)).astype(np.float32)
        inputs[f"h_{name}_x"] = _nchw(xs[name])
        inputs[f"h_{name}_y"] = torch.from_numpy(rng.randint(0, 5, 8)).long()
    xs["train"] = (rng.randn(8, 16, 16, 3) * 0.5).astype(np.float32)
    inputs["h_resnet_x_train"] = _nchw(xs["train"])
    world = start_world("pipeline", WORLD, tmp_path_factory.mktemp("pipeline"), inputs)
    with world:
        ref = _jax_side(lin, lin_x, xs, inputs, jstages)
        return world.results(), ref, inputs


def _jax_side(lin, lin_x, xs, inputs, jstages):
    dev = jax.devices()[:WORLD]
    ref = {}
    x = jnp.asarray(lin_x)
    for pipe, data in ((4, 1), (2, 2)):
        mesh = make_pipeline_mesh(pipe=pipe, data=data, devices=dev)
        stages = lin[:pipe]
        host = stack_stage_states(stages)
        stacked = shard_stacked_state(host, mesh)
        fn = make_stage_fn(stages[0])
        n_micro = 4 // data

        def loss(st):
            y = pipeline_apply(fn, st, x, mesh=mesh, n_microbatches=n_micro)
            return jnp.sum(y ** 2), y

        (_, y), g = jax.value_and_grad(loss, has_aux=True)(stacked)
        ref[f"lin_y_{pipe}x{data}"] = np.asarray(y)
        ref[f"lin_grads_{pipe}x{data}"] = _flat(g)

        def seq_loss(st):
            h = x
            for i in range(pipe):
                h = fn(jax.tree.map(lambda p: p[i], st), h)
            return jnp.sum(h ** 2), h

        (_, ref[f"lin_seq_{pipe}x{data}"]), g = jax.value_and_grad(seq_loss, has_aux=True)(host)
        ref[f"lin_seq_grads_{pipe}x{data}"] = _flat(g)

    # the binary stages' gradient from the sequential stages: JAX's own
    # tests hold its pipeline to them, and compiling the pipeline's
    # backward over four binary branches costs most of a minute here
    stages = jstages["resnet"]
    xj, yj = jnp.asarray(xs["resnet"]), jnp.asarray(inputs["h_resnet_y"].numpy())

    def seq_loss(sts, v):
        logits = _sequential(sts, v)
        return optax.softmax_cross_entropy_with_integer_labels(logits, yj).mean(), logits

    (lv, logits), grads = nnx.jit(nnx.value_and_grad(seq_loss, has_aux=True))(stages, xj)
    ref["h_resnet_4x1_loss"] = float(lv)
    ref["h_resnet_4x1_grads"] = [_flat(g) for g in grads]
    ref["h_resnet_4x1_y"] = ref["h_resnet_4x1_seq"] = np.asarray(logits)
    ref["h_resnet_4x1_train_loss0"] = float(nnx.jit(seq_loss)(stages, jnp.asarray(xs["train"]))[0])
    ref["h_resnet_4x1_io"] = HeteroPipeline(stages, x_shape=tuple(xj.shape[1:]),
                                            mesh=make_pipeline_mesh(pipe=4, devices=dev)).io_shapes

    for name, pipe, data in (("float", 4, 1), ("bn", 4, 1), ("bn", 2, 2)):
        key = f"h_{name}_{pipe}x{data}"
        stages = jstages[name]
        if pipe == 2:
            stages = [bnn_tpu.nn.Sequential(*stages[i:i + 2]) for i in (0, 2)]
        xj = jnp.asarray(xs[name])
        mesh = make_pipeline_mesh(pipe=pipe, data=data, devices=dev)
        hp = HeteroPipeline(stages, x_shape=tuple(xj.shape[1:]), mesh=mesh)
        ref[key + "_io"] = hp.io_shapes
        if name == "bn":
            _, new = hp.apply(hp.flat_params, xj, n_microbatches=4 // data, return_state=True)
            ref[key + "_states"] = [_flat(s) for s in hp.unflatten_stage_states(new)]
            continue
        y = jnp.asarray(inputs[f"h_{name}_y"].numpy())

        def loss(f):
            logits = hp.apply(f, xj, n_microbatches=2)
            return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean(), logits

        (lv, logits), g = jax.value_and_grad(loss, has_aux=True)(hp.flat_params)
        ref[key + "_loss"] = float(lv)
        ref[key + "_grads"] = [_flat(s) for s in hp.unflatten_stage_states(g)]
        ref[key + "_y"] = np.asarray(logits)
        ref[key + "_seq"] = np.asarray(_sequential(stages, xj))
    return ref


def _sequential(stages, x):
    for s in stages:
        x = s(x)
    return x


def test_ranks_import_no_jax(run):
    ranks, _, _ = run
    assert all(r["jax_imported"] == [] for r in ranks)


@pytest.mark.parametrize("shape", ["4x1", "2x2"])
def test_pipeline_forward_matches_jax_and_sequential(run, shape):
    ranks, ref, _ = run
    for r in ranks:
        for key in (f"lin_y_{shape}", f"lin_y_whole_{shape}"):
            np.testing.assert_allclose(r[key].numpy(), ref[f"lin_y_{shape}"], rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(r[key].numpy(), ref[f"lin_seq_{shape}"], rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("shape", ["4x1", "2x2"])
def test_pipeline_backward_matches_jax(run, shape):
    """tests/test_parallel.py:314's oracle: the gradient reaching each
    rank's stage row is the stacked gradient's row, from JAX's pipeline and
    from the sequential stages (with a data axis, summed over it)."""
    ranks, ref, inputs = run
    stage = bt.layers.Linear(16, 16, bconfig=_port()[1])
    for r in ranks:
        s = r[f"lin_stage_{shape}"]
        for tag in ("lin_grads", "lin_seq_grads"):
            want = jax_to_port(stage, {k: v[s] for k, v in ref[f"{tag}_{shape}"].items()})
            for k, g in r[f"lin_grads_{shape}"].items():
                np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-5, atol=1e-5,
                                           err_msg=f"{tag} {k}")


def test_pipeline_guards(run):
    ranks, _, _ = run
    for r in ranks:
        assert "8 stacked stages != 4-way 'pipe'" in r["lin_errors"][0]
        assert "must divide over the data axis" in r["lin_errors"][1]


def _nchw_shape(shape):
    return list(shape) if len(shape) != 3 else [shape[2], shape[0], shape[1]]


@pytest.mark.parametrize("name", ["resnet", "float", "bn"])
def test_hetero_io_shapes_match_jax(run, name):
    ranks, ref, _ = run
    want = [[_nchw_shape(i), _nchw_shape(o)] for i, o in ref[f"h_{name}_4x1_io"]]
    assert ranks[0][f"h_{name}_4x1_io"] == want


@pytest.mark.parametrize("name", ["resnet", "float"])
def test_hetero_forward_matches_jax_and_sequential(run, name):
    ranks, ref, _ = run
    for r in ranks:
        for n_micro in ("", "4"):  # 2 and 4 microbatches
            y = r[f"h_{name}_4x1_y{n_micro}"].numpy()
            np.testing.assert_allclose(y, ref[f"h_{name}_4x1_y"], rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(y, ref[f"h_{name}_4x1_seq"], rtol=1e-5, atol=1e-5)


def _stage_grads(r, ref, name, inputs):
    s = r[f"h_{name}_4x1_stage"]
    module = _hetero_stages(*_port(), name, inputs[f"h_{name}_flats"])[s]
    want = jax_to_port(module, ref[f"h_{name}_4x1_grads"][s])
    params = {k for k, _ in module.named_parameters()}
    got = {k: v for k, v in r[f"h_{name}_4x1_grads"].items() if k in params}
    assert set(got) == params
    return got, want


def test_hetero_float_gradients_match_jax(run):
    ranks, ref, inputs = run
    for r in ranks:
        np.testing.assert_allclose(float(r["h_float_4x1_loss"]), ref["h_float_4x1_loss"],
                                   rtol=1e-5)
        got, want = _stage_grads(r, ref, "float", inputs)
        for k, g in got.items():
            np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def test_hetero_binary_gradients_match_jax(run):
    """Against JAX's sequential stages (which JAX's own tests hold its
    pipeline to)."""
    ranks, ref, inputs = run
    for r in ranks:
        np.testing.assert_allclose(float(r["h_resnet_4x1_loss"]), ref["h_resnet_4x1_loss"],
                                   rtol=1e-5)
        got, want = _stage_grads(r, ref, "resnet", inputs)
        gp = torch.cat([got[k].reshape(-1) for k in sorted(got)]).double()
        gs = torch.cat([want[k].reshape(-1) for k in sorted(got)]).double()
        cos = float(gp @ gs / (gp.norm() * gs.norm()))
        assert cos > 0.999, cos
        assert float((gp - gs).norm() / gs.norm()) < 0.05


def test_hetero_trains_on_the_flat_row(run):
    """Adam on each rank's row: the loss falls, padding lanes stay 0, the
    first loss is JAX's on the same weights."""
    ranks, ref, _ = run
    for r in ranks:
        losses = r["h_resnet_4x1_train_losses"]
        np.testing.assert_allclose(losses[0], ref["h_resnet_4x1_train_loss0"], rtol=1e-5)
        assert losses[-1] < losses[0]
        assert not r["h_resnet_4x1_pad"].any()


def test_hetero_state_round_trip(run):
    ranks, ref, _ = run
    for r in ranks:
        np.testing.assert_allclose(r["h_resnet_4x1_rebuilt"].numpy(), ref["h_resnet_4x1_seq"],
                                   rtol=1e-5, atol=1e-5)
        assert r["h_resnet_4x1_per_rank_row"][0] == 1


def test_hetero_guards(run):
    ranks, _, _ = run
    for r in ranks:
        assert "declared x_shape" in r["h_resnet_4x1_errors"][0]
        assert "mesh pipe axis 4 != 3 stages" in r["h_resnet_4x1_errors"][1]


def _sequential_stats(stages, x, n_micro, n_data):
    """Each data replica runs its rows of every microbatch through the
    stages in order; the replicas' statistics are averaged."""
    replicas = []
    micro = x.shape[0] // n_micro
    local = micro // n_data
    for d in range(n_data):
        sts = copy.deepcopy(stages)
        for s in sts:
            s.train()
        for mb in x.reshape(n_micro, micro, *x.shape[1:]):
            h = mb[d * local:(d + 1) * local]
            for s in sts:
                h = s(h)
        replicas.append([s.state_dict() for s in sts])
    return [{k: (torch.stack([rep[i][k] for rep in replicas]).double().mean(0)
                 if rep_v.is_floating_point() else rep_v)
             for k, rep_v in replicas[0][i].items()} for i in range(len(stages))]


@pytest.mark.parametrize("shape", ["4x1", "2x2"])
def test_hetero_batchnorm_statistics(run, shape):
    """Running statistics committed per real microbatch in schedule order:
    the sequential per-microbatch loop's (each data replica over its rows,
    averaged over the data axis), and JAX's; parameters unchanged."""
    ranks, ref, inputs = run
    bt_, bc = _port()
    stages = _hetero_stages(bt_, bc, "bn", inputs["h_bn_flats"])
    n_data = 1 if shape == "4x1" else 2
    if n_data == 2:
        stages = _merge_pairs(stages)
    want = _sequential_stats(stages, inputs["h_bn_x"], 4 // n_data, n_data)
    for r in ranks:
        states, old = r[f"h_bn_{shape}_states"], r[f"h_bn_{shape}_old"]
        for i, (st, w) in enumerate(zip(states, want)):
            jw = jax_to_port(stages[i], ref[f"h_bn_{shape}_states"][i])
            for k, v in st.items():
                np.testing.assert_allclose(v.double().numpy(), w[k].double().numpy(),
                                           rtol=1e-5, atol=1e-6, err_msg=f"stage {i} {k}")
                if k in jw:
                    np.testing.assert_allclose(v.numpy(), jw[k].numpy(), rtol=1e-5,
                                               atol=1e-6, err_msg=f"JAX stage {i} {k}")
                if not k.endswith(("running_mean", "running_var", "num_batches_tracked")):
                    torch.testing.assert_close(v, old[i][k], rtol=0, atol=0)
            moved = [k for k in st if k.endswith("running_mean")]
            assert not moved or not all(torch.equal(st[k], old[i][k]) for k in moved)
