"""The ImageNet trainer (python -m bnn_tpu_torch.examples.imagenet) on the CPU,
against the JAX package's examples/imagenet.py, at 32x32, batch 8, 2 steps an
epoch, ResNet-18 through imagenet-baseline.yaml's step 0.

At a world of one, in this process: the first loss equals the JAX train
step's on the same weights (carried by load_jax_state, BN statistics and
affine parameters random) and the same first synthetic batch within 1e-5,
as tests/test_torch_cifar10_example.py holds the CIFAR trainer; the
schedules equal the JAX trainer's optax schedules within 1e-7 at every step;
the synthetic batches are its numbers in NCHW; resume, --evaluate and a uint8
--data store run. In a world of two gloo ranks (the cli suite of
tests/torch_distributed_worker.py, whose world
tests/test_torch_serve_parallel.py shares): --model-parallel 2, and --zero1
--accum-steps 2, each give the world of one's first loss within 1e-5; the
GPipe path (--pipeline 2) gives HeteroPipeline.apply's loss on the same
row and batch, the sequential stages' within 1e-5, keeps its BatchNorm
statistics out of the weight decay and resumes its optimizer."""
import argparse
import contextlib
import copy
import importlib.util
import io
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from flax import nnx

import bnn_tpu
from bnn_tpu.models.layers import PreBasicBlock as JaxPreBasicBlock
from bnn_tpu.parallel import make_train_step as jax_train_step
from bnn_tpu_torch.examples import imagenet
from bnn_tpu_torch.utils import load_checkpoint, load_jax_state
from test_torch_small_batch import _randomized, _write_flat
from test_torch_training import _flat
from test_torch_zoo import jax_model
from torch_distributed_worker import (RECIPE, TRAIN_ARGS, cli_inputs,
                                      shared_world)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "jax_imagenet_example", os.path.join(ROOT, "examples", "imagenet.py"))
jax_imagenet = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_imagenet)


def _main(argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        imagenet.main(argv)
    assert not dist.is_initialized()  # the trainer's world of one is gone
    return out.getvalue()


def _record_losses(monkeypatch) -> list:
    """The losses of every train step the trainer takes, in order."""
    recorded = []
    real = imagenet.make_train_step

    def recording(**kw):
        step = real(**kw)

        def run(model, opt, x, y):
            out = step(model, opt, x, y)
            recorded.append(float(out["loss"]))
            return out
        return run

    monkeypatch.setattr(imagenet, "make_train_step", recording)
    return recorded


@pytest.fixture()
def losses(monkeypatch):
    return _record_losses(monkeypatch)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return shared_world("cli", 2, tmp_path_factory, cli_inputs)


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    """The world of one's runs on the trainer's own seeded weights: 1 epoch,
    resumed to 2, evaluated; and 1 epoch with --accum-steps 2."""
    root = tmp_path_factory.mktemp("imagenet")
    out, res = str(root / "ckpt"), {}
    mp = pytest.MonkeyPatch()
    try:
        recorded = _record_losses(mp)
        base = TRAIN_ARGS + ["--recipe", RECIPE]
        res["first"] = _main(base + ["--epochs", "1", "--out", out])
        res["first_losses"] = list(recorded)
        res["first_payload"] = load_checkpoint(out)
        res["resume"] = _main(base + ["--epochs", "2", "--out", out, "--resume", out])
        res["resume_losses"] = recorded[2:]
        res["resumed_payload"] = load_checkpoint(out)
        res["evaluate"] = _main(base + ["--epochs", "2", "--out", out, "--resume", out,
                                        "--evaluate"])
        res["evaluated_payload"] = load_checkpoint(out)
        del recorded[:]
        res["accum"] = _main(base + ["--epochs", "1", "--accum-steps", "2",
                                     "--out", str(root / "accum")])
        res["accum_losses"] = list(recorded)
    finally:
        mp.undo()
    return res


def test_trainer_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        imagenet.main(["--synthetic", "--epochs", "1"])


@pytest.mark.parametrize("flag,value,instead", [
    ("--coordinator", "10.0.0.1:1234", "--rdzv-endpoint"),
    ("--num-hosts", "2", "--nnodes"), ("--host-id", "1", "--node-rank")])
def test_multi_host_flags_name_their_torchrun_flag(capsys, flag, value, instead):
    with pytest.raises(SystemExit):
        imagenet.parse_args(["--synthetic", flag, value])
    err = capsys.readouterr().err
    assert flag in err and f"torchrun {instead}" in err


def test_synthetic_batches_are_the_jax_numbers():
    for (x, y), (jx, jy) in zip(imagenet.synthetic_batches(4, 2, seed=3, size=8),
                                jax_imagenet.synthetic_batches(4, 2, seed=3, size=8)):
        np.testing.assert_array_equal(x, jx.transpose(0, 3, 1, 2))
        np.testing.assert_array_equal(y, jy)
        assert x.flags.c_contiguous and y.dtype == np.int64


@pytest.mark.parametrize("scheduler,warmup", [("cosine", 2), ("cosine", 0),
                                              ("multistep", 2), ("multistep", 0)])
def test_scheduler_is_the_jax_schedule(scheduler, warmup):
    """Linear warmup, then cosine or multistep, milestones shifted by the
    warmup (one inside it dropped): every step within 1e-7 of optax's."""
    args = argparse.Namespace(lr=1e-3, warmup_epochs=warmup, epochs=10,
                              scheduler=scheduler, milestones=[1, 3, 6, 6])
    spe = 3
    ours = imagenet.make_scheduler(args, spe)
    theirs = jax_imagenet.make_scheduler(args, spe)
    for t in range(40):
        assert abs(ours(t) - float(theirs(t))) <= 1e-7, (t, ours(t), float(theirs(t)))


@pytest.mark.parametrize("name,step,decay", [("adamw", 0, 1e-4), ("adamw", 1, 0.0),
                                             ("adam", 0, 0.0), ("sgd", 0, 0.0)])
def test_optimizer_decays_on_step_zero_only(name, step, decay):
    args = argparse.Namespace(optimizer=name, step=step, weight_decay=1e-4)
    opt = imagenet.make_optimizer(args, lambda t: 1e-3)([torch.nn.Parameter(torch.ones(3))])
    assert type(opt).__name__ == {"adamw": "ScheduledAdamW", "adam": "ScheduledAdam",
                                  "sgd": "ScheduledSGD"}[name]
    assert opt.param_groups[0]["weight_decay"] == decay
    assert opt.param_groups[0].get("momentum", 0.9) == 0.9


def test_first_loss_matches_jax(monkeypatch, losses, tmp_path):
    """The trainer's first loss on JAX's weights and first synthetic batch
    against JAX's make_train_step (f32), within 1e-5."""
    chef = bnn_tpu.BinaryChef(RECIPE)
    jm = jax_model(lambda: chef.run_step(bnn_tpu.models.resnet18(
        block_type=JaxPreBasicBlock, activation=bnn_tpu.nn.PReLU,
        rngs=nnx.Rngs(0)), 0))
    flat = _randomized(_flat(nnx.state(jm)), np.random.RandomState(0))
    _write_flat(jm, flat)
    args = imagenet.parse_args(["--arch", "resnet18"])
    port = imagenet.build_model(args, imagenet.bt.BinaryChef(RECIPE))
    load_jax_state(port, flat)
    monkeypatch.setattr(imagenet, "build_model", lambda args, chef: copy.deepcopy(port))
    _main(TRAIN_ARGS + ["--recipe", RECIPE, "--epochs", "1", "--out", str(tmp_path)])
    assert len(losses) == 2 and all(np.isfinite(losses))
    x, y = next(jax_imagenet.synthetic_batches(8, 1, seed=0, size=32))
    jm.train()
    opt = nnx.Optimizer(jm, optax.adamw(1e-3), wrt=nnx.Param)
    jloss = float(jax_train_step()(jm, opt, jnp.asarray(x), jnp.asarray(y))["loss"])
    assert abs(losses[0] - jloss) <= 1e-5, (losses[0], jloss)


def test_world_of_one_trains_and_checkpoints(one):
    text = one["first"]
    assert "==> mesh {'data': 1, 'model': 1} over 1 ranks" in text
    assert "==> optimizer from recipe step 0" in text
    assert "Epoch[0][0/2]" in text and "Epoch[0][1/2]" in text
    assert "images/s" in text and " * Epoch 0: Acc@1" in text
    assert len(one["first_losses"]) == 2 and all(np.isfinite(one["first_losses"]))
    payload = one["first_payload"]
    assert payload["metadata"]["epoch"] == 1 and payload["metadata"]["step"] == 0
    assert {float(s["step"]) for s in payload["opt_state"]["state"].values()} == {2.0}


def test_resume_restores_moments_and_position(one):
    text = one["resume"]
    assert "Epoch[1][0/2]" in text and "Epoch[0]" not in text
    assert "moments reset" not in text and "skipped" not in text
    assert len(one["resume_losses"]) == 2
    payload = one["resumed_payload"]
    assert payload["metadata"]["epoch"] == 2
    assert {float(s["step"]) for s in payload["opt_state"]["state"].values()} == {4.0}


def test_evaluate_trains_nothing(one):
    text = one["evaluate"]
    assert " * Evaluate: Acc@1" in text and "Epoch[" not in text
    before, after = one["resumed_payload"], one["evaluated_payload"]
    assert after["metadata"] == before["metadata"]
    for k, v in before["model"].items():
        assert torch.equal(after["model"][k], v), k


def test_native_loader_on_a_uint8_store(tmp_path, losses):
    rng = np.random.default_rng(0)
    store = tmp_path / "store"
    store.mkdir()
    for split, n in (("train", 16), ("val", 8)):
        np.save(store / f"{split}_x.npy", rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8))
        np.save(store / f"{split}_y.npy", rng.integers(0, 1000, n).astype(np.int32))
    text = _main(["--data", str(store), "--device", "cpu", "-b", "8", "--epochs", "1",
                  "--print-freq", "1", "--recipe", RECIPE, "--out", str(tmp_path / "o")])
    assert "Epoch[0][1/2]" in text and " * Epoch 0: Acc@1" in text
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_ranks_import_no_jax(ranks):
    assert all(r["jax_imported"] == [] for r in ranks)


@pytest.mark.parametrize("tag,ref", [("mp", "first_losses"), ("zero1", "accum_losses")])
def test_gloo_first_loss_is_the_world_of_ones(ranks, one, tag, ref):
    """--model-parallel 2 (a 1x2 mesh) against the world of one; --zero1
    --accum-steps 2 (a 2x1 mesh, each rank's share of each microbatch)
    against the world of one's --accum-steps 2."""
    mesh = "{'data': 1, 'model': 2}" if tag == "mp" else "{'data': 2, 'model': 1}"
    assert f"==> mesh {mesh} over 2 ranks" in ranks[0][f"train_{tag}"]
    assert ranks[1][f"train_{tag}"] == ""
    for r in ranks:
        assert len(r[f"losses_{tag}"]) == 2 and all(np.isfinite(r[f"losses_{tag}"]))
        assert abs(r[f"losses_{tag}"][0] - one[ref][0]) <= 1e-5, (r[f"losses_{tag}"], one[ref])
    assert ranks[0][f"losses_{tag}"] == ranks[1][f"losses_{tag}"]


def test_pipeline_first_loss_and_optimizer(ranks):
    """The GPipe step's loss is HeteroPipeline.apply's on the same row and
    batch, and the sequential stages' on each microbatch within 1e-5; after
    every step the BatchNorm lanes of the row are the forward's statistics
    (AdamW's decay of 0.5 sees the parameter lanes only) and the parameter
    lanes moved; the resumed run restores the flat optimizer state."""
    for r in ranks:
        pipe = r["pipeline"]
        assert len(pipe["losses"]) == 2
        assert pipe["losses"][0] == pipe["apply"][0]
        np.testing.assert_allclose(pipe["losses"], pipe["sequential"], rtol=1e-5, atol=1e-5)
        assert pipe["stats_kept"] == [True, True] and pipe["moved"] == [True, True]
    text, resumed = ranks[0]["train_pp"], ranks[0]["train_pp_resume"]
    assert "==> pipeline mesh {'pipe': 2, 'data': 1} over 2 ranks" in text
    assert "PipeEpoch[0][0/1]" in text and "checkpoint at" in text
    assert "==> pipeline resume restored optimizer state" in resumed
    assert "PipeEpoch[1][0/1]" in resumed and "PipeEpoch[0]" not in resumed
    assert ranks[1]["train_pp"] == ranks[1]["train_pp_resume"] == ""
