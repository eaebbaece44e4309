"""The CIFAR-10 trainer (python -m bnn_tpu_torch.examples.cifar10) on the CPU,
against the JAX package's model and Adam.

The CLI runs with --device cpu over a synthetic set cut to 16 training and 8
test images (synthetic_cifar10's sizes patched here; the CLI has no flag for
them), 2 steps an epoch at batch 8, then resumes for one more epoch: the
printed lines, the checkpoint's metadata and Adam's step count hold. The
trainer's model is the JAX package's CIFAR configuration carried by
load_jax_state (BN scales and biases random, see test_torch_training._pair),
and its first step's loss equals the JAX train step's on the same weights and
the same batch within 1e-5."""
import copy
import functools

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

import bnn_tpu
from bnn_tpu.data import augment_crop_flip as jax_augment
from bnn_tpu.ops import BasicInputBinarizer, Identity, XNORWeightBinarizer
from bnn_tpu.parallel import make_train_step as jax_train_step
from bnn_tpu_torch.examples import cifar10
from bnn_tpu_torch.utils import load_checkpoint, load_jax_state
from test_torch_small_batch import _randomized, _write_flat
from test_torch_training import _flat
from test_torch_zoo import jax_model

N_TRAIN, N_TEST, BATCH = 16, 8, 8


def _jax_cifar_model():
    """examples/cifar10.py's model, its state from numpy."""
    def build():
        m = bnn_tpu.models.resnet18(num_classes=10, rngs=nnx.Rngs(0))
        return bnn_tpu.prepare_binary_model(
            m, bnn_tpu.BConfig(BasicInputBinarizer, Identity, XNORWeightBinarizer),
            custom_config_layers_name={"conv1": bnn_tpu.BConfig(),
                                       "fc": bnn_tpu.BConfig()})
    jm = jax_model(build)
    flat = _randomized(_flat(nnx.state(jm)), np.random.RandomState(0))
    _write_flat(jm, flat)
    return jm, flat


def test_trainer_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cifar10.main(["--synthetic", "--epochs", "1"])


def test_trainer_runs_resumes_and_matches_jax(tmp_path, monkeypatch, capsys):
    jm, flat = _jax_cifar_model()
    port = cifar10.build_model(0)
    load_jax_state(port, flat)
    monkeypatch.setattr(cifar10, "build_model", lambda seed: copy.deepcopy(port))
    monkeypatch.setattr(cifar10, "synthetic_cifar10", functools.partial(
        cifar10.synthetic_cifar10, n_train=N_TRAIN, n_test=N_TEST))
    losses = []
    real_step = cifar10.make_train_step

    def recording_step(**kw):
        step = real_step(**kw)

        def run(model, opt, x, y):
            out = step(model, opt, x, y)
            losses.append(float(out["loss"]))
            return out
        return run

    monkeypatch.setattr(cifar10, "make_train_step", recording_step)
    out = str(tmp_path / "ckpt")
    common = ["--synthetic", "--batch-size", str(BATCH), "--out", out,
              "--device", "cpu"]
    cifar10.main(common + ["--epochs", "1"])
    first = capsys.readouterr().out
    assert "Epoch[0][0/2]" in first and "Epoch 0: test acc" in first
    assert "Best accuracy" in first and len(losses) == 2
    cifar10.main(common + ["--epochs", "2", "--resume", out])
    second = capsys.readouterr().out
    assert f"Resumed from {out} at epoch 1" in second and "Epoch[1][0/2]" in second
    assert "Epoch[0]" not in second and len(losses) == 4

    payload = load_checkpoint(out)
    meta = payload["metadata"]
    assert meta["epoch"] == 2 and 0.0 <= meta["best_acc"] <= 100.0
    steps = {float(s["step"]) for s in payload["opt_state"]["state"].values()}
    assert steps == {4.0}
    assert all(np.isfinite(losses))

    # the JAX package's first step on the same weights and the CLI's first batch
    (x_train, y_train), _ = cifar10.synthetic_cifar10()
    rng = np.random.default_rng(0)
    idx = rng.permutation(N_TRAIN)[:BATCH]
    xb = cifar10.normalize(jax_augment(x_train[idx], rng, pad=4))
    jm.train()
    opt = nnx.Optimizer(jm, optax.adam(1e-3), wrt=nnx.Param)
    jloss = float(jax_train_step()(jm, opt, jnp.asarray(xb),
                                   jnp.asarray(y_train[idx]))["loss"])
    assert abs(losses[0] - jloss) <= 1e-5, (losses[0], jloss)
