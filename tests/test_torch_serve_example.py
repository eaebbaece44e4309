"""The port's serve CLI (python -m bnn_tpu_torch.examples.serve) on the CPU, at
32x32 with 10 classes: batched requests, a continuous stream, and serving a
checkpoint, whose logits equal the JAX package's serve path on the same
weights (carried by load_jax_state)."""
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import bnn_tpu
from bnn_tpu.inference import Predictor as JPredictor
from bnn_tpu.ops import binarizers as jops
from bnn_tpu_torch.examples import serve
from bnn_tpu_torch.utils import load_jax_state, save_checkpoint
from test_torch_serving import _flat, _nchw, _randomized, _write_flat

ARGS = ["--device", "cpu", "--num-classes", "10", "--size", "32",
        "--batch-size", "4", "--requests", "2"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_batched_requests(capsys):
    serve.main(ARGS)
    out = capsys.readouterr().out.splitlines()
    assert re.match(r"serving state: [0-9.]+ MB, batch 4, plain PyTorch", out[0])
    assert [line.split(":")[0] for line in out[1:]] == ["request 0", "request 1"]


def test_continuous_stream(capsys):
    serve.main(ARGS + ["--continuous", "--stream-rps", "500"])
    out = capsys.readouterr().out.splitlines()
    stream = re.search(r"stream: (\d+) requests \((\d+) images\).*occupancy (\d+)%",
                       out[-1])
    assert stream and stream.group(1) == stream.group(2) == "8", out
    assert 0 < int(stream.group(3)) <= 100


def test_serves_a_checkpoint_as_jax_does(tmp_path, capsys):
    """--ckpt restores the checkpoint into the flagship and serves it with the
    int8 head: the logits equal the JAX Predictor's on the same weights."""
    jm = bnn_tpu.prepare_binary_model(
        bnn_tpu.models.resnet18(num_classes=10, rngs=nnx.Rngs(3)),
        bnn_tpu.BConfig(jops.BasicInputBinarizer, jops.BasicScaleBinarizer,
                        jops.XNORWeightBinarizer),
        ignore_layers_name=["_first_", "_last_"])
    flat = _randomized(_flat(jm), np.random.RandomState(3))
    _write_flat(jm, flat)
    tm = serve.build_model(10)
    load_jax_state(tm, flat)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, tm, metadata={"epoch": 1})

    serve.main(ARGS + ["--ckpt", path])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3 and out[0].startswith("serving state")

    x = np.random.RandomState(4).randn(3, 32, 32, 3).astype(np.float32)
    served = serve.Predictor.from_checkpoint(
        path, lambda: serve.build_model(10), batch_size=4, fuse=False,
        quantize_float_bits=8, device="cpu", dtype=None)
    want = np.asarray(JPredictor(jm, batch_size=4, use_pallas=False, fuse=False,
                                 quantize_float_bits=8, dtype=None)(jnp.asarray(x)))
    np.testing.assert_allclose(served(_nchw(x)).numpy(), want, rtol=1e-5, atol=1e-5)


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is served, not refused")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--num-classes", "10", "--size", "32", "--requests", "1"])


def _cli(*args):
    """``python -m bnn_tpu_torch.examples.serve`` as a subprocess."""
    run = subprocess.run([sys.executable, "-m", "bnn_tpu_torch.examples.serve",
                          *args], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    return run.stdout.splitlines()


@pytest.mark.parametrize("stream", [False, True])
def test_export_then_load(tmp_path, stream):
    """--export writes a bundle and exits; --load serves it (batched
    requests, or with --continuous a stream) without building a model, and
    prints the bundle's platforms, batch and state bytes first."""
    path = str(tmp_path / "bundle")
    out = _cli(*ARGS, "--export", path)
    assert out[0].startswith("serving state: ")
    assert out[-1] == f"exported serving bundle to {path} (serve it with --load {path})"
    assert sorted(os.listdir(path)) == ["meta.json", "program.pt2"]
    out = _cli("--device", "cpu", "--load", path, "--requests", "2",
               *(["--continuous", "--stream-rps", "500"] if stream else []))
    assert re.fullmatch(rf"loaded bundle {re.escape(path)}: platforms \['cpu'\], "
                        r"batch 4, state [0-9.]+ MB", out[0]), out[0]
    if stream:
        assert re.match(r"stream: 8 requests \(8 images\)", out[-1]), out
    else:
        assert [line.split(":")[0] for line in out[1:]] == ["request 0", "request 1"]
