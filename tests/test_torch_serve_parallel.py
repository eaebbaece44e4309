"""The serve CLI's --data-parallel and --tensor-parallel (python -m
bnn_tpu_torch.examples.serve under torchrun), each rank's main(argv) in a
world of two gloo ranks with --device cpu (tests/torch_distributed_worker.py's
cli suite, whose world tests/test_torch_imagenet_example.py shares), against
the CLI in this process: the same requests give the same top-1 lists;
--export then --load, --ckpt and --continuous compose with the flags; only
rank 0 prints. The CLI's serving path on one process is held against the
JAX package's by tests/test_torch_serve_example.py."""
import re

import pytest
import torch.distributed as dist

from bnn_tpu_torch.examples import serve
from torch_distributed_worker import SERVE_ARGS, cli_inputs, shared_world


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return shared_world("cli", 2, tmp_path_factory, cli_inputs)


def _top1(text):
    return re.findall(r"request \d+: \d+ images -> top-1 (\[[^\]]*\])", text)


@pytest.fixture(scope="module")
def single(ranks):
    """The single-process CLI's top-1 lists, fresh weights and the checkpoint."""
    import contextlib
    import io

    ckpt = ranks[0]["ckpt"]
    out = {}
    for tag, extra in (("fresh", []), ("ckpt", ["--ckpt", ckpt])):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            serve.main(SERVE_ARGS + extra)
        out[tag] = _top1(text.getvalue())
    return out


def test_ranks_import_no_jax(ranks):
    assert all(r["jax_imported"] == [] for r in ranks)


@pytest.mark.parametrize("tag,ref", [("dp", "fresh"), ("tp", "fresh"),
                                     ("tp_ckpt", "ckpt"), ("dp_ckpt", "ckpt")])
def test_parallel_top1_is_the_single_process_top1(ranks, single, tag, ref):
    text = ranks[0][f"serve_{tag}"]
    assert len(single[ref]) == 2 and _top1(text) == single[ref]
    mesh = "{'data': 2, 'model': 1}" if tag.startswith("dp") else "{'data': 1, 'model': 2}"
    assert f"mesh {mesh} over 2 ranks" in text


def test_tensor_parallel_names_its_sharded_layers(ranks):
    m = re.search(r"(\d+)/(\d+) deployed layers tensor-sharded over 2 ranks",
                  ranks[0]["serve_tp"])
    assert m and 0 < int(m.group(1)) <= int(m.group(2))


@pytest.mark.parametrize("tag", ["dp", "tp"])
def test_export_then_load(ranks, single, tag):
    assert "exported serving bundle to" in ranks[0][f"export_{tag}"]
    loaded = ranks[0][f"load_{tag}"]
    mesh = "{'data': 2, 'model': 1}" if tag == "dp" else "{'data': 1, 'model': 2}"
    assert f"mesh {mesh}" in loaded.splitlines()[0]
    assert _top1(loaded) == single["fresh"]


@pytest.mark.parametrize("tag", ["continuous", "continuous_load"])
def test_continuous_serves_every_request(ranks, tag):
    """Rank 0's batcher broadcasts each batch; 2 requests of batch 4 make 8
    single-image requests."""
    stream = re.search(r"stream: (\d+) requests \((\d+) images\)", ranks[0][tag])
    assert stream and stream.group(1) == stream.group(2) == "8", ranks[0][tag]


def test_only_rank_zero_prints(ranks):
    serve_keys = [k for k in ranks[0] if k.startswith(("serve_", "export_", "load_",
                                                       "continuous"))]
    assert len(serve_keys) == 10
    assert all(ranks[0][k] for k in serve_keys)
    assert all(ranks[1][k] == "" for k in serve_keys)


def test_data_parallel_in_a_world_of_one_raises():
    with pytest.raises(ValueError, match="2x1 != 1 devices"):
        serve.main(SERVE_ARGS + ["--data-parallel", "2"])
    assert not dist.is_initialized()  # the CLI's world of one is gone
