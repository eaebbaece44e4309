"""The ResNet readings, held to ``frozen_resnet.json``: what the harness read
before its ResNet parts moved behind ``families/resnet.py`` (the layer
tables, the arithmetic, the kernels' bounds at the shapes the serving cells
trace, every layer's and the calls one request made on the card, the
watched modules, the weights from a seed, and the check numbers of a small
serving and training run on the CPU), frozen from that code. Every value
has to come out exactly the same."""
import hashlib
import json
import time
from pathlib import Path

import pytest
import torch

from portbench import arch, roofline, weights
from portbench.core import Context, load_cell
from portbench.reference import lowp
from portbench.run import _merge
from portbench.traffic import serve_closed as sc
from portbench.traffic import train_steps as ts

FROZEN = json.loads((Path(__file__).parent / "frozen_resnet.json").read_text())
CONFIGS = sorted(FROZEN["configs"])
# the check runs: image size 32, a few requests or steps, at the cell's dtype
SERVE = {"config": {"image_size": 32}, "mix": {"warmup": 2, "sample": 2, "sample_range": 3,
                                               "rows": 2, "pool": 3}}
BULK = {"config": {"image_size": 32}, "mix": {"warmup": 2, "sample": 2, "sample_range": 3,
                                              "rows": 2, "pool": 2, "batch": 6}}
TRAIN = {"config": {"image_size": 32}, "mix": {"batch": 16, "pool": 4, "log_every": 2,
                                               "rows": 4, "slice": 2}}
CHECK_SEED = 2**31 + 13
# the frozen runs' host threads: a CPU reduction's order depends on them
THREADS = 2


def digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()


@pytest.fixture
def threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("name", CONFIGS)
def test_the_layer_tables_and_arithmetic_are_unchanged(name):
    cfg, want = arch.load_config(name), FROZEN["configs"][name]
    assert digest(arch.conv_layers(cfg)) == want["conv_layers"]
    assert digest(list(arch.blocks(cfg))) == want["blocks"]
    assert digest(arch.state_spec(cfg)) == want["state_spec"]
    assert roofline.macs(cfg) == want["macs"]
    assert roofline.forward_min_s(cfg) == want["forward_min_s"]
    assert roofline.train_min_s(cfg) == want["train_min_s"]
    assert digest(sorted(arch.family(cfg).watched_names(cfg))) == want["watched_names"]


def test_the_kernel_bounds_are_unchanged():
    for kernel, name, shapes, batch, want in FROZEN["bounds"]:
        got = roofline.KERNEL_BOUNDS[kernel](arch.load_config(name), shapes, batch)
        assert got == want, (kernel, name, shapes, batch)


@pytest.mark.parametrize("name", CONFIGS)
def test_the_weights_from_a_seed_are_unchanged(name):
    state = weights.make_state(arch.load_config(name), FROZEN["seed"], "cpu")
    d = hashlib.sha256()
    for k in sorted(state):
        d.update(k.encode())
        d.update(state[k].contiguous().numpy().tobytes())
    assert d.hexdigest() == FROZEN["configs"][name]["state"]


def context(cell, small):
    return Context(_merge(load_cell(cell), json.loads(json.dumps(small))), CHECK_SEED, 0.2,
                   False, torch.device("cpu"), time.perf_counter(), 0.0)


@pytest.mark.parametrize("cell, small", [("r18-serve-b8", SERVE), ("r18-serve-b64", BULK),
                                         ("r50-serve-b64", BULK)])
def test_the_serving_check_numbers_are_unchanged(cell, small, threads):
    ctx = context(cell, small)
    srv = sc.Server(ctx)
    sc.warm(srv)
    w = sc.serve(srv, ctx.seconds, sc.sample_ids(ctx))
    srv.close()
    got = {"program": sc.numbers(srv, w["kept"]),
           "control": sc.numbers(srv, w["kept"], q=lowp.fp8)}
    assert got == FROZEN["checks"][cell]
    assert set(ctx.cell["limits"]) <= set(got["program"])


def test_the_training_check_numbers_are_unchanged(threads):
    ctx = context("r18-train-b256", TRAIN)
    tr = ts.Trainer(ctx)
    first = tr.first_steps()
    # a fixed count of window steps (not a time) so that the late step is the same
    w = ts.train(tr, ts.FIRST_STEPS, steps=2)
    late = tr.late_step(w["next"])
    tr.close()
    got = {**ts.numbers(first, tr.reference()), **ts.layer_numbers(tr, first["kept"]),
           **ts.update_numbers(tr, first["first"]), **ts.late_numbers(tr, late)}
    assert got == FROZEN["checks"]["r18-train-b256"]["program"]
    assert set(ctx.cell["limits"]) <= set(got)
