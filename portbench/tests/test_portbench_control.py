"""``correct`` has to come out false where it should. On the CPU, at a size a
test run holds: the control (the reference in fp8, put in the program's
place) fails a limit of every cell; and a run driven with its timed path
broken underneath (an answer altered where it is produced: the logits, or
a fused block's output; a training step that leaves its state unchanged,
that leaves half of its batch out, or whose optimizer stops moving the
weights after the first steps) reports ``correct`` false. The program runs
in float32 here, so a sound run's numbers are rounding and only the fault
shows."""
import json
import time

import pytest
import torch

from portbench import control, run
from portbench.core import Context, load_cell
from portbench.run import _merge

# 8 images a request: the stages fall back to their blocks, which run fused
SERVE = {"config": {"image_size": 64}, "mix": {"warmup": 2, "sample": 2, "sample_range": 3,
                                               "rows": 2, "pool": 3}}
# over the blocks' cap the fused modules fall back to the deployed convs
BULK = {"config": {"image_size": 64}, "mix": {"warmup": 2, "sample": 2, "sample_range": 3,
                                              "rows": 2, "pool": 2, "batch": 6}}
TRAIN = {"config": {"image_size": 64}, "mix": {"batch": 16, "pool": 4, "log_every": 2,
                                               "rows": 4, "slice": 2}}
F32 = {"config": {"dtype": "float32", "train_compute_dtype": "float32"}}
CELLS = [("r18-serve-b8", SERVE), ("r50-serve-b64", BULK), ("r18-serve-b64", BULK),
         ("r18-train-b256", TRAIN)]


def context(cell, overrides, seed=3):
    return Context(_merge(load_cell(cell), json.loads(json.dumps(overrides))), seed, 1.0,
                   False, torch.device("cpu"), time.perf_counter(), 0.0)


@pytest.mark.parametrize("cell, small", CELLS)
def test_the_control_fails_a_limit(cell, small):
    ctx = context(cell, small)
    read = control.serve_readings if "serve" in cell else control.train_readings
    got = read(ctx)["control"]
    limits = ctx.cell["limits"]
    assert any(got[k] > lim for k, lim in limits.items()), (got, limits)


def drive(cell, small, capsys):
    rc = run.main(["--workload", cell, "--seed", "7", "--seconds", "0.5"], device="cpu",
                  overrides=_merge(json.loads(json.dumps(small)), F32))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell, small", CELLS)
def test_a_sound_run_is_correct(cell, small, capsys):
    assert drive(cell, small, capsys)["correct"] is True


@pytest.mark.parametrize("cell, small", CELLS[:3])
def test_an_altered_answer_is_not_correct(cell, small, monkeypatch, capsys):
    from bnn_tpu_torch.inference import Predictor

    served = Predictor.__call__

    def altered(self, x):
        out = served(self, x).clone()
        out[:, 7] += out.abs().amax(dim=1)  # one logit of every row
        return out

    monkeypatch.setattr(Predictor, "__call__", altered)
    assert drive(cell, small, capsys)["correct"] is False


@pytest.mark.parametrize("block", ["FusedBlock", "FusedDownBlock"])
def test_an_altered_fused_block_is_not_correct(block, monkeypatch, capsys):
    from bnn_tpu_torch.inference import megablock

    cls = getattr(megablock, block)
    fused = cls.forward

    def altered(self, x):
        out = fused(self, x)
        return torch.where(torch.arange(out.shape[1]).view(1, -1, 1, 1) == 3, 0.5 * out, out)

    monkeypatch.setattr(cls, "forward", altered)  # one channel at half its value
    assert drive("r18-serve-b8", SERVE, capsys)["correct"] is False


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(monkeypatch, capsys):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    assert drive("r18-train-b256", TRAIN, capsys)["correct"] is False


def test_an_optimizer_that_stops_after_the_first_steps_is_not_correct(monkeypatch, capsys):
    whole = torch.optim.AdamW.step

    def stops(self, closure=None):
        states = [self.state[p] for g in self.param_groups for p in g["params"]]
        if any(int(s.get("step", 0)) >= 3 for s in states):
            return None  # past the steps the set-up checks, the weights stay
        return whole(self, closure)

    monkeypatch.setattr(torch.optim.AdamW, "step", stops)
    assert drive("r18-train-b256", TRAIN, capsys)["correct"] is False


def test_a_step_on_half_the_batch_is_not_correct(monkeypatch, capsys):
    from portbench import program

    whole = program.train_step

    def halved(config):
        step = whole(config)
        return lambda model, opt, x, y: step(model, opt, x[:x.shape[0] // 2],
                                             y[:y.shape[0] // 2])

    monkeypatch.setattr(program, "train_step", halved)
    assert drive("r18-train-b256", TRAIN, capsys)["correct"] is False
