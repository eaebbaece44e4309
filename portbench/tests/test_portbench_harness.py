"""The harness: BENCHMARK.json against its files and the contract's
character rules, cells found from data files alone, no JAX in a run, no
fall-back to the CPU, and (on the card) each cell for a few seconds."""
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run
from portbench.core import load_cell

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_names_and_units_use_the_allowed_characters():
    names = [m["name"] for m in metrics()] + [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in metrics())
    assert len({m["name"] for m in metrics()}) == len(metrics())
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])


def test_every_cell_reports_what_its_metrics_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]

    def reports(metric, cell):
        return "workloads" not in metric or cell in metric["workloads"]

    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert reports(moved, cell), (m["name"], cell)
    for cell in cells:
        assert reports(e2e["setup_s"], cell)
        assert any(reports(m, cell) for m in BENCH["per_layer"])
        assert sum(reports(m, cell) for m in BENCH["end_to_end"]) >= 2


def test_benchmark_entries_have_their_files():
    for c in BENCH["configs"]:
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in BENCH["workloads"]:
        cell = load_cell(w["name"])
        assert (cell["config"]["name"], cell["traffic"], cell["chips"]) == (
            w["config"], w["traffic"], w["chips"])
    readers = run.readers()
    assert {m["name"] for m in BENCH["per_layer"]} <= set(readers)
    assert all(readers[m["name"]].UNIT == m["unit"] for m in BENCH["per_layer"])


def test_a_new_cell_is_a_new_file(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "portbench" / "workloads" / "r50-serve-b4.json").write_text(json.dumps(
        {"config": "resnet50-flagship", "traffic": "closed-b4", "chips": 1,
         "limits": {"stem_err": 1.0}}))
    code = ("from portbench.core import load_cell; c = load_cell('r50-serve-b4'); "
            "print(c['config']['name'], c['mix']['kind'], c['mix']['batch'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, check=True).stdout.split()
    assert out == ["resnet50-flagship", "serve_closed", "4"]


PROBE = '''"""A traffic kind for a test: each rank adds its number over the group."""
import torch
import torch.distributed as dist

from portbench.core import Record


def run(ctx):
    t = torch.tensor([ctx.rank + 1.0])
    dist.all_reduce(t)
    rec = Record("probe", ctx.config, ctx.mix, 1, attempted=1)
    rec.end_to_end = {"setup_s": (ctx.ready(), "s"), "rank_sum": (float(t), "1")}
    rec.checks = {"sum_gap": (abs(float(t) - ctx.world * (ctx.world + 1) / 2), 0.0)}
    return rec
'''


def test_a_cell_on_several_chips_starts_its_ranks(tmp_path):
    """A cell with ``chips`` above 1 is data: the one command starts a rank
    a chip (here two on the CPU, over gloo) and prints rank 0's line."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "portbench"
    (pb / "traffic" / "rank_probe.py").write_text(PROBE)
    (pb / "traffic" / "probe.json").write_text(json.dumps({"kind": "rank_probe", "batch": 1}))
    (pb / "workloads" / "r18-probe-2.json").write_text(json.dumps(
        {"config": "resnet18-flagship", "traffic": "probe", "chips": 2, "limits": {}}))
    code = ("import sys; from portbench import run; sys.exit(run.main(['--workload', "
            "'r18-probe-2', '--seed', '1', '--seconds', '0.1'], device='cpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["count"] == 2
    assert result["metrics"]["rank_sum"]["value"] == 3.0


def _loaded(code: str) -> list:
    probe = (code + "; import sys; print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    return eval(out.strip().splitlines()[-1])


def test_no_jax_in_a_run_and_no_program_in_the_reference():
    top = _loaded("import portbench.run, portbench.control, portbench.program; "
                  "import portbench.traffic.serve_closed, portbench.traffic.train_steps; "
                  "portbench.run.readers(); import bnn_tpu_torch, bnn_tpu_torch.inference")
    assert not set(top) & {"jax", "jaxlib", "flax", "bnn_tpu"}
    assert "bnn_tpu_torch" in top
    ref = _loaded("import portbench.reference.resnet, portbench.reference.lowp")
    assert not set(ref) & {"jax", "jaxlib", "flax", "bnn_tpu", "bnn_tpu_torch"}


def test_without_a_card_the_run_fails_and_prints_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "r18-serve-b8", "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_a_run_that_loads_jax_prints_no_result(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", object())
    rc = run.main(["--workload", "r18-serve-b8", "--seed", "1", "--seconds", "0.2"],
                  device="cpu", overrides={"config": {"image_size": 32},
                                           "mix": {"warmup": 1, "sample": 1, "sample_range": 1,
                                                   "rows": 1}})
    assert rc == 3
    assert capsys.readouterr().out == ""


def test_a_line_holds_the_metrics_listed_for_its_cell(capsys):
    """The metrics a run prints are those BENCHMARK.json lists for its cell:
    ``r18-serve-b64`` reads its latency tail per layer, not end to end."""
    small = {"config": {"image_size": 32},
             "mix": {"batch": 4, "warmup": 1, "sample": 1, "sample_range": 1, "rows": 1}}
    rc = run.main(["--workload", "r18-serve-b64", "--seed", "2147483659", "--seconds", "0.2"],
                  device="cpu", overrides=small)
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(result["metrics"]) == {"serve_images_per_s", "setup_s"}
    assert run.listed("r18-serve-b64", "per_layer") >= {"latency_p95_ms.serve"}
    assert "latency_p95_ms.serve" not in run.listed("r50-serve-b64", "per_layer")
    assert run.listed("a-cell-of-no-file", "end_to_end") is None


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_each_cell_runs_on_the_card(card, cell, trace):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell,
                          "--seed", "2147483659", "--seconds", "3", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
    names = {m["name"] for m in (BENCH["per_layer"] if trace else BENCH["end_to_end"])
             if cell in m.get("workloads", [cell])}
    assert names == set(result["metrics"])
