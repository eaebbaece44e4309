"""A second architecture is new files only. A copy of the harness takes a
toy family that is not a ResNet (``second_family/``: its family, reference,
configuration, traffic mixes and workloads, each a file the harness does
not have), with the toy model put into ``bnn_tpu_torch.models`` by
``second_family/drive.py`` in its own process on the CPU: each toy
cell's run ends ``correct`` untraced and traced, every reader under
``metrics/`` returns a number or None, and ``control.py``'s readings run,
the control failing a limit of each cell."""
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import arch

ROOT = Path(__file__).resolve().parents[2]
FAMILY = Path(__file__).resolve().parent / "second_family"
# drive.py and the toy model sit beside the copy, outside the harness
BESIDE = ("drive.py", "tinybnn_model.py")


@pytest.fixture(scope="module")
def driven(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("second_family")
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    added = []
    for path in sorted(FAMILY.rglob("*")):
        if not path.is_file() or "__pycache__" in path.parts:
            continue
        rel = path.relative_to(FAMILY)
        dest = tmp / rel if rel.name in BESIDE else tmp / "portbench" / rel
        assert not dest.exists(), f"{rel} is a file the harness already has"
        dest.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(path, dest)
        added.append(str(rel))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run([sys.executable, "drive.py"], cwd=tmp, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return tmp, added, json.loads(out.stdout.strip().splitlines()[-1])


def test_the_toy_comes_as_new_files_only(driven):
    tmp, added, got = driven
    assert {str(Path(p).parent) for p in added} >= {
        "families", "reference", "configs", "traffic", "workloads"}
    assert Path(got["harness"]) == tmp / "portbench"


def test_each_toy_run_is_correct(driven):
    _, _, got = driven
    assert len(got["runs"]) == 4
    for key, run in got["runs"].items():
        assert run["rc"] == 0, key
        result = run["result"]
        assert result["correct"] is True, (key, result["checks"])
        assert result["metrics"], key
        assert all(math.isfinite(m["value"]) for m in result["metrics"].values()), key


def test_every_reader_reads_a_number_or_none(driven):
    _, _, got = driven
    readers = got["readers"]
    assert all(v is None or math.isfinite(v) for v in readers.values()), readers
    # the toy's made-up calls are explained by its layers; it has no fused blocks
    assert readers["serve/binary_conv2d_roofline"] > 0
    assert readers["serve/binary_gemm_roofline"] > 0
    assert readers["serve/fused_basic_block_roofline"] is None
    assert readers["serve/fused_downsample_block_roofline"] is None
    assert readers["serve/mfu_pct.serve"] > 0


def test_the_control_readings_run_and_fail_a_limit(driven):
    _, _, got = driven
    for cell, readings in got["control"].items():
        limits = readings["limits"]
        assert all(readings["program"][k] <= lim for k, lim in limits.items()), cell
        assert any(readings["control"][k] > lim for k, lim in limits.items()), cell


def test_an_arch_no_family_claims_is_named():
    with pytest.raises(KeyError, match="no module under portbench/families/"):
        arch.family({"arch": "not-an-arch"})
