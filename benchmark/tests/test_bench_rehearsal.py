"""A tiny CPU rehearsal of each mix's loop (set-up, window, check), and
the measuring entry point refusing to run without a card."""

import json
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT


@pytest.mark.parametrize("cell", ["own_data.train", "dtu_pn.train",
                                  "dtu_pn.render"])
def test_loop_rehearsal(cell, spec_of):
    spec = spec_of(cell)
    run, result = harness.run_cell(spec, 2**31 + 7, 0.5, False, "cpu")
    assert result["correct"], run.compared
    assert result["attempted"] >= 1 and result["failed"] == 0
    names = {m["name"] for m in spec["end_to_end"]}
    assert set(result["metrics"]) == names
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert harness.forbidden_modules() == []


def test_no_card_no_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "dtu_pn.train", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0
    for line in p.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_without_the_program(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "dtu_pn.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(tmp_path)})
    assert p.returncode != 0 and "{" not in p.stdout
