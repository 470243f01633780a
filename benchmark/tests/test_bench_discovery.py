"""A new configuration, mix and metric are found by name, from new files
and new BENCHMARK.json entries alone."""

import json
import shutil

from benchmark import harness
from benchmark.tests.conftest import ROOT, bench


def test_new_files_are_found(tmp_path, monkeypatch):
    here = tmp_path / "benchmark"
    for d in ("configs", "mixes", "metrics", "limits"):
        shutil.copytree(ROOT / "benchmark" / d, here / d)
    conf = json.loads((here / "configs" / "own_data.json").read_text())
    conf["name"] = "own_data_wide"
    (here / "configs" / "own_data_wide.json").write_text(json.dumps(conf))
    mix = json.loads((here / "mixes" / "train.json").read_text())
    (here / "mixes" / "train_long.json").write_text(
        json.dumps(dict(mix, window=100)))
    (here / "limits" / "own_data_wide.train_long.json").write_text(
        (here / "limits" / "own_data.train.json").read_text())
    (here / "metrics" / "steps_traced.train.py").write_text(
        "def read(run):\n    return 42.0\n")
    b = bench()
    b["configs"].append({"name": "own_data_wide", "source": "x",
                         "file": "benchmark/configs/own_data_wide.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "own_data_wide.train_long",
                           "config": "own_data_wide",
                           "traffic": "train_long", "chips": 1,
                           "why": "x"})
    b["per_layer"].append({"name": "steps_traced.train", "unit": "steps",
                           "better": "higher", "source": "device_trace",
                           "layer": "x", "moves": "train_rays_per_s",
                           "workloads": ["own_data_wide.train_long"]})
    b["end_to_end"][0]["workloads"].append("own_data_wide.train_long")
    monkeypatch.setattr(harness, "HERE", here)
    spec = harness.cell_spec(b, "own_data_wide.train_long")
    assert spec["config"]["name"] == "own_data_wide"
    assert spec["mix"]["window"] == 100
    assert [m["name"] for m in spec["per_layer"]] == ["steps_traced.train"]
    assert harness.metric_reader("steps_traced.train")(None) == 42.0
