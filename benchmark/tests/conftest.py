"""Tiny CPU specifications of the benchmark's cells: the cell's own
configuration, mix and limits from the repository, with the scene, the
sampler and the batch cut to a size that a test run holds.  The program's
prior runs in f32 here (its colour MLPs in bf16, as on the card)."""

import copy
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def with_parked(b: dict) -> dict:
    """``b`` with ``own_data.train`` put back as it stood before it was
    left out of ``BENCHMARK.json`` (its host-bound rate spreads beyond the
    largest bound); its configuration, limits and scene stay in the
    benchmark, and the tests keep them sound."""
    if any(w["name"] == "own_data.train" for w in b["workloads"]):
        return b
    b = copy.deepcopy(b)
    b["configs"].append({"name": "own_data", "source": "x",
                         "file": "benchmark/configs/own_data.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "own_data.train", "config": "own_data",
                           "traffic": "train", "chips": 1, "why": "x"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "dtu_pn.train" in m.get("workloads", []):
            m["workloads"].append("own_data.train")
    return b


def tiny_spec(cell: str) -> dict:
    from benchmark import harness

    spec = copy.deepcopy(harness.cell_spec(with_parked(bench()), cell))
    c = spec["config"]
    c["compute_dtype"] = "float32"
    kw = c["scene"]["kwargs"]
    if c["scene"]["generator"] == "make_dust3r_like_scene":
        c["scene"]["kwargs"] = {"n_points": 1500, "img_res": [24, 32]}
    else:
        c["scene"]["kwargs"] = dict(kw, n_points=3000, img_res=[48, 64])
    if "local" in c:
        c["local"] = dict(c["local"], depth_res=[24, 32])
    m = c["config"]["model"]
    m["max_shading_pts"] = 16
    m["ray_sampler"].update({"n_samples": 16, "n_samples_eval": 32,
                             "n_samples_extra": 8})
    c["config"]["train"]["num_pixels"] = 128
    c["config"]["train"]["render_chunk"] = 256
    mix = spec["mix"]
    if mix["entry"] == "train":
        spec["mix"] = dict(mix, warmup_steps=2, window=2, traced_steps=2)
    else:
        spec["mix"] = dict(mix, views=mix["views"][:2])
    return spec


@pytest.fixture
def spec_of():
    return tiny_spec
