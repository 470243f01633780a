"""The port's utilities (``utils/flops.py``, ``utils/profiling.py``) and
its fleet CLI (``cli/fleet.py``) against the JAX package's, on the CPU.

``train_step_flops`` gives JAX's integer for the same config (the default,
the DTU config and the option configs the port runs); the fleet's shards
and host index are JAX's (``tests/test_parallel.py``'s ``TestFleet`` as
the model), and its CLI trains two tiny own-data scenes on host 0 of 2.
"""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import json
import os
import sys

import numpy as np
import pytest
import torch

from spurfies_tpu import config as jconfig
from spurfies_tpu.cli import fleet as jfleet
from spurfies_tpu.utils import flops as jflops
from spurfies_tpu_torch import config as tconfig
from spurfies_tpu_torch.cli import fleet as tfleet
from spurfies_tpu_torch.data.synthetic import export_synthetic_own_data
from spurfies_tpu_torch.utils import flops as tflops
from spurfies_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTIONS = [
    [],
    ["model.fused_agg=false"],
    ["model.pair_budget_frac=0.625", "model.color_pair_frac=0.75"],
    ["model.ray_budget_frac=0", "model.occ_compact=true"],
    ["model.ray_budget_frac=0.5"],
    ["model.probe_budget_frac=1", "model.probe_k=1"],
    ["model.probe_budget_frac=0.3", "train.fast_iters=2"],
    ["model.color_top_samples=0", "model.max_shading_pts=64"],
    ["model.entangled=true", "model.max_shading_pts=64"],
    ["train.num_pixels=4096", "model.k=4"],
]


@pytest.mark.parametrize("overrides", OPTIONS, ids=lambda o: ",".join(o)
                         or "default")
@pytest.mark.parametrize("yaml", [None, "configs/dtu_pn.yaml"])
def test_train_step_flops_is_jax(overrides, yaml):
    def cfg(mod):
        base = (mod.load_yaml(os.path.join(ROOT, yaml)) if yaml
                else mod.Config())
        return mod.apply_overrides(base, overrides)

    ours = tflops.train_step_flops(cfg(tconfig))
    ref = jflops.train_step_flops(cfg(jconfig))
    assert isinstance(ours, int) and ours == ref > 0
    assert tflops.train_step_flops(cfg(tconfig), 512) == \
        jflops.train_step_flops(cfg(jconfig), 512)


def test_peak_tflops_is_the_h100s():
    """The H100 SXM's dense bf16 peak, by the name torch reports; the
    default too (no TPU generation is in the port's table)."""
    assert tflops.peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert tflops.peak_tflops("some other card") == 989.0
    assert not any(k.startswith("v") for k in tflops.BF16_PEAK_TFLOPS)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as d:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_shard_scans_is_jax():
    scans = [f"scan{i}" for i in range(11)]
    for n in (1, 3, 4):
        shards = [tfleet.shard_scans(scans, n, h) for h in range(n)]
        assert shards == [jfleet.shard_scans(scans, n, h) for h in range(n)]
        assert sorted(s for sh in shards for s in sh) == sorted(scans)
        sizes = [len(sh) for sh in shards]
        assert max(sizes) - min(sizes) <= 1
    for bad in (2, -1):
        with pytest.raises(ValueError):
            tfleet.shard_scans(["a"], 2, bad)


def test_resolve_host_index(monkeypatch):
    """The flag, then ``$FLEET_HOST_INDEX``, then the process group's rank
    (JAX: ``jax.process_index()``), else 0."""
    monkeypatch.delenv("FLEET_HOST_INDEX", raising=False)
    assert tfleet.resolve_host_index(None) == jfleet.resolve_host_index(
        None) == 0
    assert tfleet.resolve_host_index(3) == jfleet.resolve_host_index(3) == 3
    monkeypatch.setenv("FLEET_HOST_INDEX", "2")
    assert tfleet.resolve_host_index(None) == jfleet.resolve_host_index(
        None) == 2
    assert tfleet.resolve_host_index(1) == 1
    monkeypatch.delenv("FLEET_HOST_INDEX")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 5)
    assert tfleet.resolve_host_index(None) == 5


def test_fleet_trains_its_shard_on_the_cpu(tmp_path, monkeypatch):
    """Host 0 of 2 trains ``s0`` (two steps at ``tests/test_parallel.py``'s
    overrides) and writes JAX's manifest; host 1's scene is left alone.
    Without ``tensorboard`` (as on the card's machine) the metric writer
    keeps JSONL only; here ``torch.utils.tensorboard`` would load
    TensorFlow."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    for scan in ("s0", "s1"):
        export_synthetic_own_data("data", scan, n_points=800, n_views=3,
                                  img_res=(16, 16))
    ov = ["dataset.data_dir=own_data", "model.max_shading_pts=8",
          "model.ray_sampler.near=0.5", "model.ray_sampler.far=3.0",
          "model.ray_sampler.n_samples=8",
          "model.ray_sampler.n_samples_eval=16",
          "model.ray_sampler.n_samples_extra=4", "train.num_pixels=32",
          "train.opt_steps=2", "train.render_freq=1000",
          "train.checkpoint_freq=1000"]
    tfleet.main(["--scans", "s0,s1", "--num-hosts", "2", "--host-index",
                 "0", "--device", "cpu"] + ov)
    with open("exps/fleet_host0.json") as f:
        manifest = json.load(f)
    assert manifest["host"] == 0 and manifest["num_hosts"] == 2
    assert list(manifest["scenes"]) == ["s0"]
    assert np.isfinite(manifest["scenes"]["s0"])
    runs = sorted(os.listdir("exps"))
    assert any(r.endswith("_s0") for r in runs)
    assert not any(r.endswith("_s1") for r in runs)
