"""The benchmark's general part: it finds a cell's configuration, traffic
mix and metrics by the names in ``BENCHMARK.json``, drives the mix's entry
(``benchmark/entries/<entry>.py``) through set-up, the measured window, an
optional traced window and the check against the plain reference, and
forms the one result line.

A configuration is ``benchmark/configs/<config>.json``, a traffic mix
``benchmark/mixes/<traffic>.json`` (its ``"entry"`` names the entry), a
per-layer metric ``benchmark/metrics/<metric>.py`` with a ``read(run)``
that returns a number or None.  Adding any of them takes new files and new
entries in ``BENCHMARK.json`` only.
"""

import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "spurfies_tpu")


def load_json(path):
    return json.loads(Path(path).read_text())


def find(items, name, what):
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_spec(bench: dict, workload: str) -> dict:
    """The cell ``workload`` of ``bench`` with its configuration file, mix
    file, metric entries and the limits of its compared numbers
    (``benchmark/limits/<cell>.json``): ``{"cell", "config", "mix",
    "end_to_end", "per_layer", "limits"}``."""
    cell = find(bench["workloads"], workload, "workload")
    conf = find(bench["configs"], cell["config"], "configuration")
    mix = load_json(HERE / "mixes" / f"{cell['traffic']}.json")

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]

    return {"cell": cell, "config": load_json(HERE.parent / conf["file"]),
            "mix": mix, "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"]),
            "limits": load_json(HERE / "limits" / f"{workload}.json")}


def metric_reader(name: str):
    """``read(run)`` of ``benchmark/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class Run:
    """What one run of a cell knows: its specification, seed, device and
    clock, and what the entry and the trace record for the metrics.

    ``e2e``: end-to-end values by name; ``units``/``window_s``: the work
    completed in the measured window and its length; ``trace``: the
    reduced device trace (:mod:`benchmark.trace`) or None; ``counters``:
    counts the traced window's wrappers took; ``compared``: the checked
    numbers ``[(name, value, limit)]``."""

    def __init__(self, spec: dict, seed: int, device: str, t0: float):
        self.spec = spec
        self.cell = spec["cell"]
        self.config = spec["config"]
        self.mix = spec["mix"]
        self.kind = spec["mix"]["entry"]
        self.seed = seed
        self.device = device
        self.t0 = t0
        self.e2e = {}
        self.units = 0
        self.window_s = 0.0
        self.trace = None
        self.counters = {}
        self.compared = []
        self.state = {}

    def sync(self):
        if self.device != "cpu":
            import torch
            torch.cuda.synchronize()

    def log(self, *args):
        print(*args, file=sys.stderr, flush=True)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float | None = None):
    """Drive one run of a cell; returns ``(run, result)`` where result is
    the dict of the result line (without ``device``)."""
    t0 = time.perf_counter() if t0 is None else t0
    run = Run(spec, seed, device, t0)
    entry = importlib.import_module(f"benchmark.entries.{run.kind}")
    entry.setup(run)
    run.sync()
    run.e2e["setup_s"] = time.perf_counter() - t0
    run.log(f"setup_s {run.e2e['setup_s']:.3f}")
    entry.window(run, seconds)
    run.memory_peak_bytes = entry.memory_peak(run)
    if trace:
        entry.trace(run)
    entry.release(run)
    run.compared = entry.check(run)
    correct = bool(run.compared) and all(
        v == v and v <= lim for _, v, lim in run.compared)
    names = spec["per_layer"] if trace else spec["end_to_end"]
    metrics = {}
    for m in names:
        v = (metric_reader(m["name"])(run) if trace
             else run.e2e.get(m["name"]))
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    # a step or image that fails raises, and the run prints no result
    result = {"correct": correct, "attempted": run.units, "failed": 0,
              "metrics": metrics}
    if trace and run.trace is not None:
        result["breakdown"] = run.trace["breakdown"]
    return run, result


def compared_text(compared) -> dict:
    return {name: {"value": v, "limit": lim} for name, v, lim in compared}
