"""The program's spans and counters on the card: their clock, their cost, and
what they say of the benchmark's two cells.

    python3 chip_trace.py --out trace_study [--seed N] \
        [--seconds S] [--pairs P]

Phases, in this order, each printing one ``phase <name> <json>`` line and
writing ``<out>/<name>.json``:

* ``clock``: a kineto event's ``start_ns``/``end_ns`` against the span it
  ran in (``time.time_ns()``), under CPU and CUDA activity.
* ``train`` / ``render``: the cell's set-up from the benchmark
  (``benchmark.entries``), a measured window of ``--seconds``, the
  benchmark's traced window (its ``profile``, CUDA activity) with every
  per-layer metric of the cell, the real-pair share against the
  benchmark's ``PairCounter`` on the same launches, the share of the window
  the top-level spans cover, the share of the step the five layer metrics
  cover, and the idle seconds by span, the CUDA calls by span and the
  ``cudaLaunchKernel`` calls by outermost span of that session
  (``profiling.summarize`` on its exported trace); ``--pairs`` pairs of
  traced windows with the recorder on and with its entries forced off
  (the null context, in this process only), in turns; and
  ``profiling.trace`` over the same window (CPU and CUDA activity), whose
  ``summary.json`` lands in ``<out>/<cell>_trace/``.
* ``cost``: 10**6 spans with the profiler off and on (CUDA activity, as the
  benchmark's traced window), against a loop over a null context.
"""

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import torch

from benchmark import harness
from spurfies_tpu_torch.utils import profiling

BENCH = harness.load_json(os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "BENCHMARK.json"))
LAYERS = ("sampler_host_ms.train", "field_host_ms.train",
          "loss_host_ms.train", "backward_host_ms.train",
          "optim_host_ms.train")


def emit(out, name, rec):
    with open(os.path.join(out, f"{name}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(f"phase {name} {json.dumps(rec)}", flush=True)


def clock_phase():
    a = torch.randn(1024, 1024, device="cuda")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with profiling.unit("outer"):
            with profiling.span("inner"):
                a @ a
        torch.cuda.synchronize()
    inner = profiling.spans()[1]
    rows = []
    for e in prof.profiler.kineto_results.events():
        if e.name() in ("aten::mm", "cudaLaunchKernel"):
            rows.append({"event": e.name(),
                         "after_span_start_us":
                             (e.start_ns() - inner.start_ns) * 1e-3,
                         "before_span_end_us":
                             (inner.end_ns - e.end_ns()) * 1e-3})
    inside = all(r["after_span_start_us"] >= 0 and r["before_span_end_us"]
                 >= 0 for r in rows)
    return {"events": rows, "inside": inside,
            "torch": torch.__version__, "cuda": torch.version.cuda}


def cost_phase(n=10 ** 6):
    def loop(ctx_fn):
        t = time.perf_counter_ns()
        for _ in range(n):
            with ctx_fn("x"):
                pass
        return (time.perf_counter_ns() - t) / n

    null = profiling._NULL
    out = {"null_ns": loop(lambda _: null),
           "off_ns": loop(profiling.span)}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        with profiling.unit("u"):
            out["on_ns"] = loop(profiling.span)
    out["recorded"] = len(profiling.spans())
    out["dropped"] = profiling._REC.dropped
    return out


def _session_summary(fn, sync):
    """``fn`` under the benchmark's profiler (CUDA activity) between two
    syncs; the recorder's summary of that session and its wall time."""
    sync()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    events = doc["traceEvents"]
    spans = profiling.spans()
    s = profiling.summarize(events, int(doc.get("baseTimeNanoseconds", 0)),
                            spans, pairs=profiling.real_pairs())
    top = sum(x.end_ns - x.start_ns for x in spans if x.parent == -1)
    s["window_s"] = window_s
    s["top_span_share"] = top * 1e-9 / window_s
    s["kernels"] = sum(1 for e in events if e.get("cat") == "kernel")
    return s


def _forced_off(on):
    """Put the recorder's entries back (``on``) or force them to the null
    context, in this process."""
    if on:
        profiling.span, profiling.unit, profiling.hold_pairs = _SAVED
    else:
        profiling.span = profiling.unit = lambda name: profiling._NULL
        profiling.hold_pairs = lambda *a: None


_SAVED = (profiling.span, profiling.unit, profiling.hold_pairs)


def cell_phase(cell, seed, seconds, pairs, out, spec=None, device="cuda"):
    spec = spec or harness.cell_spec(BENCH, cell)
    entry = __import__(f"benchmark.entries.{spec['mix']['entry']}",
                       fromlist=["x"])
    run = harness.Run(spec, seed, device, time.perf_counter())
    entry.setup(run)
    run.sync()
    entry.window(run, seconds)
    entry.trace(run)
    rec = {"cell": cell, "seed": seed, "units": run.trace["units"],
           "window_s": run.trace["window_s"], "busy_s": run.trace["busy_s"],
           "kernels": run.trace["kernels"]}
    held = profiling._REC._held
    rec["held_launches"] = len(held)
    rec["held_bytes"] = sum(i.numel() * i.element_size() for _, i, _ in held)
    metrics = {m["name"]: harness.metric_reader(m["name"])(run)
               for m in spec["per_layer"]}
    rec["metrics"] = metrics
    theirs = run.counters["pair_launches"]
    real = sum(t[0] for v in theirs.values() for t in v)
    slots = sum(t[1] * t[2] for v in theirs.values() for t in v)
    rec["pair_counter_pct"] = 100.0 * real / slots
    rec["pair_pct_equal"] = (rec["pair_counter_pct"]
                             == metrics[f"sdf_agg_real_pair_pct.{cell[7:]}"])
    rec["real_pairs"] = profiling.real_pairs()
    spans = profiling.spans()
    top = sum(s.end_ns - s.start_ns for s in spans if s.parent == -1)
    rec["top_span_share_of_window"] = top * 1e-9 / run.trace["window_s"]
    if cell.endswith("train"):
        rec["layers_share_of_step"] = (
            sum(metrics[n] for n in LAYERS) / metrics["host_step_ms.train"])
    rec["spans"] = profiling.span_table(spans)

    trainer = run.state["trainer"]
    if cell.endswith("train"):
        def fn():
            trainer.run(spec["mix"]["traced_steps"],
                        window=spec["mix"]["window"])
    else:
        def fn():
            entry._render(run, 0)
    rec["session"] = _session_summary(fn, run.sync)
    turns = []
    for i in range(pairs):
        for on in ((True, False) if i % 2 == 0 else (False, True)):
            _forced_off(on)
            try:
                s = _session_summary(fn, run.sync)
            finally:
                _forced_off(True)
            turns.append({"recorder": on, "window_s": s["window_s"],
                          "kernels": s["kernels"]})
    rec["on_off"] = turns
    for on in (True, False):
        w = [t["window_s"] for t in turns if t["recorder"] == on]
        rec[f"window_s_median_{'on' if on else 'off'}"] = (
            statistics.median(w) if w else None)
    logdir = os.path.join(out, f"{cell}_trace")
    with profiling.trace(logdir):
        fn()
        run.sync()
    with open(os.path.join(logdir, "summary.json")) as f:
        summary = json.load(f)
    os.unlink(os.path.join(logdir, "trace.json"))     # too large to keep
    launches = summary["launches_by_top_span"]
    total = sum(launches.values())
    inside = sum(v for k, v in launches.items()
                 if k in ("trainer.step", "readback", "render.image"))
    rec["trace_launch_share_in_units"] = inside / total if total else None
    rec["trace_idle_s"] = summary["idle_s"]
    rec["trace_units"] = summary["units"]
    run.state.pop("trainer", None)
    torch.cuda.empty_cache()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=2400000101)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--cells", default="dtu_pn.train,dtu_pn.render")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    emit(args.out, "clock", clock_phase())
    for i, cell in enumerate(args.cells.split(",")):
        emit(args.out, cell, cell_phase(cell, args.seed + i, args.seconds,
                                        args.pairs, args.out))
    # last: the next session would first free its 10**6 spans
    emit(args.out, "cost", cost_phase())
    return 0


if __name__ == "__main__":
    sys.exit(main())
