"""The program's recorder (``utils/profiling.py``) on the CPU: the spans of a
training step and of an image, their nesting and units, the shared clock
with the profiler's events, the idle gaps put on spans, the real-pair
counter against the benchmark's wrapper, ``trace(logdir)``'s files, and
the benchmark's metrics that read the recorder.

The recorder is a process-wide singleton: each test opens its own
profiler session and reads what that session recorded."""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark import trace as bench_trace
from spurfies_tpu_torch.config import Config, apply_overrides
from spurfies_tpu_torch.convert.from_jax import load_prior_npz
from spurfies_tpu_torch.data.mvs_local import LocalBundle
from spurfies_tpu_torch.data.synthetic import make_synthetic_scene
from spurfies_tpu_torch.ops import gather_rows, pair_mlp  # noqa: F401
from spurfies_tpu_torch.train.trainer import Trainer
from spurfies_tpu_torch.utils import profiling

TINY = ["model.max_shading_pts=24", "model.color_top_samples=8",
        "model.ray_sampler.n_samples=16",
        "model.ray_sampler.n_samples_eval=32",
        "model.ray_sampler.n_samples_extra=8", "train.num_pixels=128",
        "train.render_chunk=256", "loss.local_weight=0.5"]
STEP_SPANS = {"trainer.step", "trainer.backward", "optim.step", "losses",
              "local_loss", "sampler.z_vals", "field.probe", "field.sdf",
              "field.color", "readback"}
IMAGE_SPANS = {"render.image", "render.occupancy", "readback",
               "sampler.z_vals", "field.probe", "field.sdf", "field.color"}
TRAIN_METRICS = ["host_step_ms.train", "sampler_host_ms.train",
                 "field_host_ms.train", "loss_host_ms.train",
                 "backward_host_ms.train", "optim_host_ms.train",
                 "readback_wait_ms.train", "sdf_agg_real_pair_pct.train"]
RENDER_METRICS = ["sampler_host_ms.render", "field_host_ms.render",
                  "readback_wait_ms.render", "sdf_agg_real_pair_pct.render"]
CPU = [torch.profiler.ProfilerActivity.CPU]


def _bundle(views, h, w):
    """A local bundle on the scene's three views: features a smooth
    function of each view's image, the hd cameras its w2c and 2x its
    intrinsics, the identity world frame (the synthetic bundle of
    ``tests/test_torch_local_loss.py``)."""
    rgb = np.asarray(views["rgb"]).reshape(-1, h, w, 3)
    a = np.random.default_rng(4).normal(size=(3, 32)).astype(np.float32)
    cams = np.zeros((3, 2, 4, 4), np.float32)
    for i in range(3):
        cams[i, 0] = np.linalg.inv(views["pose"][i])
        cams[i, 1] = views["intrinsics"][i]
        cams[i, 1, :2] *= 2.0
    return LocalBundle(feats=torch.from_numpy(np.tanh(rgb @ a + 0.3)),
                       cams_hd=torch.from_numpy(cams), size=2.0,
                       center=torch.zeros(3))


@pytest.fixture(scope="module")
def world():
    h, w = 24, 32
    pts, cols, views = make_synthetic_scene(n_points=1500, n_views=3,
                                            img_res=(h, w))
    cfg = apply_overrides(Config(), TINY)
    trainer = Trainer(cfg, pts, cols, views, device="cpu",
                      local_bundle=_bundle(views, h, w),
                      compute_dtype=torch.float32)
    trainer.run(1, window=1)
    return trainer, views


def _traced_steps(trainer, n=2):
    with torch.profiler.profile(activities=CPU):
        trainer.run(n, window=n)
    return profiling.spans()


def _traced_image(trainer, views):
    with torch.profiler.profile(activities=CPU):
        trainer.render_image(views["uv"], views["pose"][0],
                             views["intrinsics"][0])
    return profiling.spans()


def _nested(spans):
    """Every span closed, inside its parent, in its parent's unit."""
    for s in spans:
        assert s.end_ns >= s.start_ns > 0
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            if s.name not in ("trainer.step", "render.image"):
                assert s.unit == p.unit


def test_a_training_step_records_the_span_set(world):
    trainer, _ = world
    spans = _traced_steps(trainer, 2)
    assert {s.name for s in spans} == STEP_SPANS
    _nested(spans)
    steps = [s for s in spans if s.name == "trainer.step"]
    assert [s.unit for s in steps] == [0, 1]
    assert all(s.parent == -1 for s in steps)
    for s in spans:
        if s.name == "readback":         # the window's, after its last step
            assert s.parent == -1 and s.unit == 1
        elif s.name != "trainer.step":
            top = s
            while top.parent >= 0:
                top = spans[top.parent]
            assert top.name == "trainer.step" and top.unit == s.unit
    probes = [spans[s.parent].name for s in spans if s.name == "field.probe"]
    assert set(probes) == {"sampler.z_vals", "losses"}
    # no span of one metric's set nests inside another of the same set
    for names in (("field.sdf", "field.color"), ("losses", "local_loss")):
        for s in spans:
            if s.name in names and s.parent >= 0:
                assert spans[s.parent].name not in names


def test_an_image_records_the_span_set(world):
    trainer, views = world
    spans = _traced_image(trainer, views)
    assert {s.name for s in spans} == IMAGE_SPANS
    _nested(spans)
    assert spans[0].name == "render.image" and spans[0].parent == -1
    assert {s.unit for s in spans} == {0}
    backs = [spans[s.parent].name for s in spans if s.name == "readback"]
    assert sorted(backs) == ["render.image", "render.occupancy"]


def test_without_a_profiler_nothing_is_recorded_or_held(world):
    trainer, views = world
    spans = _traced_steps(trainer, 1)
    before = list(spans)
    trainer.run(1, window=1)
    trainer.render_image(views["uv"][:256], views["pose"][0],
                         views["intrinsics"][0])
    assert profiling.spans() == before
    assert profiling._REC._held == []
    assert profiling.span("x") is profiling.unit("y") is profiling._NULL


def test_spans_share_the_profilers_clock():
    """A kineto event's ``start_ns``/``end_ns`` lie inside the span the
    host was in: both are on ``time.time_ns()``'s clock."""
    a = torch.randn(128, 128)
    with torch.profiler.profile(activities=CPU) as prof:
        with profiling.unit("outer"):
            with profiling.span("inner"):
                a @ a
    inner = profiling.spans()[1]
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert len(mm) == 1
    assert inner.start_ns <= mm[0].start_ns() <= mm[0].end_ns() \
        <= inner.end_ns


def test_a_new_session_replaces_the_last():
    with torch.profiler.profile(activities=CPU):
        with profiling.unit("a"):
            pass
    assert [s.name for s in profiling.spans()] == ["a"]
    with torch.profiler.profile(activities=CPU):
        with profiling.unit("b"):
            with profiling.span("c"):
                pass
    assert [s.name for s in profiling.spans()] == ["b", "c"]
    assert [s.parent for s in profiling.spans()] == [-1, 0]


def test_spans_past_the_cap_are_dropped_and_counted(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_CAP", 3)
    with torch.profiler.profile(activities=CPU):
        with profiling.unit("u"):
            for _ in range(4):
                with profiling.span("s"):
                    pass
    assert [s.name for s in profiling.spans()] == ["u", "s", "s"]
    assert profiling._REC.dropped == 2
    assert all(s.end_ns for s in profiling.spans())


def _span(name, start_us, end_us, parent=-1):
    s = profiling.Span(name, int(start_us * 1000) + 7_000_000, parent, 0)
    s.end_ns = int(end_us * 1000) + 7_000_000
    return s


def test_idle_by_span_follows_the_midpoint_rule():
    spans = [_span("step", 0, 100), _span("sampler", 10, 40, 0),
             _span("probe", 20, 30, 1), _span("readback", 120, 130)]
    dev = [("k", 0, 12), ("k", 18, 22), ("k", 26, 50), ("k", 45, 60),
           ("k", 104, 110), ("k", 134, 150), ("k", 149, 160)]
    idle = profiling.idle_by_span(dev, spans, origin_ns=7_000_000)
    # gaps 12-18 (mid 15: sampler), 22-26 (24: probe), 60-104 (82: step),
    # 110-134 (122: readback); the overlaps leave none
    assert idle == pytest.approx({"sampler": 6e-6, "probe": 4e-6,
                                  "step": 44e-6, "readback": 24e-6})
    red = bench_trace.reduce(dev, [], 1.0)
    gaps_s = (160 - 0) * 1e-6 - red["busy_s"]
    assert sum(idle.values()) == pytest.approx(gaps_s, rel=1e-12)
    outside = profiling.idle_by_span([("k", 0, 1), ("k", 300, 301)], spans,
                                     origin_ns=7_000_000)
    assert outside == pytest.approx({profiling.OUTSIDE: 299e-6})


def test_idle_by_span_total_is_the_benchmarks_on_random_intervals():
    rng = np.random.default_rng(3)
    starts = np.sort(rng.uniform(0, 1e4, 400))
    dev = [("k", float(s), float(s + d))
           for s, d in zip(starts, rng.uniform(1, 40, 400))]
    spans = [_span("step", 0, 5000), _span("readback", 5000, 9000)]
    idle = profiling.idle_by_span(dev, spans, origin_ns=7_000_000)
    red = bench_trace.reduce(dev, [], 1.0)
    total = (max(e for _, _, e in dev) - dev[0][1]) * 1e-6 - red["busy_s"]
    assert sum(idle.values()) == pytest.approx(total, rel=1e-9)
    named = sum(v for _, v in red["breakdown"]["idle_gaps"])
    assert named == pytest.approx(total, rel=1e-9)     # one name: all gaps


def test_real_pairs_are_the_benchmarks_count(world):
    """The program's K3/K2 counter and the benchmark's ``PairCounter``,
    both installed, count the same launches, slots and real pairs."""
    trainer, views = world
    for run in (lambda: trainer.run(2, window=2),
                lambda: trainer.render_image(views["uv"], views["pose"][1],
                                             views["intrinsics"][1])):
        counter = bench_trace.PairCounter().install()
        try:
            with torch.profiler.profile(activities=CPU):
                run()
        finally:
            counter.remove()
        theirs = counter.launches()
        ours = profiling.real_pairs()
        for key in profiling.PAIR_KERNELS:
            assert ours[key] == (sum(t[0] for t in theirs[key]),
                                 sum(t[1] * t[2] for t in theirs[key]),
                                 len(theirs[key]))
            assert ours[key][2] > 0 and 0 < ours[key][0] < ours[key][1]
        assert profiling._REC._held == []


def test_pairs_past_the_cap_are_counted_at_once(monkeypatch):
    monkeypatch.setattr(profiling, "PAIR_CAP", 2)
    idx = torch.tensor([[0, 3, 5], [1, -1, 4]], dtype=torch.int32)
    with torch.profiler.profile(activities=CPU):
        for _ in range(3):
            profiling.hold_pairs("k2", idx, 5)
        assert len(profiling._REC._held) == 1
    assert profiling.real_pairs()["k2"] == (12, 18, 3)
    assert profiling.real_pair_pct() == pytest.approx(100 * 12 / 18)


def test_counters_are_one_registry():
    names = {"select_knn_packed", "select_knn_exact", "pair_sdf_value_agg",
             "pair_sdf_aggregate", "pair_sdf_aggregate_bwd",
             "pair_sdf_rows_grad", "pair_sdf_rows_value",
             "pair_sdf_value_and_input_grad", "pair_sdf_value",
             "scatter_add_rows", "gather_rows", "pack_color_weights",
             "fused_color_fwd", "fused_color_bwd"}
    assert names <= set(profiling.COUNTS)
    before = profiling.COUNTS["gather_rows"]
    profiling.count("gather_rows")
    assert profiling.COUNTS["gather_rows"] == before + 1
    profiling.COUNTS["gather_rows"] = before
    profiling.register("gather_rows")          # keeps the count
    assert profiling.COUNTS["gather_rows"] == before
    # the plain versions launch nothing
    layers = pair_mlp._prep_layers(load_prior_npz(device="cpu"),
                                   torch.float32)
    table = torch.zeros((4, 35))
    snap = dict(profiling.COUNTS)
    pair_mlp.pair_sdf_value_agg(table, torch.zeros((2, 8), dtype=torch.int32),
                                torch.zeros((2, 3)), layers, 45.0)
    assert profiling.COUNTS == snap


def test_trace_writes_spans_and_a_summary(world, tmp_path):
    trainer, _ = world
    with profiling.trace(str(tmp_path / "tr")) as d:
        trainer.run(2, window=2)
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    mine = [e for e in events if e.get("cat") == "program_span"]
    assert {e["name"] for e in mine} == STEP_SPANS
    mm = [e for e in events if e.get("name") == "aten::mm"]
    steps = [e for e in mine if e["name"] == "trainer.step"]
    assert mm and all(any(s["ts"] <= e["ts"] <= s["ts"] + s["dur"]
                          for s in steps) for e in mm)
    with open(os.path.join(d, "summary.json")) as f:
        summary = json.load(f)
    assert set(summary["spans"]) == STEP_SPANS
    step = summary["spans"]["trainer.step"]
    assert step["count"] == 2 and step["inclusive_ms"] > step["self_ms"] > 0
    assert summary["units"] == 2 and summary["dropped_spans"] == 0
    assert summary["idle_s"] == {}            # no device on the CPU
    assert summary["real_pairs"]["k3"][2] == 4      # the render, pseudo-SDF
    assert set(summary) >= {"calls_by_span", "launches_by_top_span",
                            "launches"}


@pytest.fixture(scope="module")
def metric_values(world):
    """Every new metric's reading from a fake run after a traced CPU window
    of its kind: two steps, one image."""
    trainer, views = world
    out = {}
    _traced_steps(trainer, 2)
    for name in TRAIN_METRICS:
        out[name] = harness.metric_reader(name)(
            SimpleNamespace(kind="train", trace={"units": 2}))
    _traced_image(trainer, views)
    for name in RENDER_METRICS:
        out[name] = harness.metric_reader(name)(
            SimpleNamespace(kind="render", trace={"units": 1}))
    return out


@pytest.mark.parametrize("name", TRAIN_METRICS + RENDER_METRICS)
def test_metric_reads_the_recorder(metric_values, name):
    v = metric_values[name]
    assert isinstance(v, float) and v > 0
    if "pct" in name:
        assert v < 100


def test_metrics_read_nothing_of_another_kind_or_untraced(world):
    for name in TRAIN_METRICS:
        read = harness.metric_reader(name)
        assert read(SimpleNamespace(kind="render",
                                    trace={"units": 1})) is None
        assert read(SimpleNamespace(kind="train", trace=None)) is None
    for name in RENDER_METRICS:
        read = harness.metric_reader(name)
        assert read(SimpleNamespace(kind="train",
                                    trace={"units": 1})) is None


def test_the_metrics_are_per_layer_entries_of_their_cell():
    bench = harness.load_json(harness.HERE.parent / "BENCHMARK.json")
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in TRAIN_METRICS + RENDER_METRICS:
        m = entries[name]
        kind = name.split(".")[1]
        assert m["workloads"] == [f"dtu_pn.{kind}"]
        assert m["moves"] == f"{kind}_rays_per_s"
        assert m["source"] == ("program_counter" if "pct" in name
                               else "program_span")
        assert m["better"] == ("higher" if "pct" in name else "lower")
