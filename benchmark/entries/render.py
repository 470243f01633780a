"""The novel-view entry: ``Trainer.render_image`` (``make_render_fn``) on
full images, one at a time, cycling through the mix's eval views.

Set-up builds the ``Trainer`` on the cell's train views with the weights
that the benchmark made from the seed (the colour MLPs' scaled by the mix's
``color_weight_gain``, so that colour varies over the image), and warms up
on one chunk's rays from the middle of the first view, which hit the scene
(every chunk of an image has the same shape).  The window renders images
until ``--seconds`` have passed; each image ends in its readback.  The
check draws from the seed a few chunks of one finished image and renders
them with the reference (:mod:`benchmark.plain.check_render`).
"""

import time

import numpy as np
import torch

from benchmark import trace as trace_mod
from benchmark.entries.train import build_trainer, memory_peak  # noqa: F401
from benchmark.scenes import make_synthetic_scene


def setup(run):
    conf, mix = run.config, run.mix
    trainer = build_trainer(run, local=False,
                            color_gain=mix.get("color_weight_gain", 1.0))
    kw = dict(conf["scene"]["kwargs"], view_ids=mix["views"], images=False)
    _, _, ev = make_synthetic_scene(**kw)
    run.state["eval"] = ev
    run.state["trainer"] = trainer
    n, chunk = ev["uv"].shape[0], trainer.cfg.train.render_chunk
    mid = max(0, n // 2 - chunk // 2)
    trainer.render_image(ev["uv"][mid:mid + chunk], ev["pose"][0],
                         ev["intrinsics"][0])


def _render(run, i):
    ev = run.state["eval"]
    v = i % len(run.mix["views"])
    out = run.state["trainer"].render_image(ev["uv"], ev["pose"][v],
                                            ev["intrinsics"][v])
    return v, out


def window(run, seconds: float):
    outs = []
    times = []
    run.sync()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        ts = time.perf_counter()
        outs.append(_render(run, len(outs)))
        times.append(time.perf_counter() - ts)
    run.window_s = time.perf_counter() - t0
    run.units = len(outs)
    n_px = run.state["eval"]["uv"].shape[0]
    run.e2e["render_rays_per_s"] = run.units * n_px / run.window_s
    rng = np.random.default_rng(run.seed)
    pick = int(rng.integers(len(outs)))
    run.state["picked"] = outs[pick]
    run.log("image_times_s " + " ".join(f"{t:.4f}" for t in times))
    run.log(f"render_rays_per_s {run.e2e['render_rays_per_s']:.1f} "
            f"images {run.units} window_s {run.window_s:.3f}")


def trace(run):
    counter = trace_mod.PairCounter().install()
    n = run.mix["traced_images"]
    try:
        run.trace = trace_mod.profile(
            lambda: [_render(run, i) for i in range(n)], run.sync)
    finally:
        counter.remove()
    run.counters["pair_launches"] = counter.launches()
    run.trace["units"] = n
    run.device_kind = (torch.cuda.get_device_name(0) if run.device != "cpu"
                       else "cpu")


def release(run):
    run.state.pop("trainer", None)
    if run.device != "cpu":
        torch.cuda.empty_cache()


def check(run):
    from benchmark.plain.check_render import compare, reference_render

    v, out = run.state["picked"]
    inputs = dict(run.state["inputs"], eval=run.state["eval"], view=v)
    rng = np.random.default_rng(run.seed + 1)
    rays, ref = reference_render(inputs, run.device, rng,
                                 run.mix["checked_chunks"])
    limits = run.spec["limits"]
    return [(name, val, limits[name])
            for name, val in compare(out, rays, ref) if name in limits]
