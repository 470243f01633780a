"""The training entry: ``Trainer.run`` windows of ``train_step`` on the
cell's configuration.

Set-up builds one ``Trainer`` on the cell's scene, installs the prior and
the weights that the benchmark made from the seed, and drives it through
the mix's ``checked_steps`` first steps by ``train_step`` itself, with the
batches and the sampler's draws that the benchmark made from the seed,
recording each step's loss, the first gradient as the optimizer got it
(its first moment after one step over 1 - b1) and the change of every
leaf over those steps.  Then ``warmup_steps`` more steps by
``Trainer.run``, and the window: ``Trainer.run`` calls of ``window`` steps
(one readback each) until ``--seconds`` have passed.  The reference
(:mod:`benchmark.plain.check_train`) takes the same scene, weights,
batches and draws after the window.
"""

import time

import torch

from benchmark import scenes, trace as trace_mod
from benchmark.flops import dense_train_step_flops, peak_tflops
from benchmark.weights import leaves, make_weights

B1 = 0.9        # the optimizers' first-moment decay


def make_scene(config: dict):
    sc = config["scene"]
    return getattr(scenes, sc["generator"])(**sc.get("kwargs", {}))


def _local_bundle(local, dev):
    """The program's local-loss bundle: its extractor (from the benchmark's
    weights) run on the benchmark's feature images."""
    from spurfies_tpu_torch.convert.torch_ckpt import convert_vismvsnet
    from spurfies_tpu_torch.data.mvs_local import LocalBundle

    featext = convert_vismvsnet(local["state"], dev)
    with torch.no_grad():
        _, _, f3 = featext(torch.from_numpy(local["images"]).to(dev))
    return LocalBundle(
        feats=f3.permute(0, 2, 3, 1).contiguous(),
        cams_hd=torch.from_numpy(local["cams_hd"]).to(dev),
        size=local["size"],
        center=torch.from_numpy(local["center"]).to(dev))


def build_trainer(run, local: bool = True, color_gain: float = 1.0):
    """The program's ``Trainer`` on the cell's scene, with the prior from
    its file and the benchmark's weights from the seed (``color_gain``: see
    :func:`benchmark.weights.make_weights`); records in
    ``run.state["inputs"]`` what the reference takes."""
    from spurfies_tpu_torch.config import config_from_dict
    from spurfies_tpu_torch.convert.from_jax import load_prior_npz
    from spurfies_tpu_torch.ops import cuda_build
    from spurfies_tpu_torch.train.trainer import Trainer

    from benchmark.plain.ops.downsample import voxel_downsample

    conf, dev = run.config, run.device
    if dev != "cpu":
        t = time.perf_counter()
        built = cuda_build.build()
        run.log(f"build_s {time.perf_counter() - t:.3f} {built}")
    pts, cols, views = make_scene(conf)
    cfg = config_from_dict(conf["config"])
    loc = None
    if local and "local" in conf:
        from benchmark.local import local_inputs
        loc = local_inputs(conf["local"], views,
                           conf["scene"]["kwargs"]["img_res"],
                           run.seed % (1 << 63))
    trainer = Trainer(cfg, pts, cols, views, device=dev,
                      local_bundle=(None if loc is None
                                    else _local_bundle(loc, dev)),
                      compute_dtype=getattr(torch, conf["compute_dtype"]))
    trainer.load_frozen(load_prior_npz(conf["prior"], device=dev))

    kept_pts, kept_cols, _ = voxel_downsample(pts, cfg.model.vox_res, cols)
    gen = torch.Generator(device=dev).manual_seed(run.seed % (1 << 63))
    weights = make_weights(conf["config"]["model"], kept_cols, gen, dev,
                           color_gain)
    prog = dict(leaves(trainer.state.params))
    for path, w in leaves(weights):
        prog[path].data.copy_(w)
    run.state["inputs"] = {
        "config": conf["config"], "prior": conf["prior"],
        "points": pts, "colors": cols, "views": views,
        "weights": {p: w.detach().cpu() for p, w in leaves(weights)},
        "local": loc, "steps": [],
        "program_points": trainer.scene.points.cpu().numpy()}
    run.state["gen"] = gen
    return trainer


def setup(run):
    from spurfies_tpu_torch.model.renderer import ray_budget

    mix, dev = run.mix, run.device
    trainer = build_trainer(run)
    cfg, gen = trainer.cfg, run.state["gen"]
    n_pix = cfg.train.num_pixels
    width = ray_budget(n_pix, cfg.model) or n_pix
    scfg = cfg.model.ray_sampler
    z_cols = scfg.n_samples_eval * max(cfg.train.fast_iters, 1)
    n_views = trainer.views["rgb"].shape[0]
    total_px = trainer.views["uv"].shape[0]
    before = {p: t.detach().clone() for p, t in leaves(trainer.state.params)}
    losses, rgb, grad = [], [], None
    for i in range(mix["checked_steps"]):
        v = torch.randint(0, n_views, (1,), generator=gen, device=dev)
        pix = torch.randperm(total_px, generator=gen, device=dev)[:n_pix]
        draws = {
            "u_z": torch.rand((width, scfg.n_samples_eval), generator=gen,
                              device=dev),
            "u_pdf": torch.rand((width, scfg.n_samples), generator=gen,
                                device=dev),
            "extra_cols": torch.randperm(z_cols, generator=gen,
                                         device=dev)[:scfg.n_samples_extra]}
        batch = trainer.sample_batch(trainer.views, None, v=v, pix=pix)
        parts = trainer.train_step(trainer.bundle, trainer.state,
                                   trainer.generator, draws=draws,
                                   batch=batch)
        losses.append(parts["loss"])
        rgb.append(parts["rgb_loss"])
        if i == 0:
            mu = trainer.state.opt_state.mu
            paths = [p for p, _ in leaves(trainer.state.params)]
            grad = {p: torch.linalg.norm(m) / (1.0 - B1)
                    for p, m in zip(paths, mu)}
            first = {p: m.detach().cpu() for p, m in zip(paths, mu)}
        run.state["inputs"]["steps"].append({
            "view": int(v), "pix": pix.cpu().numpy(),
            "draws": {k: t.cpu() for k, t in draws.items()}})
    delta = {p: torch.linalg.norm(t.detach() - before[p])
             for p, t in leaves(trainer.state.params)}
    run.state["program"] = {
        "loss": [float(x) for x in losses],
        "rgb_loss": [float(x) for x in rgb],
        "grad": {p: float(x) for p, x in grad.items()},
        "first_grad": first,
        "delta": {p: float(x) for p, x in delta.items()},
        "points": run.state["inputs"]["program_points"],
        "width": width}
    del before
    trainer.run(mix["warmup_steps"], window=mix["window"])
    run.state["trainer"] = trainer
    run.state["rays_per_step"] = n_pix


def window(run, seconds: float):
    trainer = run.state["trainer"]
    w = run.mix["window"]
    times = []
    run.sync()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        ts = time.perf_counter()
        trainer.run(w, window=w)       # ends in the window's readback
        times.append(time.perf_counter() - ts)
    run.window_s = time.perf_counter() - t0
    run.units = len(times) * w
    run.e2e["train_rays_per_s"] = (run.units * run.state["rays_per_step"]
                                   / run.window_s)
    run.log("window_times_s " + " ".join(f"{t:.4f}" for t in times))
    run.log(f"train_rays_per_s {run.e2e['train_rays_per_s']:.1f} "
            f"steps {run.units} window_s {run.window_s:.3f}")
    run.state["flops_per_step"] = dense_train_step_flops(
        run.config["config"]["model"], run.config["config"]["train"])


def memory_peak(run) -> int:
    if run.device == "cpu":
        return 0
    return torch.cuda.max_memory_allocated()


def trace(run):
    trainer = run.state["trainer"]
    steps = run.mix["traced_steps"]
    counter = trace_mod.PairCounter().install()
    try:
        run.trace = trace_mod.profile(
            lambda: trainer.run(steps, window=run.mix["window"]), run.sync)
    finally:
        counter.remove()
    run.counters["pair_launches"] = counter.launches()
    run.trace["units"] = steps
    run.device_kind = (torch.cuda.get_device_name(0) if run.device != "cpu"
                       else "cpu")
    run.log(f"trace busy_s {run.trace['busy_s']:.4f} window_s "
            f"{run.trace['window_s']:.4f} kernels {run.trace['kernels']}")


def release(run):
    run.state.pop("trainer", None)
    if run.device != "cpu":
        torch.cuda.empty_cache()


def check(run):
    from benchmark.plain.check_train import compare, reference_train

    ref = reference_train(run.state["inputs"], run.device,
                          run.state["program"]["width"])
    limits = run.spec["limits"]
    return [(name, v, limits[name])
            for name, v in compare(run.state["program"], ref)
            if name in limits]


def mfu(run):
    """The whole step's share of the bf16 peak, in percent, over the
    measured window."""
    if not run.units or run.device == "cpu":
        return None
    peak = peak_tflops(run.device_kind) * 1e12
    return (100.0 * run.state["flops_per_step"] * run.units
            / (run.window_s * peak))


def kernels_per_step(run):
    if run.trace is None:
        return None
    return run.trace["kernels"] / run.trace["units"]

