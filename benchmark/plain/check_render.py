"""The plain reference of a render cell and the numbers it compares.

:func:`reference_render` rebuilds the scene, calibrates the budgets (an
eval render's probe budget is dense when the calibrated one is), prepares
the prior, takes the benchmark's weights and renders, in f32 with TF32 off
(or with the rounding of :mod:`benchmark.plain.precision`), chunks drawn
from the seed of the view that the program rendered, the chunks formed as
the program's renderer forms them.  :func:`compare` gives, over those chunks' rays:
  * ``rgb_gap_mean``: the mean of each ray's largest colour gap;
  * ``depth_gap_mean``: the mean depth gap, over the scene's far bound;
  * ``normal_gap_mean``: the mean length of the normal's difference;
  * ``acc_gap_mean``: the mean opacity gap;
  * ``mask_mismatch``: the share of rays whose hit mask differs.
"""

import dataclasses

import numpy as np
import torch

from benchmark.plain import precision
from benchmark.plain.check_train import load_prior, tree_from_paths
from benchmark.plain.config import config_from_dict
from benchmark.plain.model.neural_points import build_scene
from benchmark.plain.train.trainer import (
    calibrate_budgets,
    make_render_fn,
    prepare_prior,
)


def reference_render(inputs: dict, device, rng, n_chunks: int,
                     mode: str = "f32"):
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    precision.set_mode(mode)
    try:
        cfg = config_from_dict(inputs["config"])
        scene, _ = build_scene(inputs["points"], cfg.model, inputs["colors"],
                               device=device)
        if cfg.model.ray_budget_frac < 0 or cfg.model.probe_budget_frac < 0:
            ray_frac, probe_frac = calibrate_budgets(scene, inputs["views"],
                                                     cfg)
            upd = {}
            if cfg.model.ray_budget_frac < 0:
                upd["ray_budget_frac"] = ray_frac
            if cfg.model.probe_budget_frac < 0:
                upd["probe_budget_frac"] = probe_frac
            cfg = dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model, **upd))
        prior = prepare_prior(load_prior(inputs["prior"], device))
        tp = tree_from_paths(inputs["weights"], device)
        ev, v = inputs["eval"], inputs["view"]
        render = make_render_fn(cfg, device)

        def pick(n):
            return sorted(rng.choice(n, size=min(n_chunks, n),
                                     replace=False).tolist())

        return render(tp, scene, prior, ev["uv"], ev["pose"][v],
                      ev["intrinsics"][v], pick_chunks=pick)
    finally:
        precision.set_mode("f32")
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def compare(program: dict, rays, ref: dict, far: float = 4.5):
    keep = rays >= 0
    r = rays[keep]
    if r.size == 0:
        return [("rgb_gap_mean", 0.0), ("depth_gap_mean", 0.0),
                ("normal_gap_mean", 0.0), ("acc_gap_mean", 0.0),
                ("mask_mismatch", 0.0)]
    rgb = np.abs(program["rgb_values"][r] - ref["rgb_values"][keep]).max(1)
    depth = np.abs(program["depth_values"][r, 0]
                   - ref["depth_values"][keep, 0]) / far
    normal = np.linalg.norm(program["normal_map"][r]
                            - ref["normal_map"][keep], axis=1)
    acc = np.abs(program["acc"][r, 0] - ref["acc"][keep, 0])
    mask = program["ray_mask"][r] != ref["ray_mask"][keep]
    vals = [("rgb_gap_mean", float(rgb.mean())),
            ("depth_gap_mean", float(depth.mean())),
            ("normal_gap_mean", float(normal.mean())),
            ("acc_gap_mean", float(acc.mean())),
            ("mask_mismatch", float(mask.mean()))]
    return [(k, v if np.isfinite(v) else float("inf")) for k, v in vals]
