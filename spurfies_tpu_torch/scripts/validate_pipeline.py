"""End-to-end quality check on the analytic sphere (counterpart of
``scripts/validate_pipeline.py``).

It runs the pipeline as a real scene would: the repo's pretrained local
prior, the per-scene latents trained for ``--steps`` steps at 1024 rays,
the mesh of ``field.sdf_probe`` (K1 + K2) measured against the true radius,
again at the self-calibrated iso level, and the masked PSNR of view 0
(K1-K3).  It prints the JAX script's JSON keys.  Everything runs on the
card unless ``--device cpu`` is given.

    python -m spurfies_tpu_torch.scripts.validate_pipeline [--steps 2000] \\
        [--prior spurfies_tpu_torch/assets/local_prior.npz] \\
        [--resolution 128] [--tag TAG] [--device cuda|cpu] [key.path=value ...]
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from spurfies_tpu_torch.cli.evaluate import make_sdf_fn
from spurfies_tpu_torch.config import (
    Config,
    ModelConfig,
    TrainConfig,
    apply_overrides,
)
from spurfies_tpu_torch.convert.from_jax import PRIOR_ASSET, load_prior_npz
from spurfies_tpu_torch.data.synthetic import make_synthetic_scene
from spurfies_tpu_torch.device import resolve_device
from spurfies_tpu_torch.eval.mesh_extract import (
    calibrate_iso_level,
    extract_mesh,
)
from spurfies_tpu_torch.train.trainer import Trainer

RADIUS = 0.5
IMG_RES = (128, 128)
BOX = ([-0.8, -0.8, -0.8], [0.8, 0.8, 0.8])


def build(overrides=(), prior=PRIOR_ASSET, device="cuda"):
    """The sphere scene and its ``Trainer`` (the prior's matmuls in bf16 on
    the card, f32 on the CPU) with the prior at ``prior`` when that file
    exists.  Returns ``(trainer, views, "pretrained" or "random")``."""
    cfg = Config(model=ModelConfig(),
                 train=TrainConfig(num_pixels=1024, fast_iters=1))
    cfg = apply_overrides(cfg, list(overrides))
    pts, cols, views = make_synthetic_scene(
        n_points=8000, n_views=3, img_res=IMG_RES, radius=RADIUS)
    trainer, tag = make_trainer(cfg, pts, cols, views, prior,
                                resolve_device(device))
    return trainer, views, tag


def make_trainer(cfg, pts, cols, views, prior, device):
    """A ``Trainer`` on the scene (the prior's matmuls in bf16 on the card,
    f32 on the CPU) with the prior at ``prior`` when that file exists.
    Returns ``(trainer, "pretrained" or "random")``."""
    trainer = Trainer(cfg, pts, cols, views, device=device,
                      compute_dtype=(torch.bfloat16 if device.type == "cuda"
                                     else torch.float32))
    if prior is not None and os.path.isfile(prior):
        trainer.load_frozen(load_prior_npz(prior, device))
        return trainer, "pretrained"
    return trainer, "random"


def train(trainer, steps):
    """``steps`` training steps in windows of up to 500; returns (wall s,
    [(step, rgb_loss, psnr)] at each window's end)."""
    losses = []
    t0 = time.perf_counter()
    trainer.run(steps, window=min(500, steps),
                callback=lambda s, m: losses.append(
                    (s, float(m["rgb_loss"]), float(m["psnr"]))))
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
    return time.perf_counter() - t0, losses


def _radius_errors(verts, radius):
    if not len(verts):
        return float("nan"), float("nan")
    r = np.linalg.norm(verts, axis=-1)
    return float(np.mean(np.abs(r - radius))), float(np.mean(r - radius))


def measure(trainer, views, resolution=128, radius=RADIUS):
    """The JAX script's measurements (``scripts/validate_pipeline.py:73-122``)
    of ``trainer``'s current state: the mesh at level 0 and at the
    calibrated level against the sphere (mean |r - radius| and the signed
    mean), and the masked PSNR of view 0.  Unrounded."""
    sdf_fn = make_sdf_fn(trainer)
    verts, _ = extract_mesh(sdf_fn, *BOX, resolution=resolution,
                            device=trainer.device)
    err, bias = _radius_errors(verts, radius)
    iso = calibrate_iso_level(trainer.scene.points, sdf_fn)
    verts_c, _ = extract_mesh(sdf_fn, *BOX, resolution=resolution,
                              level=iso, device=trainer.device)
    err_c, bias_c = _radius_errors(verts_c, radius)

    h, w = IMG_RES
    out = trainer.render_image(views["uv"], trainer.views["pose"][0],
                               trainer.views["intrinsics"][0])
    pred = out["rgb_values"].reshape(h, w, 3)
    gt = np.asarray(views["rgb"][0]).reshape(h, w, 3)
    mask = np.asarray(views["mask"][0]).reshape(h, w, 1) > 0.5
    mse = float(np.mean(((pred - gt) ** 2)[np.repeat(mask, 3, -1)]))
    return {"mesh_verts": int(len(verts)), "mesh_mean_radius_err": err,
            "mesh_signed_bias": bias, "auto_iso_level": iso,
            "mesh_err_auto_iso": err_c, "mesh_bias_auto_iso": bias_c,
            "masked_psnr": -10 * np.log10(mse + 1e-12)}


def main(argv=None):
    """Parse ``argv``, train and measure; prints and returns the JSON
    summary (rounded as the JAX script rounds it)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--prior", default=str(PRIOR_ASSET))
    ap.add_argument("--resolution", type=int, default=128)
    ap.add_argument("--tag", default="", help="echoed into the JSON output")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("overrides", nargs="*",
                    help="dotted config overrides, e.g. "
                         "loss.fd_eikonal_weight=0.01")
    args = ap.parse_args(argv)

    trainer, views, prior = build(args.overrides, args.prior, args.device)
    train_time, losses = train(trainer, args.steps)
    m = measure(trainer, views, args.resolution)
    summary = {
        "tag": args.tag,
        "prior": prior,
        "steps": args.steps,
        "train_time_s": round(train_time, 1),
        "rays_per_sec": round(args.steps * trainer.cfg.train.num_pixels
                              / train_time, 0),
        "final_rgb_loss": losses[-1][1] if losses else None,
        "mesh_verts": m["mesh_verts"],
        **{k: round(m[k], 5) for k in (
            "mesh_mean_radius_err", "mesh_signed_bias", "auto_iso_level",
            "mesh_err_auto_iso", "mesh_bias_auto_iso")},
        "masked_psnr": round(m["masked_psnr"], 2),
    }
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
