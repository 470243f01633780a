"""Evaluation CLI -- mesh extraction + NVS metrics (port of
``spurfies_tpu/cli/evaluate.py``).

Reference surface: ``python eval_spurfies.py --conf dtu_pn --scan_ids 24
--eval_mesh --eval_rendering`` (eval_spurfies.py:377-515).  Here:

    python -m spurfies_tpu_torch.cli.evaluate --config configs/dtu_pn.yaml \\
        --scans scan24 --mesh --rendering [--resolution 512] [--auto-iso] \\
        [--max-views N] [--eval-ids ...] [--device cuda|cpu]

It restores the latest checkpoint of each scan (``cli.train``'s experiment
directory), extracts the mesh by probing the SDF (K1 + K2) on a grid and
renders the eval views (K1, K2, K3).  Everything runs on the card unless
``--device cpu`` asks for the plain PyTorch path.
"""

import argparse
import json
import os

import numpy as np
import torch

from spurfies_tpu_torch.cli.train import apply_scene_overrides, load_scene_data
from spurfies_tpu_torch.config import Config, apply_overrides, load_yaml
from spurfies_tpu_torch.device import resolve_device
from spurfies_tpu_torch.eval import lpips, mesh_extract, nvs
from spurfies_tpu_torch.model import field
from spurfies_tpu_torch.train.trainer import Trainer
from spurfies_tpu_torch.utils.experiment import ExperimentDir, get_logger

log = get_logger()

DEFAULT_SCANS = {
    # eval_spurfies.py:446-452
    "dtu": ["21", "24", "34", "37", "38", "40", "82", "106", "110", "114",
            "118"],
    "mipnerf": ["garden", "stump"],
}


def make_sdf_fn(trainer):
    """``x [M, 3] -> sdf [M]`` of the trainer's field at its current
    params: ``field.sdf_probe`` without the gradient (K1 + K2, the default
    probe budget), 1000 in empty space."""
    m = trainer.cfg.model

    def sdf_fn(x):
        with torch.no_grad():
            return field.sdf_probe(
                trainer.prior, trainer.state.params["feats_geometry"],
                trainer.scene, x, m.k, m.r, m.rbf, need_grad=False)
    return sdf_fn


def mesh_bounds(cfg: Config, scan: str, scale_mat):
    """The probe grid's bounds in normalized space: DTU's ``bbs.npz`` box,
    mip-NeRF's fixed bounds, else the model's scene box."""
    bbs_path = os.path.join(cfg.dataset.data_dir_root, "dtu", "bbs.npz")
    if cfg.dataset.data_dir == "dtu" and os.path.exists(bbs_path):
        return mesh_extract.grid_bounds_dtu(
            bbs_path, int(scan.replace("scan", "")), scale_mat)
    if cfg.dataset.data_dir == "mipnerf":
        return mesh_extract.MIPNERF_BOUNDS[scan]
    return np.asarray(cfg.model.scene_lo), np.asarray(cfg.model.scene_hi)


def eval_scene(cfg: Config, scan: str, do_mesh: bool, do_render: bool,
               resolution: int = 512, out_root: str = "results",
               max_views=None, auto_iso: bool = False, eval_ids=None,
               device="cuda"):
    """Evaluate one scan's latest checkpoint; writes ``summary.json`` (and
    the mesh PLY, the eval PNGs) under ``out_root/<expname>_<scan>`` and
    returns the summary."""
    dev = resolve_device(device)
    compute_dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    cfg = apply_scene_overrides(cfg, scan)
    sd = load_scene_data(cfg, scan)
    trainer = Trainer(cfg, sd.points, sd.colors, sd.train_views(),
                      device=dev, compute_dtype=compute_dtype)

    exp = ExperimentDir.latest(cfg.exps_folder, cfg.expname, scan)
    if exp is None:
        raise FileNotFoundError(
            f"no checkpoint for {cfg.expname}_{scan} under {cfg.exps_folder}"
        )
    trainer.restore_checkpoint(exp.checkpoint_path("latest"))
    log.info(f"{scan}: restored step {int(trainer.state.step)}")

    out_dir = os.path.join(out_root, f"{cfg.expname}_{scan}")
    os.makedirs(out_dir, exist_ok=True)
    summary = {"scan": scan, "step": int(trainer.state.step)}

    if do_mesh:
        sdf_fn = make_sdf_fn(trainer)
        lo, hi = mesh_bounds(cfg, scan, sd.scale_mat)
        level = 0.0
        if auto_iso or cfg.eval.auto_iso:
            # extraction-level debias of the pseudo-loss depth skew
            level = mesh_extract.calibrate_iso_level(trainer.scene.points,
                                                     sdf_fn)
            summary["auto_iso_level"] = level
            log.info(f"{scan}: auto-calibrated iso level {level:+.4f}")
        verts, faces = mesh_extract.extract_mesh(
            sdf_fn, lo, hi, resolution=resolution, scale_mat=sd.scale_mat,
            level=level, device=dev)
        mesh_path = os.path.join(out_dir, f"mesh_{scan}.ply")
        mesh_extract.save_mesh_ply(mesh_path, verts, faces)
        summary["mesh"] = {"path": mesh_path, "n_verts": int(len(verts)),
                           "n_faces": int(len(faces))}
        log.info(f"{scan}: mesh {len(verts)} verts -> {mesh_path}")

    if do_render:
        lpips_fn = lpips.make_lpips_fn(device=dev)
        if lpips_fn is None:
            log.info(f"{scan}: LPIPS weights not found under ckpt/ -- "
                     "reporting PSNR/SSIM only")
        res = nvs.evaluate_views(trainer.render_image, sd, out_dir=out_dir,
                                 lpips_fn=lpips_fn, max_views=max_views,
                                 view_ids=eval_ids)
        summary["eval_ids"] = list(res["ids"])
        summary["nvs"] = {k: res[k] for k in
                          ("mean_psnr", "mean_ssim", "psnr", "ssim", "lpips")}
        if lpips_fn is None:
            summary["nvs"]["lpips_skipped_reason"] = \
                res["lpips_skipped_reason"]
        else:
            summary["nvs"]["mean_lpips"] = res["mean_lpips"]
        log.info(f"{scan}: PSNR {res['mean_psnr']:.2f} "
                 f"SSIM {res['mean_ssim']:.4f}"
                 + (f" LPIPS {res['mean_lpips']:.4f}"
                    if "mean_lpips" in res else ""))

    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def main(argv=None):
    """Parse ``argv`` and evaluate each scan; returns the summaries."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument("--scans", default=None)
    ap.add_argument("--mesh", action="store_true")
    ap.add_argument("--rendering", action="store_true")
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--max-views", type=int, default=None,
                    help="cap the number of eval views rendered")
    ap.add_argument("--eval-ids", default=None,
                    help="comma-separated view ids to score (subset of "
                         "the eval split); default = protocol order")
    ap.add_argument("--auto-iso", action="store_true",
                    help="extract at the self-calibrated iso level "
                         "(debiases the pseudo-loss depth skew)")
    ap.add_argument("--out", default="results")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    cfg = load_yaml(args.config) if args.config else Config()
    cfg = apply_overrides(cfg, args.overrides)

    scans = (
        args.scans.split(",") if args.scans
        else DEFAULT_SCANS.get(cfg.dataset.data_dir,
                               [str(cfg.dataset.scan_id)])
    )
    summaries = [
        eval_scene(cfg, s.strip(), args.mesh, args.rendering,
                   args.resolution, args.out, max_views=args.max_views,
                   auto_iso=args.auto_iso,
                   eval_ids=(args.eval_ids.split(",") if args.eval_ids
                             else None),
                   device=args.device)
        for s in scans
    ]
    if any("nvs" in s for s in summaries):
        ps = [s["nvs"]["mean_psnr"] for s in summaries if "nvs" in s]
        log.info(f"GLOBAL mean PSNR over {len(ps)} scans: {np.mean(ps):.2f}")
    return summaries


if __name__ == "__main__":
    main()
