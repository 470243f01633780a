"""Production-budget run on the DUSt3R-like sphere (counterpart of
``scripts/run_100k.py``).

It trains ``data.synthetic.make_dust3r_like_scene(radius=0.8)`` (the
``bench.py`` scene, an analytic sphere, so the mesh error needs no ground
truth) for ``--steps`` steps at 1024 rays with the repo's prior and writes
the JAX script's record:

  * a checkpoint every ``train.checkpoint_freq`` (15k) steps,
  * a simulated kill at ``--kill-at`` (45k): the Trainer is torn down,
    built again from the cloud, the views and the prior, and restored from
    the latest checkpoint (the ``cli.train --resume`` path),
  * at each ``--eval-at`` step the mesh's mean radius error and bias at
    level 0 and at the calibrated iso level, the masked PSNR of view 0 and
    the same render with ``beta`` set to 0.003,
  * per window of ``--window`` steps the step time, loss, rgb_loss, PSNR,
    |beta|, the cosine schedule's lr and the overflow counters.

Everything runs on the card unless ``--device cpu`` is given.  A
``--prior`` that names no file is an error.

    python -m spurfies_tpu_torch.scripts.run_100k [--steps 100000] \\
        [--preset quality_beat] [--kill-at 45000] \\
        [--eval-at 30000 60000 100000] [--window 500] [--ckpt-dir DIR] \\
        [--out artifacts/run100k_torch.json] [--prior NPZ] \\
        [--device cuda|cpu] [--stop-at STEP] [--resume] [key.path=value ...]

A run may be split over two processes: ``--stop-at S`` stops after the
window that reaches step S, with a checkpoint written and the record saved
(the kill is left to the next process); ``--resume`` restores the latest
checkpoint in ``--ckpt-dir``, keeps the record's windows, evals and events
up to its step and goes on.  A resume at or past ``--kill-at`` is the kill.
``total_wall_s`` sums the processes' walls.
"""

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from spurfies_tpu_torch.cli.evaluate import make_sdf_fn
from spurfies_tpu_torch.config import (
    Config,
    ModelConfig,
    TrainConfig,
    apply_overrides,
)
from spurfies_tpu_torch.convert.from_jax import PRIOR_ASSET
from spurfies_tpu_torch.data.synthetic import make_dust3r_like_scene
from spurfies_tpu_torch.device import resolve_device
from spurfies_tpu_torch.eval.mesh_extract import (
    calibrate_iso_level,
    extract_mesh,
)
from spurfies_tpu_torch.scripts.validate_pipeline import make_trainer
from spurfies_tpu_torch.train.optim import cosine_lr

REPO = Path(__file__).resolve().parents[2]
RADIUS = 0.8
BOX = ([-1, -1, -1], [1, 1, 1])
BETA_DIAG = 0.003


def build_trainer(cfg, pts, cols, views, prior, device):
    """A ``Trainer`` on the scene with the prior at ``prior``, which must
    exist (the JAX script trains on a random prior when it is missing)."""
    if not os.path.isfile(prior):
        raise FileNotFoundError(f"--prior {prior}: no such file")
    return make_trainer(cfg, pts, cols, views, prior, device)[0]


def _masked_psnr(rgb, gt, mask):
    mse = float(np.mean((rgb[mask] - gt[mask]) ** 2))
    return round(float(-10.0 * np.log10(max(mse, 1e-12))), 2)


def evaluate(trainer, radius=RADIUS, resolution=128):
    """The JAX script's ``evaluate`` (``scripts/run_100k.py:42-106``) of
    ``trainer``'s current state, rounded as it rounds: ``mesh_err`` and
    ``mesh_bias`` (mean |r - radius| and mean r - radius of the mesh's
    vertices) at level 0 and, with ``_auto_iso``, at the calibrated level
    ``iso_level``; ``masked_psnr`` of view 0; ``masked_psnr_beta3e3``, the
    same render with ``beta`` set to 0.003 on a copy of the parameters."""
    sdf_fn = make_sdf_fn(trainer)
    out = {}
    for tag, level in (("", 0.0), ("_auto_iso", None)):
        lv = (calibrate_iso_level(trainer.scene.points, sdf_fn)
              if level is None else level)
        verts, _ = extract_mesh(sdf_fn, *BOX, resolution=resolution,
                                level=lv, device=trainer.device)
        if len(verts):
            r = np.linalg.norm(verts, axis=-1)
            out[f"mesh_err{tag}"] = round(float(np.mean(np.abs(r - radius))),
                                          5)
            out[f"mesh_bias{tag}"] = round(float(np.mean(r - radius)), 5)
        else:
            out[f"mesh_err{tag}"] = out[f"mesh_bias{tag}"] = None
        if level is None:
            out["iso_level"] = round(float(lv), 6)

    rgb, rgb_diag, gt, mask = view0_renders(trainer)
    out["masked_psnr"] = _masked_psnr(rgb, gt, mask)
    out["masked_psnr_beta3e3"] = _masked_psnr(rgb_diag, gt, mask)
    return out


def view0_renders(trainer):
    """View 0 rendered with the current parameters and with ``beta`` set
    to ``BETA_DIAG`` on a copy of them (the beta-floor diagnostic: a beta
    the quadrature resolves); returns ``(rgb, rgb_diag, gt, mask)``, each
    per pixel, on the host."""
    view = 0
    uv = trainer.views["uv"].cpu().numpy()
    pose = trainer.views["pose"][view]
    K = trainer.views["intrinsics"][view]
    gt = trainer.views["rgb"][view].reshape(-1, 3).cpu().numpy()
    mask = trainer.views["mask"][view].reshape(-1).cpu().numpy() > 0.5
    ro = trainer.render_image(uv, pose, K)
    tp = dict(trainer.state.params)
    tp["beta"] = torch.full_like(tp["beta"], BETA_DIAG)
    ro2 = trainer._render(tp, trainer.scene, trainer.frozen, uv, pose, K)
    return ro["rgb_values"], ro2["rgb_values"], gt, mask


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100_000)
    ap.add_argument("--preset", default=None)
    ap.add_argument("--kill-at", type=int, default=45_000)
    ap.add_argument("--eval-at", type=int, nargs="+",
                    default=(30_000, 60_000, 100_000))
    ap.add_argument("--window", type=int, default=500)
    ap.add_argument("--prior", default=str(PRIOR_ASSET))
    ap.add_argument("--ckpt-dir", default=str(
        REPO / "spurfies_tpu_torch" / "build" / "run100k_ckpts"))
    ap.add_argument("--out", default=str(REPO / "artifacts"
                                         / "run100k_torch.json"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("--stop-at", type=int, default=None,
                    help="stop after the window that reaches this step, "
                         "with a checkpoint written")
    ap.add_argument("--resume", action="store_true",
                    help="continue an interrupted run: restore the latest "
                         "checkpoint in --ckpt-dir and append to --out")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    if args.stop_at is not None and not 0 < args.stop_at < args.steps:
        ap.error(f"--stop-at must lie in (0, {args.steps})")
    return args


def latest_step(ckpt_dir):
    return max((int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                if d.startswith("step_")), default=None)


def main(argv=None):
    """Run (or continue) the run; returns the record."""
    args = parse(argv)
    dev = resolve_device(args.device)
    cfg = Config(model=ModelConfig(),
                 train=TrainConfig(num_pixels=1024, fast_iters=1))
    ovs = list(args.overrides)
    if args.preset:
        ovs = [f"preset={args.preset}"] + ovs
    if ovs:
        cfg = apply_overrides(cfg, ovs)

    pts, cols, views = make_dust3r_like_scene(radius=RADIUS)
    trainer = build_trainer(cfg, pts, cols, views, args.prior, dev)
    sched = cosine_lr(cfg.train.learning_rate, cfg.train.cosine_t_max,
                      cfg.train.cosine_eta_min)

    os.makedirs(args.ckpt_dir, exist_ok=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    record = {"preset": args.preset, "steps": args.steps,
              "calibrated_ray_budget": trainer.cfg.model.ray_budget_frac,
              "calibrated_probe_budget": trainer.cfg.model.probe_budget_frac,
              "windows": [], "evals": {}, "events": []}

    def ckpt_path(step):
        return os.path.join(args.ckpt_dir, f"step_{step}")

    def save():
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)

    done, killed, wall_before = 0, False, 0.0
    if args.resume:
        latest = latest_step(args.ckpt_dir)
        if latest is None:
            raise SystemExit(f"--resume: no checkpoints in {args.ckpt_dir}")
        trainer.restore_checkpoint(ckpt_path(latest))
        done = int(trainer.state.step)
        if os.path.exists(args.out):
            with open(args.out) as f:
                prev = json.load(f)
            record["windows"] = [w for w in prev.get("windows", [])
                                 if w["step"] <= done]
            record["evals"] = {k: v for k, v in prev.get("evals", {}).items()
                               if int(k) <= done}
            record["events"] = prev.get("events", [])
            wall_before = prev.get("total_wall_s", 0.0)
        killed = any("kill+resume" in e.get("event", "")
                     for e in record["events"]) or done >= args.kill_at
        record["events"].append(
            {"step": done, "event": f"host-resume from {latest}"})
        print(f"[run100k] resuming at step {done}", flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t_wall = time.perf_counter()
    while done < args.steps:
        w = min(args.window, args.steps - done)
        t0 = time.perf_counter()
        metrics = {}
        trainer.run(w, window=w, callback=lambda s, m: metrics.update(m))
        sync()
        dt = time.perf_counter() - t0
        done += w
        step = int(trainer.state.step)
        record["windows"].append({
            "step": step,
            "ms_per_step": round(dt / w * 1e3, 2),
            "loss": round(float(metrics.get("loss", np.nan)), 5),
            "rgb_loss": round(float(metrics.get("rgb_loss", np.nan)), 5),
            "psnr": round(float(metrics.get("psnr", np.nan)), 2),
            "beta": round(abs(float(trainer.state.params["beta"].detach())),
                          5),
            "lr": round(float(sched(torch.tensor(step))), 6),
            "ray_overflow": float(metrics.get("ray_overflow", 0.0)),
            "probe_overflow": float(metrics.get("probe_overflow", 0.0)),
            "notfinite": float(metrics.get("notfinite", 0.0)),
        })
        stopping = args.stop_at is not None and step >= args.stop_at

        if (step % cfg.train.checkpoint_freq == 0 or step == args.steps
                or stopping):
            trainer.save_checkpoint(ckpt_path(step))
            record["events"].append({"step": step, "event": "checkpoint"})

        if not killed and step >= args.kill_at and not stopping:
            # simulated mid-run kill: build from scratch and restore the
            # latest checkpoint (the cli.train --resume path)
            latest = latest_step(args.ckpt_dir)
            del trainer
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            trainer = build_trainer(cfg, pts, cols, views, args.prior, dev)
            trainer.restore_checkpoint(ckpt_path(latest))
            done = int(trainer.state.step)
            killed = True
            record["events"].append({
                "step": step, "event": f"kill+resume from {latest}"})
            print(f"[run100k] killed at {step}, resumed from {latest}",
                  flush=True)

        if done in args.eval_at or (done == args.steps
                                    and args.steps not in args.eval_at):
            ev = evaluate(trainer)
            record["evals"][str(done)] = ev
            print(f"[run100k] eval@{done}: {ev}", flush=True)

        if stopping:
            break
        if len(record["windows"]) % 10 == 0:
            save()

    sync()
    record["total_wall_s"] = round(
        wall_before + time.perf_counter() - t_wall, 1)
    save()
    if done < args.steps:
        print(f"[run100k] stopped at step {done} of {args.steps}; continue "
              f"with --resume --ckpt-dir {args.ckpt_dir} --out {args.out}")
    else:
        print(f"[run100k] done in {record['total_wall_s']}s -> {args.out}")
    return record


if __name__ == "__main__":
    main()
