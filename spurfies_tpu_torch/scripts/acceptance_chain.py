"""End-to-end acceptance chain at the production budget (counterpart of
``scripts/acceptance_chain.py``).

It drives the port's CLIs -- ``cli.train`` (100k steps at 1024 rays) ->
``cli.evaluate --mesh --rendering`` -> ``cli.evaluate --rendering
--eval-ids 23,24,26,27`` (the near views) -> ``cli.eval_dtu`` -- on the
synthetic DTU scan 24 that ``data.synthetic.export_synthetic_dtu`` writes
(49 views, with its GT cloud), with the repo's prior, and writes one JSON
record: the keys of ``artifacts/acceptance_chain_r05.json`` (the JAX
package's chain), the device, the ``nvidia-smi`` name and power limit, the
train stage's rays/s and the probe budget's busiest chunk at the mesh's
grid.  Everything runs on the card unless ``--device cpu`` is given.

    python -m spurfies_tpu_torch.scripts.acceptance_chain [--steps 100000] \\
        [--img-res 192 256] [--mesh-resolution 512] [--max-views 4] \\
        [--workdir DIR] [--out artifacts/acceptance_chain_torch.json] \\
        [--device cuda|cpu] [--stop-at STEP] [--resume] [key.path=value ...]

Trailing overrides go after the chain's own (a smaller sampler for a quick
run on the CPU).  A run may be split over two processes: ``--stop-at S``
trains to step S of the ``--steps`` run, saves ``latest`` and stops before
the evaluation; ``--resume`` reuses the work directory's fixture and
continues its experiment from ``latest`` (``cli.train --resume``) to
``--steps``, then evaluates.  The split follows the same learning-rate
schedule (it reads ``train.cosine_t_max``; ``train.opt_steps`` only ends
the loop) but not the same draws: no checkpoint holds the random state, so
a resumed run draws from the seed again, as the JAX package's does.  The
stages done so far are kept in ``<workdir>/acceptance_chain.json``; the
record goes to ``--out`` when the chain is whole.
"""

import argparse
import contextlib
import json
import logging
import os
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
SCAN = "scan24"
NEAR_IDS = "23,24,26,27"
PROGRESS = "acceptance_chain.json"
# what cli.train logs when it loads spurfies_tpu_torch/assets/local_prior.npz
REPO_PRIOR = "loaded frozen local-geometry prior (the repo's pretrained prior)"
PRIOR_MESSAGES = ("local-geometry prior", "no local prior found")


def chain_overrides(steps, img_res):
    """The JAX chain's overrides (``scripts/acceptance_chain.py:49-61``)."""
    h, w = img_res
    return ["expname=dtu_pn", "dataset.data_dir=dtu",
            f"dataset.img_res=[{h},{w}]", "dataset.scan_id=24",
            "loss.local_weight=0",        # no Vis-MVSNet checkpoint
            f"train.opt_steps={steps}", "train.num_pixels=1024",
            "train.fast_iters=1", "train.render_freq=15000",
            "train.checkpoint_freq=15000"]


def device_strings(dev):
    """``(torch's device name, nvidia-smi's "name, power limit")``; the
    second is None on the CPU."""
    if dev.type != "cuda":
        return "cpu", None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return torch.cuda.get_device_name(dev), smi


class _Messages(logging.Handler):
    """Collects the messages of the port's logger."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@contextlib.contextmanager
def logged():
    from spurfies_tpu_torch.utils.experiment import get_logger

    logger, handler = get_logger(), _Messages()
    logger.addHandler(handler)
    try:
        yield handler.messages
    finally:
        logger.removeHandler(handler)


def probe_budget(cfg, resolution, device, chunk=262144, budget_frac=0.25):
    """The mesh probe's busiest chunk at ``resolution``: ``extract_mesh``
    probes the grid in chunks of ``chunk`` points through ``sdf_probe``,
    whose budget runs the first ``budget_frac`` of a chunk's occupied points
    and reads the rest as empty space.  The occupancy is the scene's fine
    bitmap, built from the cloud as ``build_scene`` builds it (training
    does not change it)."""
    from spurfies_tpu_torch.cli.evaluate import mesh_bounds
    from spurfies_tpu_torch.cli.train import load_scene_data
    from spurfies_tpu_torch.eval.mesh_extract import grid_axes, grid_points
    from spurfies_tpu_torch.model.neural_points import grid_spec_from_config
    from spurfies_tpu_torch.ops.downsample import voxel_downsample
    from spurfies_tpu_torch.ops.voxel_grid import (
        build_occupancy_bitmap,
        fine_occupancy,
    )

    sd = load_scene_data(cfg, SCAN)
    pts, _, _ = voxel_downsample(np.asarray(sd.points), cfg.model.vox_res)
    spec = grid_spec_from_config(cfg.model)
    occ_fine = build_occupancy_bitmap(
        torch.as_tensor(pts, dtype=torch.float32, device=device), spec,
        r=cfg.model.r)
    lo, hi = mesh_bounds(cfg, SCAN, sd.scale_mat)
    steps, axes = grid_axes(lo, hi, resolution)
    axes = [torch.as_tensor(a.astype(np.float32), device=device)
            for a in axes]
    n = int(np.prod(steps))
    occ = torch.stack([
        fine_occupancy(grid_points(axes, i, min(i + chunk, n)), occ_fine,
                       spec).sum() for i in range(0, n, chunk)]).cpu()
    sizes = torch.tensor([min(chunk, n - i) for i in range(0, n, chunk)])
    slots = torch.tensor([max(int(m * budget_frac) // 128 * 128, 128)
                          for m in sizes.tolist()])
    share = occ.double() / sizes
    top = int(share.argmax())
    return {"grid": steps.tolist(), "chunks": len(sizes),
            "busiest_chunk": top, "occupied": int(occ[top]),
            "points": int(sizes[top]), "share": float(share[top]),
            "budget_frac": budget_frac,
            "chunks_over_budget": int((occ > slots).sum()),
            "occupied_dropped": int((occ - slots).clamp(min=0).sum())}


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100_000)
    ap.add_argument("--img-res", type=int, nargs=2, default=(192, 256))
    ap.add_argument("--mesh-resolution", type=int, default=512)
    ap.add_argument("--max-views", type=int, default=4)
    ap.add_argument("--workdir",
                    default=str(REPO / "spurfies_tpu_torch" / "build"
                                / "acceptance_torch"))
    ap.add_argument("--out", default=str(REPO / "artifacts"
                                         / "acceptance_chain_torch.json"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("--stop-at", type=int, default=None,
                    help="train to this step of the --steps run, save "
                         "latest and stop before the evaluation")
    ap.add_argument("--resume", action="store_true",
                    help="reuse the workdir's fixture and continue its "
                         "experiment from latest")
    ap.add_argument("overrides", nargs="*",
                    help="key.path=value after the chain's own")
    args = ap.parse_args(argv)
    if args.stop_at is not None and not 0 < args.stop_at < args.steps:
        ap.error(f"--stop-at must lie in (0, {args.steps})")
    return args


def main(argv=None):
    """Run the chain (or the part of it ``--stop-at`` / ``--resume`` ask
    for); returns the record."""
    args = parse(argv)
    from spurfies_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    workdir, out = os.path.abspath(args.workdir), os.path.abspath(args.out)
    os.makedirs(workdir, exist_ok=True)
    with contextlib.chdir(workdir):
        return _chain(args, dev, out)


def _chain(args, dev, out):
    from spurfies_tpu_torch.cli import eval_dtu as cli_dtu
    from spurfies_tpu_torch.cli import evaluate as cli_eval
    from spurfies_tpu_torch.cli import train as cli_train
    from spurfies_tpu_torch.config import Config, apply_overrides
    from spurfies_tpu_torch.data.synthetic import export_synthetic_dtu
    from spurfies_tpu_torch.utils.experiment import ExperimentDir

    overrides = chain_overrides(args.steps, args.img_res) + args.overrides
    cfg = apply_overrides(Config(), overrides)
    name, smi = device_strings(dev)
    record = {"steps": args.steps, "img_res": list(args.img_res),
              "mesh_resolution": args.mesh_resolution,
              "overrides": overrides, "stages": {}, "device": name,
              "nvidia_smi": smi}
    if args.resume:
        if ExperimentDir.latest(cfg.exps_folder, cfg.expname, SCAN) is None:
            raise FileNotFoundError(
                f"--resume: no checkpoint under {os.getcwd()}/"
                f"{cfg.exps_folder}")
        if os.path.exists(PROGRESS):
            with open(PROGRESS) as f:
                record["stages"] = json.load(f)["stages"]
    elif os.path.isdir(cfg.exps_folder):
        raise FileExistsError(
            f"{os.getcwd()}/{cfg.exps_folder} exists: pass --resume or use "
            "a new --workdir")
    dev_args = ["--device", str(dev)]

    def stage(key, fn):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
        wall = time.perf_counter() - t0
        print(f"[acceptance] {key}: {wall:.1f}s", flush=True)
        return res, wall

    def save_progress():
        with open(PROGRESS, "w") as f:
            json.dump(record, f, indent=1)

    # ---- fixture (DTU layout and the GT cloud for Chamfer) ----
    if not args.resume:
        _, wall = stage("fixture", lambda: export_synthetic_dtu(
            "data", scan_id=24, n_views=49, img_res=tuple(args.img_res),
            gt_root="data/dtu_eval"))
        record["stages"]["fixture"] = {"wall_s": wall}

    # ---- train (the production budget, or up to --stop-at) ----
    stop = args.stop_at or args.steps

    def train():
        argv = (["--scans", SCAN] + dev_args
                + (["--resume"] if args.resume else []) + overrides
                + [f"train.opt_steps={stop}"])
        with logged() as messages:
            [(trainer, exp)] = cli_train.main(argv)
        priors = [m for m in messages
                  if any(p in m for p in PRIOR_MESSAGES)]
        if priors != [REPO_PRIOR]:
            raise RuntimeError(f"cli.train loaded the prior {priors}, "
                               f"expected [{REPO_PRIOR!r}]")
        return int(trainer.state.step), trainer.cfg.train.num_pixels, exp
    first = ExperimentDir.latest(cfg.exps_folder, cfg.expname, SCAN)
    start = (int(torch.load(first.checkpoint_path("latest"),
                            map_location="cpu", weights_only=True)["step"])
             if args.resume else 0)
    (step, rays, exp), wall = stage("train", train)
    if step != stop or (first is not None and exp.dir != first.dir):
        raise RuntimeError(f"cli.train reached step {step} in {exp.dir}, "
                           f"expected {stop} in {first and first.dir}")
    calls = record["stages"].get("train", {}).get("calls", []) + [
        {"from": start, "to": step, "wall_s": wall,
         "rays_per_s": (step - start) * rays / wall,
         "ms_per_step": wall / max(step - start, 1) * 1e3}]
    done = sum(c["to"] - c["from"] for c in calls)
    train_wall = sum(c["wall_s"] for c in calls)
    record["stages"]["train"] = {"wall_s": train_wall, "calls": calls,
                                 "rays_per_s": done * rays / train_wall,
                                 "experiment": os.path.relpath(exp.dir)}
    save_progress()
    if step < args.steps:
        print(f"[acceptance] stopped at step {step} of {args.steps}; "
              f"continue with --resume --workdir {os.getcwd()}")
        return record

    # ---- evaluate: the mesh (protocol 512 grid) + NVS of the first views
    def evaluate():
        [summary] = cli_eval.main(
            ["--scans", SCAN, "--mesh", "--rendering", "--resolution",
             str(args.mesh_resolution), "--max-views", str(args.max_views)]
            + dev_args + overrides)
        return summary
    summary, wall = stage("evaluate", evaluate)
    record["stages"]["evaluate"] = {"wall_s": wall}
    record["nvs"] = summary["nvs"]
    record["mesh"] = {k: summary["mesh"][k] for k in ("n_verts", "n_faces")}
    record["probe_budget"] = probe_budget(cfg, args.mesh_resolution, dev)

    # ---- evaluate_near: the held-out views beside the train triplet ----
    def evaluate_near():
        [summary] = cli_eval.main(
            ["--scans", SCAN, "--rendering", "--eval-ids", NEAR_IDS,
             "--out", "results_near"] + dev_args + overrides)
        return summary
    summary, wall = stage("evaluate_near", evaluate_near)
    record["stages"]["evaluate_near"] = {"wall_s": wall}
    record["nvs_nearviews"] = dict(summary["nvs"],
                                   eval_ids=summary["eval_ids"])

    # ---- the DTU Chamfer protocol (clean + distance) ----
    def chamfer():
        cli_dtu.main(["--scans", "24", "--meshes", "results",
                      "--data-root", "data", "--gt-root", "data/dtu_eval",
                      "--out", "results/chamfer.json"] + dev_args)
        with open("results/chamfer.json") as f:
            return json.load(f)["per_scan"]["24"]
    record["chamfer"], wall = stage("chamfer", chamfer)
    record["stages"]["chamfer"] = {"wall_s": wall}

    record["total_wall_s"] = sum(s["wall_s"]
                                 for s in record["stages"].values())
    save_progress()
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"[acceptance] done -> {out}")
    print(json.dumps({k: record[k] for k in (
        "nvs", "nvs_nearviews", "chamfer", "mesh", "total_wall_s")},
        indent=1))
    return record


if __name__ == "__main__":
    main()
