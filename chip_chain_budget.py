#!/usr/bin/env python3
"""The acceptance chain's mesh with and without the probe budget, on a
machine with one CUDA card:

    python3 chip_chain_budget.py [--workdir DIR] [--record JSON] \\
        [--out JSON] [--device cuda|cpu]

It reads a finished run of ``spurfies_tpu_torch.scripts.acceptance_chain``
(its work directory and its record), loads the run's final checkpoint
through the port's ``Trainer`` as ``cli.evaluate`` does, and extracts the
mesh at the record's resolution twice: through ``cli.evaluate.make_sdf_fn``
(``field.sdf_probe`` at its default budget, 0.25 of a chunk's points), and
through ``field.sdf_probe(..., budget_frac=None)``, which runs every
occupied point.  Each mesh is cleaned and scored by ``cli.eval_dtu``'s
``eval_scan``.  It prints acc, comp, overall, the faces and the occupied
points the budget drops (``acceptance_chain.probe_budget``), each beside
``nvidia-smi``'s name and power limit, and writes them to ``--out``.

The budgeted mesh must reproduce the run's own record (faces and Chamfer
to 1e-6): the script exits non-zero otherwise.  It imports nothing of JAX.
"""

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SCAN = "scan24"
TOL = 1e-6


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=str(
        REPO / "spurfies_tpu_torch" / "build" / "acceptance_torch"))
    ap.add_argument("--record", default=str(
        REPO / "artifacts" / "acceptance_chain_torch.json"))
    ap.add_argument("--out", default=str(REPO / "chiprun_out"
                                         / "chain_budget.json"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_chain_budget: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from spurfies_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    with open(args.record) as f:
        record = json.load(f)
    out = os.path.abspath(args.out)
    with contextlib.chdir(args.workdir):
        result = measure(record, dev)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    want, got = record["chamfer"], result["budget_0.25"]["chamfer"]
    bad = [k for k in ("acc", "comp", "overall")
           if abs(got[k] - want[k]) > TOL]
    if bad or result["budget_0.25"]["n_faces"] != record["mesh"]["n_faces"]:
        print(f"chip_chain_budget: the budgeted mesh does not reproduce the "
              f"record: {got} and {result['budget_0.25']['n_faces']} faces "
              f"against {want} and {record['mesh']['n_faces']}",
              file=sys.stderr)
        return 1
    print("chip_chain_budget: ok")
    return 0


def measure(record, dev):
    """Both meshes of the work directory's run, scored; run from inside
    the work directory."""
    import torch

    from spurfies_tpu_torch.cli import eval_dtu as cli_dtu
    from spurfies_tpu_torch.cli.evaluate import make_sdf_fn, mesh_bounds
    from spurfies_tpu_torch.cli.train import (
        apply_scene_overrides,
        load_scene_data,
    )
    from spurfies_tpu_torch.config import Config, apply_overrides
    from spurfies_tpu_torch.eval import mesh_extract
    from spurfies_tpu_torch.model import field
    from spurfies_tpu_torch.scripts.acceptance_chain import (
        device_strings,
        probe_budget,
    )
    from spurfies_tpu_torch.train.trainer import Trainer
    from spurfies_tpu_torch.utils.experiment import ExperimentDir

    cfg = apply_scene_overrides(
        apply_overrides(Config(), record["overrides"]), SCAN)
    resolution = record["mesh_resolution"]
    name, smi = device_strings(dev)
    sd = load_scene_data(cfg, SCAN)
    compute_dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    trainer = Trainer(cfg, sd.points, sd.colors, sd.train_views(),
                      device=dev, compute_dtype=compute_dtype)
    exp = ExperimentDir.latest(cfg.exps_folder, cfg.expname, SCAN)
    trainer.restore_checkpoint(exp.checkpoint_path("latest"))
    m = cfg.model

    def unbudgeted(x):
        with torch.no_grad():
            return field.sdf_probe(
                trainer.prior, trainer.state.params["feats_geometry"],
                trainer.scene, x, m.k, m.r, m.rbf, budget_frac=None,
                need_grad=False)

    lo, hi = mesh_bounds(cfg, SCAN, sd.scale_mat)
    # cli.evaluate's level: 0, or the calibrated one under eval.auto_iso
    level = (mesh_extract.calibrate_iso_level(trainer.scene.points,
                                              make_sdf_fn(trainer))
             if cfg.eval.auto_iso else 0.0)
    result = {"step": int(trainer.state.step), "resolution": resolution,
              "experiment": os.path.relpath(exp.dir), "device": name,
              "nvidia_smi": smi}
    for key, sdf_fn, frac in (("budget_0.25", make_sdf_fn(trainer), 0.25),
                              ("budget_None", unbudgeted, None)):
        t0 = time.perf_counter()
        verts, faces = mesh_extract.extract_mesh(
            sdf_fn, lo, hi, resolution=resolution, scale_mat=sd.scale_mat,
            level=level, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        extract_s = time.perf_counter() - t0
        path = os.path.join("results_budget", key, f"mesh_{SCAN}.ply")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        mesh_extract.save_mesh_ply(path, verts, faces)
        t0 = time.perf_counter()
        score = cli_dtu.eval_scan(24, path, "data", "data/dtu_eval",
                                  device=dev)
        dropped = (probe_budget(cfg, resolution, dev)["occupied_dropped"]
                   if frac is not None else 0)
        result[key] = {"budget_frac": frac, "n_verts": int(len(verts)),
                       "n_faces": int(len(faces)), "chamfer": score,
                       "occupied_dropped": dropped,
                       "extract_s": extract_s,
                       "score_s": time.perf_counter() - t0}
        print(f"[chain_budget] budget_frac={frac}: acc {score['acc']:.6f} "
              f"comp {score['comp']:.6f} overall {score['overall']:.6f}, "
              f"{len(faces):,} faces, {dropped:,} occupied points dropped, "
              f"extract {extract_s:.1f} s [{smi}]", flush=True)
        del verts, faces
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return result


if __name__ == "__main__":
    sys.exit(main())
