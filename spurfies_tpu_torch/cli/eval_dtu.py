"""DTU geometry benchmark CLI -- mesh cleaning + Chamfer protocol (port of
``spurfies_tpu/cli/eval_dtu.py``).

Reference surface: ``evals/clean_mesh.py`` main + ``python evals/eval_dtu.py
--datadir dtu``.

    python -m spurfies_tpu_torch.cli.eval_dtu --meshes results --scans 24 \
        --data-root data [--gt-root data/dtu_eval] [--device cuda|cpu]

Expects per-scan GT point clouds ``<gt-root>/Points/stl/stl{scan:03d}_total.ply``
and optional ``ObsMask/ObsMask{scan}_10.mat`` + ``Plane{scan}.mat`` (the
official DTU evaluation data layout used by eval_dtu.py:144-205).  The
cleaning's visibility pass runs on the card unless ``--device cpu``; the
rest is host numpy/scipy.  A scan that fails is logged and skipped, as the
reference does.
"""

import argparse
import json
import os

import numpy as np

from spurfies_tpu_torch.device import resolve_device
from spurfies_tpu_torch.utils.experiment import get_logger

log = get_logger()


def eval_scan(scan: int, mesh_path: str, data_root: str, gt_root: str,
              do_clean: bool = True, device="cuda"):
    """Clean one scan's mesh (its visibility pass on ``device``) and score
    it by the DTU protocol."""
    from spurfies_tpu_torch.data.dtu import load_dtu
    from spurfies_tpu_torch.data.ply import load_ply
    from spurfies_tpu_torch.eval.chamfer import chamfer_dtu
    from spurfies_tpu_torch.eval.mesh_extract import load_mesh_ply

    verts, faces = load_mesh_ply(mesh_path)
    log.info(f"scan{scan}: mesh {len(verts)} verts / {len(faces)} faces")

    if do_clean:
        from spurfies_tpu_torch.eval.clean_mesh import clean_mesh
        sd = load_dtu(data_root, scan)
        cams = np.load(os.path.join(data_root, "dtu", f"scan{scan}",
                                    "cameras.npz"))
        world_mats = [
            cams[f"world_mat_{i}"] for i in range(49)
            if f"world_mat_{i}" in cams
        ]
        h, w = sd.img_res
        # reconstruct per-view masks from the loaded viewsets
        mask_by_id = {}
        for vs in (sd.train, sd.eval):
            if vs is None:
                continue
            for j, vid in enumerate(vs.ids):
                mask_by_id[vid] = vs.mask[j].reshape(h, w, 3)[..., 0]
        # world_mats project at the ORIGINAL capture resolution; the loader
        # resizes masks to img_res — rescale the projection to match
        # (pixel scaling = diag(sx, sy, 1) @ P)
        from spurfies_tpu_torch.data.scene_data import glob_images, load_image
        img0 = load_image(glob_images(os.path.join(
            data_root, "dtu", f"scan{scan}", "image"))[0])
        sy, sx = h / img0.shape[0], w / img0.shape[1]
        pix_scale = np.diag([sx, sy, 1.0])
        used_mats = [
            np.concatenate(
                [pix_scale @ world_mats[i][:3], world_mats[i][3:]], axis=0
            )
            for i in sorted(mask_by_id)
        ]
        masks = [mask_by_id[i] for i in sorted(mask_by_id)]
        verts, faces = clean_mesh(verts, faces, used_mats, masks, (h, w),
                                  device=device)
        log.info(f"scan{scan}: cleaned -> {len(verts)} verts")

    alias = scan  # Plane/ObsMask aliases handled by the protocol (82->83)
    if scan == 82:
        alias = 83
    gt_path = os.path.join(gt_root, "Points", "stl",
                           f"stl{scan:03d}_total.ply")
    gt_pts, _ = load_ply(gt_path)

    obs = plane = None
    obs_path = os.path.join(gt_root, "ObsMask", f"ObsMask{alias}_10.mat")
    plane_path = os.path.join(gt_root, "ObsMask", f"Plane{alias}.mat")
    if os.path.exists(obs_path):
        from scipy.io import loadmat
        obs = loadmat(obs_path)
    if os.path.exists(plane_path):
        from scipy.io import loadmat
        plane = loadmat(plane_path)

    res = chamfer_dtu(verts, faces, gt_pts, obs_mask_file=obs,
                      ground_plane_file=plane)
    log.info(f"scan{scan}: acc {res['acc']:.3f} comp {res['comp']:.3f} "
             f"overall {res['overall']:.3f}")
    return res


def main(argv=None):
    """Parse ``argv`` and score each scan's mesh; returns ``{scan: result}``
    (what ``chamfer.json`` holds)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--meshes", default="results",
                    help="dir containing mesh_scan{id}.ply files")
    ap.add_argument("--scans", default="21,24,34,37,38,40,82,106,110,114,118")
    ap.add_argument("--data-root", default="data")
    ap.add_argument("--gt-root", default="data/dtu_eval")
    ap.add_argument("--no-clean", action="store_true")
    ap.add_argument("--out", default="results/chamfer.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    results = {}
    for s in args.scans.split(","):
        scan = int(s)
        mesh = None
        for cand in (
            os.path.join(args.meshes, f"mesh_scan{scan}.ply"),
            os.path.join(args.meshes, f"dtu_pn_scan{scan}",
                         f"mesh_scan{scan}.ply"),
            os.path.join(args.meshes, f"{scan:03d}.ply"),
        ):
            if os.path.exists(cand):
                mesh = cand
                break
        if mesh is None:
            log.warning(f"scan{scan}: no mesh found, skipping")
            continue
        try:
            results[scan] = eval_scan(scan, mesh, args.data_root,
                                      args.gt_root,
                                      do_clean=not args.no_clean,
                                      device=args.device)
        except Exception as e:  # per-scan continue like the reference
            log.warning(f"scan{scan}: failed ({e})")

    if results:
        mean = float(np.mean([r["overall"] for r in results.values()]))
        log.info(f"mean chamfer over {len(results)} scans: {mean:.3f}")
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"per_scan": {str(k): v for k, v in results.items()},
                       "mean_overall": mean}, f, indent=2)
    return results


if __name__ == "__main__":
    main()
