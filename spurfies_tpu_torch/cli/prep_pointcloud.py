"""Point-cloud preparation CLI (port of
``spurfies_tpu/cli/prep_pointcloud.py``) -- the reference
``dust3r_inference.py`` / ``dust3r_inference_own.py`` surface (SURVEY §3.5).

    python -m spurfies_tpu_torch.cli.prep_pointcloud --dataset own_data \\
        --scan duck --images data/raw/duck --ckpt ckpt/dust3r.pth \\
        [--subsample 0.025] [--conf 10] [--device cuda|cpu]

Pipeline: two-view inference on all pairs of the first three images
(complete graph) -> global alignment (300 Adam iterations on the device;
free poses for every dataset, as the JAX package does) -> per-view
confidence fusion -> confidence filter -> greedy spacing subsample ->
unit-cube normalize (own data) -> <scan>.ply + <scan>.json export.
Everything runs on the card unless ``--device cpu`` asks for the CPU.

The DUSt3R checkpoint is required for inference (gated; zero-egress
environments use the shipped point clouds instead -- readme.md:51,70).
"""

import argparse
import itertools
import os

import numpy as np
import torch

from spurfies_tpu_torch.data.scene_data import glob_images, load_image
from spurfies_tpu_torch.device import resolve_device
from spurfies_tpu_torch.prep.alignment import AlignConfig, align_pointmaps
from spurfies_tpu_torch.prep.dust3r_net import Dust3rConfig, convert_dust3r
from spurfies_tpu_torch.prep.pointcloud import export_scene, prepare_scene
from spurfies_tpu_torch.utils.experiment import get_logger

log = get_logger()


def run_inference(ckpt: str, image_paths: list, img_size=(384, 512),
                  device="cuda"):
    """DUSt3R on every pair of ``image_paths`` (one encode per image per
    pair, as the JAX package does); returns (edges, per-pair outputs on
    ``device``)."""
    dev = resolve_device(device)
    cfg = Dust3rConfig(img_size=img_size)
    net = convert_dust3r(ckpt, cfg).to(dev)
    imgs = [torch.from_numpy(load_image(p, img_size) * 2.0 - 1.0).to(dev)
            for p in image_paths]
    edges = list(itertools.combinations(range(len(imgs)), 2))
    obs = []
    for i, j in edges:
        out = net(imgs[i], imgs[j])
        obs.append(out)
        log.info(f"pair ({i},{j}): mean conf "
                 f"{float(out['conf1'].mean()):.2f}")
    return edges, obs


def fuse_view_confidence(edges, conf_i, conf_j, n_views: int) -> np.ndarray:
    """Per-view pixel confidence ``[V, P]`` from per-edge confidences.

    Edge e = (i, j) predicts view i's map with ``conf_i[e]`` and view j's
    with ``conf_j[e]``; view v's confidence is the elementwise max over
    every edge slot where v appears (matching DUSt3R's im_conf fusion,
    reference dust3r_inference.py:107-140).
    """
    conf_i = np.asarray(conf_i)
    conf_j = np.asarray(conf_j)
    out = np.zeros((n_views, conf_i.shape[1]), conf_i.dtype)
    for e, (i, j) in enumerate(edges):
        out[i] = np.maximum(out[i], conf_i[e])
        out[j] = np.maximum(out[j], conf_j[e])
    return out


def main(argv=None):
    """Parse ``argv`` and prepare one scan; returns a dict with the output
    directory, the exported ``points`` and ``poses`` and the alignment's
    ``loss``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="own_data",
                    choices=["own_data", "dtu", "mipnerf"])
    ap.add_argument("--scan", required=True)
    ap.add_argument("--images", required=True, help="input image dir")
    ap.add_argument("--ckpt", default="ckpt/dust3r.pth")
    ap.add_argument("--out-root", default="data")
    ap.add_argument("--subsample", type=float, default=0.025)
    ap.add_argument("--conf", type=float, default=10.0)
    ap.add_argument("--align-iters", type=int, default=300)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    if not os.path.exists(args.ckpt):
        raise FileNotFoundError(
            f"{args.ckpt} not found — DUSt3R inference needs its released "
            "checkpoint; benchmark scenes ship with prepared point clouds."
        )

    image_paths = glob_images(args.images)[:3]
    edges, obs = run_inference(args.ckpt, image_paths, device=args.device)

    pts_i = torch.stack([o["pts1"].reshape(-1, 3) for o in obs])
    pts_j = torch.stack([o["pts2"].reshape(-1, 3) for o in obs])
    conf_i = torch.stack([o["conf1"].reshape(-1) for o in obs])
    conf_j = torch.stack([o["conf2"].reshape(-1) for o in obs])

    res = align_pointmaps(
        np.asarray(edges), pts_i, pts_j, conf_i, conf_j,
        n_views=len(image_paths),
        cfg=AlignConfig(iters=args.align_iters),
    )
    log.info(f"alignment loss {res['loss']:.4f}")

    # fused cloud [V*P, 3] + per-point confidence: view v's points carry
    # the max confidence over the edge slots where view v appears (DUSt3R's
    # per-image conf is the max over that image's edge predictions,
    # dust3r_inference.py:107-140)
    cloud = res["points"].reshape(-1, 3)
    conf = fuse_view_confidence(edges, conf_i.cpu().numpy(),
                                conf_j.cpu().numpy(), len(image_paths))
    conf = conf.reshape(-1)

    pts, cols, poses, scale, center = prepare_scene(
        cloud, None, conf=conf, conf_threshold=args.conf,
        spacing=args.subsample,
        normalize=(args.dataset == "own_data"),
        poses=res["poses"],
    )
    out_dir = os.path.join(args.out_root, args.dataset, args.scan)
    export_scene(out_dir, args.scan, pts, cols,
                 poses if args.dataset == "own_data" else None,
                 intrinsics=np.eye(3), img_wh=(512, 384))
    log.info(f"exported {len(pts)} points -> {out_dir}")
    return {"out_dir": out_dir, "points": pts, "poses": poses,
            "loss": res["loss"]}


if __name__ == "__main__":
    main()
