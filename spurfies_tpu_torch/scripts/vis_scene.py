"""Pose and point-cloud visualizer (counterpart of ``scripts/vis_scene.py``).

It writes one PLY -- the scene's cloud and each train camera's frustum
drawn as coloured strips of points -- that any viewer (MeshLab, Blender,
three.js) opens.  The scene is loaded by ``cli.train.load_scene_data``;
nothing runs on the card.

    python -m spurfies_tpu_torch.scripts.vis_scene --dataset own_data \\
        --scan duck [--data-root data] [--out vis_duck.ply] \\
        [--frustum-depth 0.3]
"""

import argparse

import numpy as np

from spurfies_tpu_torch.cli.train import load_scene_data
from spurfies_tpu_torch.config import Config, DataConfig
from spurfies_tpu_torch.data.ply import save_ply

PALETTE = np.array([[255, 64, 64], [64, 255, 64], [64, 64, 255],
                    [255, 255, 64]], np.float32)


def frustum_points(pose, K, img_wh, depth=0.3, n=24):
    """A camera's frustum as ``n`` samples along each of its 4 rays and 4
    far edges, in world space (``[8 * n, 3]``)."""
    w, h = img_wh
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    corners = np.array([
        [(0 - cx) / fx, (0 - cy) / fy, 1.0],
        [(w - cx) / fx, (0 - cy) / fy, 1.0],
        [(w - cx) / fx, (h - cy) / fy, 1.0],
        [(0 - cx) / fx, (h - cy) / fy, 1.0],
    ]) * depth
    eye = np.zeros(3)
    segs = []
    for i in range(4):
        segs.append((eye, corners[i]))                    # rays
        segs.append((corners[i], corners[(i + 1) % 4]))   # far rectangle
    t = np.linspace(0.0, 1.0, n)[:, None]
    local = np.concatenate([a[None] * (1 - t) + b[None] * t
                            for a, b in segs])
    return local @ pose[:3, :3].T + pose[:3, 3]


def main(argv=None):
    """Parse ``argv`` and write the PLY; returns its path."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="own_data",
                    choices=["own_data", "dtu", "mipnerf"])
    ap.add_argument("--scan", required=True)
    ap.add_argument("--data-root", default="data")
    ap.add_argument("--out", default=None)
    ap.add_argument("--frustum-depth", type=float, default=0.3)
    args = ap.parse_args(argv)

    cfg = Config(dataset=DataConfig(data_dir=args.dataset,
                                    data_dir_root=args.data_root,
                                    scan_id=args.scan))
    sd = load_scene_data(cfg, args.scan)

    pts = [np.asarray(sd.points, dtype=np.float32)]
    if sd.colors is not None and len(sd.colors):
        cols = [np.asarray(sd.colors, dtype=np.float32)]
    else:
        cols = [np.full((len(sd.points), 3), 180.0, np.float32)]
    h, w = sd.img_res
    for i in range(len(sd.train.ids)):
        f = frustum_points(sd.train.pose[i], sd.train.intrinsics[i],
                           (w, h), depth=args.frustum_depth)
        pts.append(f.astype(np.float32))
        cols.append(np.tile(PALETTE[i % len(PALETTE)], (len(f), 1)))

    all_pts = np.concatenate(pts)
    out = args.out or f"vis_{args.scan}.ply"
    save_ply(out, all_pts, np.concatenate(cols).astype(np.uint8))
    print(f"wrote {out}: {len(all_pts)} points "
          f"({len(sd.points)} cloud + {len(sd.train.ids)} frusta)")
    return out


if __name__ == "__main__":
    main()
