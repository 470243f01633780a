"""Point-cloud preparation: the post-DUSt3R processing pipeline (port of
``spurfies_tpu/prep/pointcloud.py``).

Behavioral spec from reference ``dust3r_inference.py`` /
``dust3r_inference_own.py``:
  * confidence-threshold filtering (conf >= 10) of per-view pointmaps
    (:107-140, :334),
  * greedy subsample to ``spacing`` (0.025) minimum point distance
    (:69-105),
  * own-data: normalize cloud + cameras into the unit cube with scale
    ``2 / max_extent`` (dust3r_inference_own.py:183-202),
  * export ``<scan>.ply`` (+ NGP-style ``<scan>.json`` for own data,
    :161-181, :262-267).

The subsample of :func:`prepare_scene` is the port's C++ routine
(``eval.chamfer.radius_dedup``, ``csrc/host_dedup.cpp``: the JAX package's
native ``greedy_radius``, f32 squared distances ``< spacing**2``), built at
first use; a failed build raises.
:func:`greedy_spacing_subsample` is its plain version (float64 distances,
the JAX package's Python fallback), which the synthetic scenes and the
prior's corpus call.
"""

import json
import os

import numpy as np

from spurfies_tpu_torch.data.ply import save_ply
from spurfies_tpu_torch.eval.chamfer import radius_dedup


def filter_by_confidence(points, colors, conf, threshold: float = 10.0):
    """Keep points with conf >= threshold (reference conf thr 10)."""
    keep = np.asarray(conf) >= threshold
    return points[keep], (colors[keep] if colors is not None else None)


def greedy_spacing_subsample(points, spacing: float = 0.025, seed: int = 0):
    """Greedy subsample: accept a point if no already-accepted point lies
    within ``spacing``, visiting points in order.  Grid-hash accelerated
    with a cell size of ``spacing``.

    The same decisions as the JAX package's Python fallback (and its
    native kernel): distances in float64, compared with ``spacing**2``;
    the accepted points are kept as Python floats instead of numpy rows,
    which is the same float64 arithmetic without a numpy call per test.
    """
    pts = np.asarray(points)
    n = len(pts)
    cell = spacing
    lo = pts.min(0) - cell
    ijk = np.floor((pts - lo) / cell).astype(np.int64)
    dims = ijk.max(0) + 2
    lin = ((ijk[:, 0] * dims[1] + ijk[:, 1]) * dims[2] + ijk[:, 2]).tolist()
    offsets = [(dx * dims[1] + dy) * dims[2] + dz
               for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
    offsets = [int(o) for o in offsets]
    coords = pts.astype(np.float64).tolist()
    occupied: dict = {}
    keep = np.zeros(n, dtype=bool)
    sp2 = spacing * spacing
    for i in range(n):
        c = lin[i]
        x, y, z = coords[i]
        ok = True
        for off in offsets:
            lst = occupied.get(c + off)
            if lst:
                for (px, py, pz) in lst:
                    dx, dy, dz = px - x, py - y, pz - z
                    if (dx * dx + dy * dy) + dz * dz < sp2:
                        ok = False
                        break
                if not ok:
                    break
        if ok:
            keep[i] = True
            occupied.setdefault(c, []).append((x, y, z))
    return np.nonzero(keep)[0]


def normalize_unit_cube(points, poses):
    """Scale scene so the cloud spans the [-1, 1] cube
    (reference dust3r_inference_own.py:183-202).

    Returns (points', poses', scale, center).
    """
    pts = np.asarray(points)
    lo, hi = pts.min(0), pts.max(0)
    center = (lo + hi) / 2.0
    extent = (hi - lo).max()
    scale = 2.0 / extent
    out_pts = (pts - center) * scale
    out_poses = []
    for p in np.asarray(poses):
        q = p.copy()
        q[:3, 3] = (p[:3, 3] - center) * scale
        out_poses.append(q)
    return out_pts, np.stack(out_poses), scale, center


def export_scene(out_dir: str, scan: str, points, colors, poses=None,
                 intrinsics=None, img_wh=None, frame_names=None):
    """Write ``<scan>.ply`` (+ ``<scan>.json`` when cameras given)."""
    os.makedirs(out_dir, exist_ok=True)
    save_ply(os.path.join(out_dir, f"{scan}.ply"), points, colors)

    if poses is not None:
        K = np.asarray(intrinsics)
        w, h = img_wh
        meta = {
            "fl_x": float(K[0, 0]), "fl_y": float(K[1, 1]),
            "cx": float(K[0, 2]), "cy": float(K[1, 2]),
            "w": int(w), "h": int(h),
            "frames": [
                {
                    "file_path": (
                        frame_names[i] if frame_names
                        else f"image/{i:03d}.png"
                    ),
                    "transform_matrix": np.asarray(p).tolist(),
                }
                for i, p in enumerate(poses)
            ],
        }
        with open(os.path.join(out_dir, f"{scan}.json"), "w") as f:
            json.dump(meta, f, indent=2)


def prepare_scene(points, colors, conf=None, conf_threshold: float = 10.0,
                  spacing: float = 0.025, normalize: bool = False,
                  poses=None):
    """Full prep: confidence filter -> spacing subsample -> (normalize)."""
    if conf is not None:
        points, colors = filter_by_confidence(points, colors, conf,
                                              conf_threshold)
    # the C++ routine: O(N) on the ~590k points of three 384x512 pointmaps
    keep = radius_dedup(points, spacing)
    points = points[keep]
    colors = colors[keep] if colors is not None else None
    scale, center = 1.0, np.zeros(3)
    if normalize:
        points, poses, scale, center = normalize_unit_cube(points, poses)
    return points, colors, poses, scale, center
