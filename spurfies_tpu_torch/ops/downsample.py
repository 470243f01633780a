"""Voxel downsampling of point clouds (host-side, runs once at scene load).

Behavioral spec from reference ``spurfies/model/utils.py:6-57``
(construct_vox_points_closest / voxelize, built on torch_scatter
scatter_mean/scatter_min): bucket points into a ``vox_res``-cubed grid over a
1.05x-padded cube around the cloud, and keep, per occupied voxel, the single
point nearest the voxel's centroid.

This runs once per scene on the host, so it is plain numpy (the reference
needed CUDA torch_scatter only because its tensors already lived on GPU).
"""

import numpy as np


def voxel_downsample(points: np.ndarray, vox_res: int,
                     colors: np.ndarray | None = None):
    """Keep one point (closest-to-centroid) per occupied voxel.

    Args:
      points: ``[N, 3]``.
      vox_res: grid resolution (reference config: 300).
      colors: optional ``[N, C]`` carried along.

    Returns:
      (points ``[M, 3]``, colors ``[M, C]`` or None, keep_idx ``[M]``).
    """
    points = np.asarray(points)
    mn = points.min(axis=0)
    mx = points.max(axis=0)
    edge = float((mx - mn).max()) * 1.05
    mid = (mx + mn) / 2.0
    lo = mid - edge / 2.0
    vox = edge / vox_res

    ijk = np.floor((points - lo) / vox).astype(np.int64)
    lin = (ijk[:, 0] * (vox_res + 2) + ijk[:, 1]) * (vox_res + 2) + ijk[:, 2]

    uniq, inv = np.unique(lin, return_inverse=True)
    counts = np.bincount(inv)
    centroid = np.zeros((len(uniq), 3), dtype=np.float64)
    np.add.at(centroid, inv, points)
    centroid /= counts[:, None]

    resid = np.linalg.norm(points - centroid[inv], axis=-1)
    # per-voxel argmin of resid
    order = np.lexsort((resid, inv))
    first = np.searchsorted(inv[order], np.arange(len(uniq)), side="left")
    keep = order[first]

    out_pts = points[keep].astype(np.float32)
    out_cols = colors[keep] if colors is not None else None
    return out_pts, out_cols, keep
