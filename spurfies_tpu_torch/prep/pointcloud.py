"""Greedy spacing subsample (copy of ``greedy_spacing_subsample`` of
``spurfies_tpu/prep/pointcloud.py``; reference
``dust3r_inference.py:69-105``)."""

import numpy as np


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
