"""DTU Chamfer-distance evaluation, the DTUeval protocol (port of
``spurfies_tpu/eval/chamfer.py``).

Behavioral spec from reference ``evals/eval_dtu.py:36-265``:
  * mesh vertices + surface samples, 0.2 mm radius dedup,
  * ObsMask visibility filter + BB bounds + Res patch for accuracy points,
  * accuracy = mean dist to GT cloud (capped 20), completeness = mean dist
    from GT to mesh samples below the ground plane filter,
  * overall = mean(acc, comp); scan 82 uses Plane 83.

Host-side, as in the JAX package: the nearest-neighbour queries are
scipy's ``cKDTree`` (the JAX package's sklearn ``KDTree``: both exact, the
same distances; the card's machine has no sklearn), and the dedup is the
port's own C++ routine (``csrc/host_dedup.cpp``, built at first use by
``ops/cuda_build.py``), with :func:`radius_dedup_ref` its plain version.
"""

import ctypes

import numpy as np
from scipy.spatial import cKDTree

from spurfies_tpu_torch.ops import cuda_build

_SIG = {"host_radius_dedup": [ctypes.c_void_p, ctypes.c_int64,
                              ctypes.c_float, ctypes.c_void_p]}


def sample_triangles(verts: np.ndarray, faces: np.ndarray,
                     density: float = 0.2, seed: int = 0):
    """Exact vectorized port of the reference per-face barycentric-grid
    sampler (eval_dtu.py:15-25 sample_single_tri + its :79-109 loop), a copy
    of the JAX package's.

    Per-face grid spacing ``thr = density*sqrt(l1*l2/area2)``; grid offsets
    ``(i+0.5)/n1, (j+0.5)/n2`` kept where their sum < 1.  Zero-area faces
    are dropped.  Processed in ~8M-raw-point face blocks to bound memory;
    ``seed`` is accepted for API compatibility (the scheme is
    deterministic).
    """
    verts = np.asarray(verts, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    if len(faces) == 0:
        return verts.copy()
    tri = verts[faces]
    v1 = tri[:, 1] - tri[:, 0]
    v2 = tri[:, 2] - tri[:, 0]
    l1 = np.linalg.norm(v1, axis=-1)
    l2 = np.linalg.norm(v2, axis=-1)
    area2 = np.linalg.norm(np.cross(v1, v2), axis=-1)
    nz = area2 > 0
    v1, v2, l1, l2, area2 = v1[nz], v2[nz], l1[nz], l2[nz], area2[nz]
    base = tri[nz][:, 0]
    thr = density * np.sqrt(l1 * l2 / area2)
    n1 = np.floor(l1 / thr)
    n2 = np.floor(l2 / thr)
    sizes = ((n1 + 1) * (n2 + 1)).astype(np.int64)
    csum = np.cumsum(sizes)

    out = [verts]
    block_budget = 8_000_000
    start = 0
    while start < len(sizes):
        before = int(csum[start - 1]) if start else 0
        end = int(np.searchsorted(csum, before + block_budget)) + 1
        end = max(start + 1, min(end, len(sizes)))
        sz = sizes[start:end]
        total = int(sz.sum())
        fid = np.repeat(np.arange(start, end), sz)
        local = np.arange(total, dtype=np.int64) - np.repeat(
            csum[start:end] - sz - before, sz
        )
        w2 = (n2[fid] + 1).astype(np.int64)
        i = local // w2
        j = local - i * w2
        c0 = (i + 0.5) / np.maximum(n1[fid], 1e-7)
        c1 = (j + 0.5) / np.maximum(n2[fid], 1e-7)
        keep = c0 + c1 < 1.0
        fid, c0, c1 = fid[keep], c0[keep], c1[keep]
        out.append(
            base[fid] + c0[:, None] * v1[fid] + c1[:, None] * v2[fid]
        )
        start = end
    return np.concatenate(out, axis=0)


def radius_dedup(pts: np.ndarray, radius: float) -> np.ndarray:
    """Keep indices of the greedy radius dedup in the given order: point i
    is kept when no kept point before it lies within ``radius`` (f32
    squared distance ``< radius**2``).  The C++ routine; a failed build
    raises."""
    lib = cuda_build.load("host_dedup", _SIG)
    p = np.ascontiguousarray(pts, dtype=np.float32)
    keep = np.zeros(len(p), dtype=np.uint8)
    lib.host_radius_dedup(p.ctypes.data, len(p), float(radius),
                          keep.ctypes.data)
    return np.nonzero(keep)[0]


def radius_dedup_ref(pts: np.ndarray, radius: float) -> np.ndarray:
    """Plain :func:`radius_dedup`: a KD-tree ball query per point (within
    ``radius``, float64), walked in order (the JAX package's sklearn
    fallback)."""
    nbrs = cKDTree(pts).query_ball_point(pts, radius)
    keep = np.ones(len(pts), dtype=bool)
    for i, nb in enumerate(nbrs):
        if keep[i]:
            nb = np.asarray(nb, dtype=np.int64)
            keep[nb[nb > i]] = False
    return np.nonzero(keep)[0]


def radius_downsample(pts: np.ndarray, radius: float = 0.2,
                      seed: int = 0):
    """Greedy radius dedup after a seeded shuffle (eval_dtu.py:119-140)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(pts))
    pts = pts[order]
    return pts[radius_dedup(pts, radius)]


def chamfer_dtu(mesh_verts, mesh_faces, gt_points,
                obs_mask_file=None, ground_plane_file=None,
                max_dist: float = 20.0, downsample_density: float = 0.2,
                patch_size: float = 60.0):
    """Full DTU protocol. Returns dict(acc, comp, overall).

    obs_mask_file: dict-like with ObsMask/BB/Res (scipy.io.loadmat result)
    ground_plane_file: dict-like with 'P' plane (4,) -- points below the
    plane are excluded from completeness (eval_dtu.py:203-205).
    """
    if len(mesh_faces) > 0:
        samples = sample_triangles(mesh_verts, mesh_faces,
                                   downsample_density)
    else:
        samples = mesh_verts
    data_down = radius_downsample(samples, downsample_density)

    # accuracy: mesh -> GT, with ObsMask visibility filter
    if obs_mask_file is not None:
        obs_mask = obs_mask_file["ObsMask"]
        bb = obs_mask_file["BB"].astype(np.float64)
        res = float(np.asarray(obs_mask_file["Res"]).squeeze())
        inbound = np.all(
            (data_down >= bb[:1] - patch_size)
            & (data_down < bb[1:] + patch_size), axis=-1
        )
        grid = ((data_down - bb[:1]) / res).astype(int)
        in_obs = np.zeros(len(data_down), dtype=bool)
        valid_idx = inbound & np.all(
            (grid >= 0) & (grid < np.asarray(obs_mask.shape)), axis=-1
        )
        g = grid[valid_idx]
        in_obs[valid_idx] = obs_mask[g[:, 0], g[:, 1], g[:, 2]].astype(bool)
        acc_pts = data_down[in_obs]
    else:
        acc_pts = data_down

    if len(acc_pts):
        d2s = cKDTree(gt_points).query(acc_pts)[0]
        acc = float(np.mean(np.minimum(d2s, max_dist)))
    else:
        acc = float("nan")

    # completeness: GT -> mesh, above ground plane
    if ground_plane_file is not None:
        P = np.asarray(ground_plane_file["P"]).reshape(4)
        above = (
            gt_points @ P[:3] + P[3] > 0
        )
        comp_gt = gt_points[above]
    else:
        comp_gt = gt_points
    s2d = cKDTree(data_down).query(comp_gt)[0]
    comp = float(np.mean(np.minimum(s2d, max_dist)))

    return {"acc": acc, "comp": comp, "overall": (acc + comp) / 2.0}
