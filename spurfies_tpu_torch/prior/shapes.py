"""Procedural shape corpus for local-geometry-prior pretraining (copy of
``spurfies_tpu/prior/shapes.py``; host numpy in both packages: the same
``np.random.default_rng`` gives the same arrays).

The reference ships ``ckpt/local_prior.pt`` pretrained on ShapeNet
(readme.md:49); the training code is NOT in the repo (SURVEY §7 step 10 —
recipe must be designed from the paper).  The prior is *local*: F_geometry
only ever sees (32-dim latent, 3-dim offset) pairs within a 0.05 radius, so
local surface patches are what matters — a corpus of procedural primitives
(spheres, boxes, ellipsoids, capsules, tori) with analytic SDFs provides
exactly the local patch statistics needed, with exact ground truth.

Each sample shape yields:
  * surface points at ~DUSt3R spacing (the neural-point positions),
  * query points near the surface with exact signed distances.
"""

import numpy as np

from spurfies_tpu_torch.prep.pointcloud import greedy_spacing_subsample


def _sd_sphere(p, r):
    return np.linalg.norm(p, axis=-1) - r


def _sd_box(p, b):
    q = np.abs(p) - b
    outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
    inside = np.minimum(np.max(q, axis=-1), 0.0)
    return outside + inside


def _sd_ellipsoid(p, r):
    # inexact but adequate normalized estimate
    k0 = np.linalg.norm(p / r, axis=-1)
    k1 = np.linalg.norm(p / (r * r), axis=-1)
    return k0 * (k0 - 1.0) / np.maximum(k1, 1e-9)


def _sd_torus(p, R, r):
    q = np.stack([np.linalg.norm(p[..., [0, 2]], axis=-1) - R, p[..., 1]],
                 -1)
    return np.linalg.norm(q, axis=-1) - r


def _sd_capsule(p, a, b, r):
    pa = p - a
    ba = b - a
    h = np.clip((pa @ ba) / (ba @ ba), 0.0, 1.0)
    return np.linalg.norm(pa - h[:, None] * ba, axis=-1) - r


def random_shape_sdf(rng):
    """Returns (sdf_fn: [N,3]->[N], rough bounding radius)."""
    kind = rng.integers(0, 5)
    rot = _random_rotation(rng)

    def xform(p):
        return p @ rot.T

    if kind == 0:
        r = rng.uniform(0.25, 0.55)
        return lambda p: _sd_sphere(xform(p), r), r
    if kind == 1:
        b = rng.uniform(0.15, 0.5, 3)
        return lambda p: _sd_box(xform(p), b), float(np.linalg.norm(b))
    if kind == 2:
        r = rng.uniform(0.15, 0.55, 3)
        return lambda p: _sd_ellipsoid(xform(p), r), float(r.max())
    if kind == 3:
        R = rng.uniform(0.25, 0.45)
        r = rng.uniform(0.08, 0.2)
        return lambda p: _sd_torus(xform(p), R, r), R + r
    a = rng.uniform(-0.3, 0.3, 3)
    b = rng.uniform(-0.3, 0.3, 3)
    r = rng.uniform(0.1, 0.25)
    return (
        lambda p: _sd_capsule(xform(p), a, b, r),
        float(max(np.linalg.norm(a), np.linalg.norm(b)) + r),
    )


def _random_rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _project_to_surface(sdf_fn, pts, iters=10, eps=1e-4):
    """Sphere-trace-style projection via finite-difference normals."""
    p = pts.copy()
    for _ in range(iters):
        d = sdf_fn(p)
        e = np.eye(3) * eps
        g = np.stack([sdf_fn(p + e[i]) - sdf_fn(p - e[i]) for i in range(3)],
                     -1) / (2 * eps)
        g /= np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-9)
        p = p - d[:, None] * g
    return p


def sample_shape(rng, n_surface=4000, n_query=8000, spacing=0.02,
                 query_sigma=0.03):
    """Generate one pretraining shape.

    Returns dict with:
      surface [Ns, 3] (subsampled to ~spacing — the neural points),
      query [Nq, 3], query_sdf [Nq].
    """
    sdf_fn, rad = random_shape_sdf(rng)

    # surface points: project random sphere samples
    raw = rng.normal(size=(n_surface * 2, 3))
    raw = raw / np.linalg.norm(raw, axis=-1, keepdims=True) * rad
    surf = _project_to_surface(sdf_fn, raw)
    good = np.abs(sdf_fn(surf)) < 1e-3
    surf = surf[good]
    keep = greedy_spacing_subsample(surf, spacing)
    surf = surf[keep]

    # queries: gaussian offsets from random surface points
    base = surf[rng.integers(0, len(surf), n_query)]
    query = base + rng.normal(0, query_sigma, size=(n_query, 3))
    query_sdf = sdf_fn(query)

    return {
        "surface": surf.astype(np.float32),
        "query": query.astype(np.float32),
        "query_sdf": query_sdf.astype(np.float32),
    }
