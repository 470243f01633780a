"""Mesh-corpus ingestion for local-prior pretraining, ShapeNet-ready (copy
of ``spurfies_tpu/prior/mesh_corpus.py``; host numpy in both packages).

The reference ships ``ckpt/local_prior.pt`` pretrained on ShapeNet meshes
(readme.md:49); the training code is absent (SURVEY §7 step 10).
``prior/shapes.py`` provides procedural primitives as the test fixture;
this module provides the real-corpus path: point a directory of meshes
(.ply / .obj) at :func:`build_shapes_from_meshes` and each mesh yields the
same shape dict the procedural generator produces — surface points at
~DUSt3R spacing plus near-surface queries with ground-truth signed
distance — so ``prior.pretrain`` consumes either source unchanged.

Self-contained (no trimesh/open3d in this environment): minimal PLY/OBJ
readers, area-weighted surface sampling (shared with eval.chamfer), and
signed distance = vectorized point-triangle distance with a generalized
winding-number sign (robust to non-watertight ShapeNet meshes would need
care; winding handles open seams gracefully since |W| degrades toward 0.5
near holes — points there keep the unsigned distance's positive sign).
"""

import os
import struct

import numpy as np

from spurfies_tpu_torch.prep.pointcloud import greedy_spacing_subsample


# ---------------------------------------------------------------------------
# Minimal mesh readers
# ---------------------------------------------------------------------------

def load_obj(path):
    """Vertices + triangle faces from a Wavefront OBJ (fans triangulated)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(t) for t in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(t.split("/")[0]) - 1 for t in line.split()[1:]]
                for i in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
    return (np.asarray(verts, dtype=np.float32),
            np.asarray(faces, dtype=np.int64).reshape(-1, 3))


def load_ply_mesh(path):
    """Vertices + triangle faces from ascii or binary-LE PLY."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        counts = {}
        props = {"vertex": []}
        current = None
        while True:
            line = f.readline().strip()
            if line.startswith(b"format"):
                fmt = line.split()[1].decode()
            elif line.startswith(b"element"):
                _, name, cnt = line.split()
                current = name.decode()
                counts[current] = int(cnt)
                props.setdefault(current, [])
            elif line.startswith(b"property") and current:
                props[current].append(line.split()[-1].decode())
            elif line == b"end_header":
                break

        nv = counts.get("vertex", 0)
        nf = counts.get("face", 0)
        vprops = props["vertex"]
        xi = [vprops.index(a) for a in ("x", "y", "z")]

        if fmt == "ascii":
            verts = np.empty((nv, 3), dtype=np.float32)
            for i in range(nv):
                vals = f.readline().split()
                verts[i] = [float(vals[j]) for j in xi]
            faces = []
            for _ in range(nf):
                vals = f.readline().split()
                idx = [int(v) for v in vals[1:1 + int(vals[0])]]
                for i in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
            return verts, np.asarray(faces, dtype=np.int64).reshape(-1, 3)

        if fmt != "binary_little_endian":
            raise ValueError(f"{path}: unsupported PLY format {fmt}")
        # binary: assume float32 vertex properties (standard exports)
        stride = len(vprops)
        raw = np.frombuffer(f.read(4 * stride * nv), dtype="<f4")
        verts = raw.reshape(nv, stride)[:, xi].astype(np.float32)
        faces = []
        for _ in range(nf):
            (n,) = struct.unpack("<B", f.read(1))
            idx = struct.unpack(f"<{n}i", f.read(4 * n))
            for i in range(1, n - 1):
                faces.append([idx[0], idx[i], idx[i + 1]])
        return verts, np.asarray(faces, dtype=np.int64).reshape(-1, 3)


def save_obj(path, verts, faces):
    """Minimal OBJ writer (fixtures, debugging exports)."""
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for tri in faces:
            f.write(f"f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n")


def load_mesh(path):
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return load_obj(path)
    if ext == ".ply":
        return load_ply_mesh(path)
    raise ValueError(f"unsupported mesh format: {path}")


def normalize_mesh(verts, bounds: float = 0.6):
    """Center at the bbox midpoint and scale the max half-extent to
    ``bounds`` (prior shapes live well inside the ±0.8 grid)."""
    lo, hi = verts.min(0), verts.max(0)
    center = (lo + hi) / 2
    scale = bounds / max(float((hi - lo).max()) / 2, 1e-9)
    return (verts - center) * scale


# ---------------------------------------------------------------------------
# Geometry: area sampling, point-triangle distance, winding-number sign
# ---------------------------------------------------------------------------

def sample_surface(verts, faces, n, seed=0):
    """n area-weighted uniform surface samples."""
    rng = np.random.default_rng(seed)
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    p = area / max(area.sum(), 1e-12)
    fid = rng.choice(len(faces), n, p=p)
    u, w = rng.random(n), rng.random(n)
    flip = u + w > 1
    u = np.where(flip, 1 - u, u)
    w = np.where(flip, 1 - w, w)
    return (v0[fid] + u[:, None] * (v1 - v0)[fid]
            + w[:, None] * (v2 - v0)[fid]).astype(np.float32)


def _point_tri_dist_sq(q, v0, e1, e2):
    """Squared distance from each query to each triangle.

    q ``[Q, 3]``; v0/e1/e2 ``[F, 3]`` (v1-v0, v2-v0).  Returns ``[Q, F]``.
    Eberly's region decomposition, vectorized.
    """
    d = v0[None] - q[:, None]                      # [Q, F, 3]
    a = np.einsum("fi,fi->f", e1, e1)[None]
    b = np.einsum("fi,fi->f", e1, e2)[None]
    c = np.einsum("fi,fi->f", e2, e2)[None]
    dd = np.einsum("qfi,fi->qf", d, e1)
    e = np.einsum("qfi,fi->qf", d, e2)

    det = np.maximum(a * c - b * b, 1e-18)
    s = b * e - c * dd
    t = b * dd - a * e

    inside = (s + t <= det) & (s >= 0) & (t >= 0)
    s_in = s / det
    t_in = t / det

    # edge/vertex regions: clamp each of the three parameterizations and
    # pick the best (cheap and branch-free compared to the full case split)
    # edge e1 (t=0): s = clamp(-dd/a)
    s0 = np.clip(-dd / a, 0.0, 1.0)
    # edge e2 (s=0): t = clamp(-e/c)
    t0 = np.clip(-e / c, 0.0, 1.0)
    # edge v1->v2: param u along (e2-e1)
    d12 = e2 - e1                                   # [F, 3]
    a12 = np.einsum("fi,fi->f", d12, d12)[None]
    u12 = np.clip(
        -(np.einsum("qfi,fi->qf", d + e1[None], d12)) / np.maximum(a12, 1e-18),
        0.0, 1.0,
    )

    def dist_sq(ss, tt):
        # |d + ss*e1 + tt*e2|^2 expanded (no [Q, F, 3] temporaries)
        return (
            np.einsum("qfi,qfi->qf", d, d)
            + 2 * ss * dd + 2 * tt * e
            + ss * ss * a + 2 * ss * tt * b + tt * tt * c
        )

    cand = np.stack([
        dist_sq(s0, np.zeros_like(s0)),
        dist_sq(np.zeros_like(t0), t0),
        dist_sq(1.0 - u12, u12),
    ])
    best_edge = cand.min(0)
    d_in = dist_sq(s_in, t_in)
    return np.where(inside, d_in, best_edge)


def orient_faces(faces):
    """Make triangle winding consistent across each connected component
    (BFS over shared edges, flipping when a shared edge runs the same
    direction in both faces).  Generalized winding numbers need this —
    marching-tetrahedra output and many ShapeNet meshes are unoriented,
    and mixed winding makes signed solid angles cancel."""
    faces = np.asarray(faces).copy()
    edge_map = {}
    for fi, tri in enumerate(faces):
        for a, b in ((tri[0], tri[1]), (tri[1], tri[2]), (tri[2], tri[0])):
            edge_map.setdefault((min(a, b), max(a, b)), []).append(fi)

    n = len(faces)
    visited = np.zeros(n, dtype=bool)
    from collections import deque

    def directed_edges(tri):
        return ((tri[0], tri[1]), (tri[1], tri[2]), (tri[2], tri[0]))

    for seed in range(n):
        if visited[seed]:
            continue
        visited[seed] = True
        queue = deque([seed])
        while queue:
            fi = queue.popleft()
            own = set(directed_edges(faces[fi]))
            for a, b in own:
                for fj in edge_map[(min(a, b), max(a, b))]:
                    if visited[fj]:
                        continue
                    visited[fj] = True
                    # consistent orientation: the shared edge must run in
                    # OPPOSITE directions in the two faces
                    if any(e in own for e in directed_edges(faces[fj])):
                        faces[fj] = faces[fj][::-1]
                    queue.append(fj)
    return faces


def _winding_number(q, v0, v1, v2):
    """Generalized winding number per query (sum of signed solid angles /
    4π; ~1 inside, ~0 outside).  Van Oosterom–Strackee formula."""
    a = v0[None] - q[:, None]
    b = v1[None] - q[:, None]
    c = v2[None] - q[:, None]
    la = np.linalg.norm(a, axis=-1)
    lb = np.linalg.norm(b, axis=-1)
    lc = np.linalg.norm(c, axis=-1)
    num = np.einsum("qfi,qfi->qf", a, np.cross(b, c))
    den = (la * lb * lc + np.einsum("qfi,qfi->qf", a, b) * lc
           + np.einsum("qfi,qfi->qf", b, c) * la
           + np.einsum("qfi,qfi->qf", c, a) * lb)
    return np.sum(2.0 * np.arctan2(num, den), axis=-1) / (4.0 * np.pi)


def signed_distance(verts, faces, queries, chunk: int = 256):
    """Signed distance from queries to the mesh (negative inside).

    O(Q·F) vectorized numpy, chunked over queries to bound memory
    (~chunk·F temporaries).  Corpus prep is offline; a 50k-face mesh at
    8k queries runs in ~a minute.  Faces are orientation-normalized first
    (winding numbers cancel on mixed-wound meshes).
    """
    faces = orient_faces(faces)
    v0, v1, v2 = (verts[faces[:, i]].astype(np.float64) for i in range(3))
    e1, e2 = v1 - v0, v2 - v0
    q64 = queries.astype(np.float64)
    out = np.empty(len(queries), dtype=np.float32)
    for i in range(0, len(queries), chunk):
        q = q64[i:i + chunk]
        d2 = _point_tri_dist_sq(q, v0, e1, e2)
        dist = np.sqrt(np.maximum(d2.min(-1), 0.0))
        wind = _winding_number(q, v0, v1, v2)
        # |W| ~ 1 inside, ~ 0 outside, for EITHER consistent face
        # orientation (outward or inward winding flips W's sign globally)
        out[i:i + chunk] = np.where(np.abs(wind) > 0.5, -dist, dist)
    return out


# ---------------------------------------------------------------------------
# Corpus assembly (shape-dict protocol of prior.shapes.sample_shape)
# ---------------------------------------------------------------------------

def mesh_to_shape(path, n_query=8000, spacing=0.02, query_sigma=0.03,
                  bounds=0.6, seed=0):
    """One mesh -> pretraining shape dict (surface / query / query_sdf)."""
    verts, faces = load_mesh(path)
    if len(faces) == 0:
        raise ValueError(f"{path}: mesh has no faces")
    verts = normalize_mesh(verts, bounds)

    rng = np.random.default_rng(seed)
    dense = sample_surface(verts, faces, max(n_query * 2, 20000), seed=seed)
    keep = greedy_spacing_subsample(dense, spacing)
    surf = dense[keep]

    base = surf[rng.integers(0, len(surf), n_query)]
    query = (base + rng.normal(0, query_sigma, (n_query, 3))).astype(
        np.float32
    )
    return {
        "surface": surf.astype(np.float32),
        "query": query,
        "query_sdf": signed_distance(verts, faces, query),
    }


def list_meshes(mesh_dir):
    out = []
    for root, _, names in os.walk(mesh_dir):
        for n in sorted(names):
            if os.path.splitext(n)[1].lower() in (".ply", ".obj"):
                out.append(os.path.join(root, n))
    return sorted(out)


def build_shapes_from_meshes(mesh_dir, n_shapes=None, n_query=8000,
                             spacing=0.02, seed=0, log=None):
    """Directory of meshes -> list of shape dicts for prior.pretrain.

    Meshes cycle if the corpus is smaller than n_shapes.
    """
    paths = list_meshes(mesh_dir)
    if not paths:
        raise ValueError(f"no .ply/.obj meshes under {mesh_dir}")
    if n_shapes is None:
        n_shapes = len(paths)
    shapes = []
    for i in range(n_shapes):
        path = paths[i % len(paths)]
        if log:
            log(f"[{i + 1}/{n_shapes}] {os.path.basename(path)}")
        shapes.append(
            mesh_to_shape(path, n_query=n_query, spacing=spacing,
                          seed=seed + i)
        )
    return shapes
