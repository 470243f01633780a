"""Isosurface extraction: marching tetrahedra on the grid's device (port of
``spurfies_tpu/eval/marching.py``, which runs it in numpy on the host).

Replaces the reference's skimage.measure.marching_cubes call
(spurfies/utils/plots.py:188-287).  Every generated vertex lies on a
segment between two grid nodes, so vertices weld exactly by (node_a,
node_b) key -- no epsilon merging.

The grid is walked in slabs of x-planes so that a 512-resolution grid
(~59M cubes at DTU bounds) fits on the card.  The faces come out in the
numpy version's order: it loops tet -> case -> the cubes of that case in
grid order, so each (tet, case) list is gathered across slabs (which run
in grid order) and the lists are concatenated in (tet, case, slab) order;
the weld's sorted unique then numbers the vertices as numpy does.  The
vertex positions are float64 ops one at a time, as numpy computes them.
``largest_component`` stays on the host (scipy).
"""

import numpy as np
import torch

# 6-tetrahedra decomposition of the unit cube around the 0-6 diagonal,
# corners 0..7 in VTK order (000, 100, 110, 010, 001, 101, 111, 011).
_TETS = np.array([
    [0, 5, 1, 6],
    [0, 1, 2, 6],
    [0, 2, 3, 6],
    [0, 3, 7, 6],
    [0, 7, 4, 6],
    [0, 4, 5, 6],
], dtype=np.int64)
_VTK_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
], dtype=np.int64)
SLAB_CUBES = 1 << 22            # cubes a slab, about (whole x-planes)


def _tet_triangles(inside):
    """Triangle edge lists for one tet sign configuration: each triangle
    three edges, each edge a (va, vb) pair of local tet vertex ids with
    sdf(va) < level <= sdf(vb)."""
    ins = [i for i in range(4) if inside[i]]
    outs = [i for i in range(4) if not inside[i]]
    if len(ins) == 0 or len(ins) == 4:
        return []
    if len(ins) == 1:
        a = ins[0]
        e = [(a, o) for o in outs]
        return [[e[0], e[1], e[2]]]
    if len(ins) == 3:
        d = outs[0]
        e = [(i, d) for i in ins]
        return [[e[0], e[2], e[1]]]
    a, b = ins
    c, d = outs
    return [
        [(a, c), (a, d), (b, d)],
        [(a, c), (b, d), (b, c)],
    ]


# case table: for each 4-bit config, the edge pairs [T, 3, 2]
_CASES = [np.array(_tet_triangles(tuple(bool((cfg >> i) & 1)
                                        for i in range(4))),
                   dtype=np.int64).reshape(-1, 3, 2) for cfg in range(16)]


def _empty():
    return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)


def marching_tetrahedra(sdf, level: float = 0.0, spacing=(1.0, 1.0, 1.0),
                        origin=(0.0, 0.0, 0.0), slab_cubes=SLAB_CUBES):
    """Extract the ``sdf == level`` isosurface.

    Args:
      sdf: ``[X, Y, Z]`` scalar field, a tensor (worked on its device) or a
        numpy array (on the CPU).
      spacing/origin: world transform of the grid.
      slab_cubes: cubes a slab, about (the slab takes whole x-planes).

    Returns:
      (verts ``[V, 3]`` float64, faces ``[F, 3]`` int64), numpy, equal to
      ``spurfies_tpu.eval.marching.marching_tetrahedra``'s.
    """
    sdf = torch.as_tensor(sdf)
    dev = sdf.device
    nx, ny, nz = sdf.shape
    if min(nx, ny, nz) < 2:
        return _empty()
    flat = sdf.reshape(-1)
    nn = nx * ny * nz

    def on_dev(a):
        return torch.as_tensor(a, device=dev)

    # node id of each corner relative to the cube's corner 0
    corner_off = on_dev([(cx * ny + cy) * nz + cz
                         for cx, cy, cz in _VTK_CORNERS.tolist()])
    plane = (torch.arange(ny - 1, device=dev)[:, None] * nz
             + torch.arange(nz - 1, device=dev)[None, :]).reshape(-1)
    planes = max(1, slab_cubes // plane.numel())
    tets = on_dev(_TETS)
    bits = on_dev([1, 2, 4, 8])
    cases = [on_dev(c) for c in _CASES]
    pieces = {(t, c): [] for t in range(len(_TETS)) for c in range(1, 15)}

    for x0 in range(0, nx - 1, planes):
        xs = torch.arange(x0, min(x0 + planes, nx - 1), device=dev)
        base = (xs[:, None] * (ny * nz) + plane[None, :]).reshape(-1)
        nodes = base[:, None] + corner_off[None, :]            # [C, 8]
        corner_sdf = flat[nodes]                               # [C, 8]
        for t in range(len(_TETS)):
            t_nodes = nodes[:, tets[t]]                        # [C, 4]
            inside = corner_sdf[:, tets[t]] < level
            cfg = (inside.long() * bits).sum(1)
            # the cubes of each case in grid order: a stable sort by case
            active = torch.nonzero((cfg > 0) & (cfg < 15))[:, 0]
            case_of = cfg[active]
            order = torch.argsort(case_of, stable=True)
            sel = active[order]
            counts = torch.bincount(case_of, minlength=16).tolist()
            start = 0
            for c in range(1, 15):
                if not counts[c]:
                    continue
                tn = t_nodes[sel[start:start + counts[c]]]     # [S, 4]
                start += counts[c]
                pieces[(t, c)].append((tn[:, cases[c][..., 0]].reshape(-1, 3),
                                       tn[:, cases[c][..., 1]].reshape(-1, 3)))
        del nodes, corner_sdf

    parts = [p for key in sorted(pieces) for p in pieces[key]]
    if not parts:
        return _empty()
    ea = torch.cat([a for a, _ in parts])     # [F, 3] node id, inside end
    eb = torch.cat([b for _, b in parts])     # [F, 3] node id, outside end
    del parts, pieces

    # weld: unique undirected edges, numbered in sorted key order
    key = torch.minimum(ea, eb) * nn + torch.maximum(ea, eb)
    del ea, eb
    uniq, inv = torch.unique(key.reshape(-1), sorted=True,
                             return_inverse=True)
    faces = inv.reshape(-1, 3)
    u_lo = uniq // nn
    u_hi = uniq % nn

    def node_coord(n):
        iz = n % nz
        iy = (n // nz) % ny
        ix = n // (nz * ny)
        return torch.stack([ix, iy, iz], -1).to(torch.float64)

    s_lo = flat[u_lo].to(torch.float64)
    s_hi = flat[u_hi].to(torch.float64)
    denom = s_hi - s_lo
    t = torch.where(denom.abs() > 1e-12, (level - s_lo) / denom, 0.5)
    t = torch.clamp(t, 0.0, 1.0)
    c_lo = node_coord(u_lo)
    # base + t (hi - lo), each op alone (no fused multiply-add)
    verts = c_lo + t[:, None] * (node_coord(u_hi) - c_lo)
    verts = verts * on_dev(np.asarray(spacing, np.float64))[None] \
        + on_dev(np.asarray(origin, np.float64))[None]

    # drop degenerate faces (two welded verts equal)
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return verts.cpu().numpy(), faces[ok].cpu().numpy()


def largest_component(verts: np.ndarray, faces: np.ndarray):
    """Keep the largest connected component (reference uses
    trimesh split+argmax, eval_spurfies.py:184-190); host scipy."""
    if len(faces) == 0:
        return verts, faces
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n = len(verts)
    rows = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    cols = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    adj = coo_matrix(
        (np.ones(len(rows)), (rows, cols)), shape=(n, n)
    )
    n_comp, labels = connected_components(adj, directed=False)
    if n_comp <= 1:
        return verts, faces
    # component size by face count
    face_label = labels[faces[:, 0]]
    best = np.bincount(face_label, minlength=n_comp).argmax()
    keep_f = faces[face_label == best]
    keep_v = np.unique(keep_f)
    remap = -np.ones(n, dtype=np.int64)
    remap[keep_v] = np.arange(len(keep_v))
    return verts[keep_v], remap[keep_f]
