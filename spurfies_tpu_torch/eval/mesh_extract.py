"""Mesh extraction: batched SDF probe grid -> marching tetrahedra -> PLY
(port of ``spurfies_tpu/eval/mesh_extract.py``).

Behavioral spec from reference ``spurfies/utils/plots.py:188-287``
(get_surface_by_grid) + ``eval_spurfies.py:140-194``: probe the SDF on a
bbox grid in chunks (empty space = 1000), run marching at level 0,
transform by scale_mat, keep the largest connected component.

DTU grid bounds come from ``bbs.npz`` with the reference's bbox aliases
(scan82 -> 83; scans 21/34/38 -> 24; eval_spurfies.py:140-157) and the x
1.5 scale (plots.py:189).

The probe grid and its SDF stay on the device: each chunk's points are
made there from the three axes (numpy ``linspace`` in float64, cast to
float32: the JAX package's grid points, bit for bit), and the chunk loop
reads nothing back; the ``min < level < max`` test is its one host sync.
"""

import numpy as np
import torch

from spurfies_tpu_torch.device import resolve_device
from spurfies_tpu_torch.eval.marching import (
    largest_component,
    marching_tetrahedra,
)

# eval_spurfies.py:140-176: mipnerf hardcoded bounds
MIPNERF_BOUNDS = {
    "garden": (np.array([-0.7, -0.75, -0.65]), np.array([0.7, 0.75, 0.65])),
    "stump": (np.array([-0.6, -0.6, -0.6]), np.array([0.6, 0.6, 0.6])),
}
DTU_BB_ALIAS = {82: 83, 21: 24, 34: 24, 38: 24}


def grid_bounds_dtu(bbs_npz_path: str, scan_id: int, scale_mat: np.ndarray):
    """Grid bounds for a DTU scan: bbs.npz box mapped into normalized space
    via inv(scale_mat), x-extent scaled 1.5 (plots.py:189)."""
    bbs = np.load(bbs_npz_path)
    sid = DTU_BB_ALIAS.get(int(scan_id), int(scan_id))
    bb = bbs[str(sid)].reshape(2, 3).astype(np.float64)
    inv = np.linalg.inv(scale_mat.astype(np.float64))
    corners = np.array([
        [bb[i, 0], bb[j, 1], bb[k, 2], 1.0]
        for i in (0, 1) for j in (0, 1) for k in (0, 1)
    ]).T
    local = (inv @ corners)[:3].T
    lo, hi = local.min(0), local.max(0)
    center = (lo + hi) / 2
    half = (hi - lo) / 2 * np.array([1.5, 1.0, 1.0])
    return center - half, center + half


def grid_axes(lo, hi, resolution: int):
    """The grid's steps ``[3]`` and its three axes (float64 ``linspace``,
    as the JAX package builds them)."""
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    extent = hi - lo
    steps = np.maximum(
        (extent / extent.max() * resolution).astype(int), 2
    )
    return steps, [np.linspace(lo[d], hi[d], steps[d]) for d in range(3)]


def grid_points(axes, start: int, stop: int):
    """Grid points ``start..stop`` (x-major, as ``np.meshgrid(indexing=
    "ij")`` flattens them), ``[stop - start, 3]`` float32 on the axes'
    device; ``axes``: three float32 tensors."""
    ny, nz = axes[1].shape[0], axes[2].shape[0]
    i = torch.arange(start, stop, device=axes[0].device)
    return torch.stack([axes[0][i // (ny * nz)], axes[1][(i // nz) % ny],
                        axes[2][i % nz]], -1)


def probe_grid(sdf_fn, axes, chunk: int = 262144):
    """``sdf_fn`` on every grid point in chunks of ``chunk``: ``[N]`` f32 on
    the axes' device.  ``sdf_fn`` takes ``[M, 3]`` f32 points there and
    returns ``[M]`` (a tensor, or anything ``torch.as_tensor`` takes)."""
    dev = axes[0].device
    n = axes[0].shape[0] * axes[1].shape[0] * axes[2].shape[0]
    vals = torch.empty(n, dtype=torch.float32, device=dev)
    for i in range(0, n, chunk):
        stop = min(i + chunk, n)
        vals[i:stop] = torch.as_tensor(sdf_fn(grid_points(axes, i, stop)),
                                       device=dev)
    return vals


def extract_mesh(sdf_fn, lo, hi, resolution: int = 512,
                 chunk: int = 262144, scale_mat: np.ndarray | None = None,
                 keep_largest: bool = True, level: float = 0.0,
                 device="cuda"):
    """Probe sdf_fn on a ``resolution^3``-ish grid and extract the surface.

    Args:
      sdf_fn: ``[M, 3] float32 -> [M]`` on ``device`` (e.g. a
        ``field.sdf_probe`` partial; must return 1000 in empty space like
        the reference probe).
      lo/hi: grid bounds in normalized model space.
      resolution: samples along the longest axis (reference default 512).
      scale_mat: optional 4x4 applied to vertices (normalized -> world).
      device: where the grid, the probe and the marching run.

    Returns:
      (verts [V, 3] float32 world coords, faces [F, 3] int64), numpy.
    """
    dev = resolve_device(device)
    steps, axes = grid_axes(lo, hi, resolution)
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    axes_t = [torch.as_tensor(a.astype(np.float32), device=dev)
              for a in axes]
    sdf_grid = probe_grid(sdf_fn, axes_t, chunk).reshape(*steps.tolist())

    if not bool((sdf_grid.min() < level) & (sdf_grid.max() > level)):
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    spacing = [
        (hi[d] - lo[d]) / (steps[d] - 1) for d in range(3)
    ]
    verts, faces = marching_tetrahedra(sdf_grid, level, spacing=spacing,
                                       origin=lo)
    del sdf_grid
    if keep_largest:
        verts, faces = largest_component(verts, faces)
    if scale_mat is not None:
        h = np.concatenate([verts, np.ones((len(verts), 1))], -1)
        verts = (scale_mat.astype(np.float64) @ h.T).T[:, :3]
    return verts.astype(np.float32), faces


def save_mesh_ply(path: str, verts: np.ndarray, faces: np.ndarray):
    """Binary PLY with faces."""
    verts = np.asarray(verts, dtype=np.float32)
    faces = np.asarray(faces, dtype=np.int32)
    header = [
        "ply", "format binary_little_endian 1.0",
        f"element vertex {len(verts)}",
        "property float x", "property float y", "property float z",
        f"element face {len(faces)}",
        "property list uchar int vertex_indices",
        "end_header",
    ]
    vrec = np.zeros(len(verts), dtype=[("x", "<f4"), ("y", "<f4"),
                                       ("z", "<f4")])
    vrec["x"], vrec["y"], vrec["z"] = verts[:, 0], verts[:, 1], verts[:, 2]
    frec = np.zeros(len(faces), dtype=[("n", "u1"), ("a", "<i4"),
                                       ("b", "<i4"), ("c", "<i4")])
    frec["n"] = 3
    frec["a"], frec["b"], frec["c"] = faces[:, 0], faces[:, 1], faces[:, 2]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(vrec.tobytes())
        f.write(frec.tobytes())


def load_mesh_ply(path: str):
    """Read verts+faces from a binary-little-endian or ascii PLY."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        counts = {}
        order = []
        props = {}
        cur = None
        for line in header:
            p = line.split()
            if not p:
                continue
            if p[0] == "element":
                cur = p[1]
                counts[cur] = int(p[2])
                order.append(cur)
                props[cur] = []
            elif p[0] == "property" and cur:
                props[cur].append(p[1:])

        from spurfies_tpu_torch.data.ply import _PLY_TO_NP
        verts = faces = None
        if fmt == "ascii":
            for el in order:
                rows = [f.readline().split() for _ in range(counts[el])]
                if el == "vertex":
                    arr = np.asarray(rows, dtype=np.float64)
                    names = [pp[-1] for pp in props[el]]
                    xi = [names.index(c) for c in ("x", "y", "z")]
                    verts = arr[:, xi].astype(np.float32)
                elif el == "face":
                    faces = np.asarray(
                        [r[1:4] for r in rows], dtype=np.int64
                    )
        else:
            endian = "<" if "little" in fmt else ">"
            for el in order:
                if el == "vertex":
                    dt = np.dtype([
                        (pp[-1], endian + _PLY_TO_NP[pp[0]])
                        for pp in props[el]
                    ])
                    raw = np.frombuffer(
                        f.read(counts[el] * dt.itemsize), dtype=dt
                    )
                    verts = np.stack(
                        [raw["x"], raw["y"], raw["z"]], -1
                    ).astype(np.float32)
                elif el == "face":
                    lst = props[el][0]
                    cnt_t = _PLY_TO_NP[lst[1]]
                    idx_t = _PLY_TO_NP[lst[2]]
                    faces = _read_triangles(f, counts[el], endian + cnt_t,
                                            endian + idx_t)
        return verts, faces


def _read_triangles(f, count, cnt_t, idx_t):
    """``count`` binary face records (a ``cnt_t`` length, then that many
    ``idx_t`` indices) -> the first three indices of each, ``[count, 3]``
    int64.  When every record holds 3 indices (as ``save_mesh_ply`` writes
    them) they are read in one block; the first record with another length
    would sit at its own offset there, so a block whose lengths are not all
    3 is read again record by record."""
    start = f.tell()
    rec = np.dtype([("n", cnt_t), ("i", idx_t, (3,))])
    raw = np.frombuffer(f.read(count * rec.itemsize), dtype=rec)
    if len(raw) == count and bool((raw["n"] == 3).all()):
        return raw["i"].astype(np.int64)
    f.seek(start)
    faces = np.empty((count, 3), dtype=np.int64)
    cnt_sz = np.dtype(cnt_t).itemsize
    idx_sz = np.dtype(idx_t).itemsize
    for i in range(count):
        n = int(np.frombuffer(f.read(cnt_sz), dtype=cnt_t)[0])
        faces[i] = np.frombuffer(f.read(n * idx_sz), dtype=idx_t)[:3]
    return faces


def calibrate_iso_level(points, sdf_fn, max_points: int = 16384,
                        seed: int = 0):
    """Self-calibrated extraction level: the median SDF at the input cloud
    (the neural points are surface samples, so the level set through them
    is the surface; see ``spurfies_tpu/eval/mesh_extract.py`` for the
    measurement behind it).

    points: ``[N, 3]`` (a tensor on the probe's device, or numpy);
    ``sdf_fn`` as :func:`extract_mesh` takes it, on ``points``' device.
    The subsample is drawn on the host with numpy, as the JAX package
    draws it.  Returns the level (median sdf where ``|sdf| < 1``; 0.0 when
    there is none).
    """
    dev = points.device if torch.is_tensor(points) else torch.device("cpu")
    pts = (points.detach().cpu().numpy() if torch.is_tensor(points)
           else np.asarray(points))
    rng = np.random.default_rng(seed)
    if len(pts) > max_points:
        pts = pts[rng.choice(len(pts), max_points, replace=False)]
    sdf = torch.as_tensor(sdf_fn(torch.as_tensor(pts.astype(np.float32),
                                                 device=dev)))
    sdf = sdf.detach().cpu().numpy()
    valid = np.abs(sdf) < 1.0
    if not valid.any():
        return 0.0
    return float(np.median(sdf[valid]))
