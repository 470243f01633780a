"""Static-shape voxel-hash kNN (port of ``spurfies_tpu/ops/voxel_grid.py``).

The reference's CUDA ``torch_knnquery.VoxelGrid`` finds up to k neighbour
points within radius ``r * voxel_size`` of each ray sample.  As in the JAX
package, the points never move, so each scene builds once a per-cell
candidate list (all points within the radius of the cell's box, packed
front-first, capped at ``qcap``); a query is then the K1 select over its
cell's list (``ops.select_knn``).

Layouts are the JAX package's: ``QueryTable.idx [C, qcap]``,
``QueryTable.pos [C, 3, qcap]`` and the fine occupancy bitmap
``[rows, 128]`` int8, so the tests compare the two packages array for
array.  Orders that JAX's stable ``argsort`` decides use
``torch.argsort(..., stable=True)``.
"""

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from benchmark.plain.device import constant
from benchmark.plain.ops.select_knn import select_knn


@dataclass(frozen=True)
class VoxelGridSpec:
    """Static grid geometry (reference ctor pointneus_disent.py:46-62):
    voxel_size * voxel_scale = cell edge; lo/hi = scene bounds."""
    voxel_size: float = 0.025
    voxel_scale: float = 3.0
    lo: tuple = (-1.0, -1.0, -1.0)
    hi: tuple = (1.0, 1.0, 1.0)
    max_pts_per_cell: int = 26
    kernel: int = 3        # cell search window (3x3x3)
    qcap: int = 128        # per-cell neighbourhood candidate cap

    @property
    def cell_size(self) -> float:
        return self.voxel_size * self.voxel_scale

    @property
    def dims(self) -> tuple:
        return tuple(int(np.ceil((h - l) / self.cell_size))
                     for l, h in zip(self.lo, self.hi))

    @property
    def num_cells(self) -> int:
        dx, dy, dz = self.dims
        return dx * dy * dz

    def radius(self, r: float) -> float:
        """Query radius in world units: r is in voxel_size multiples."""
        return r * self.voxel_size


@dataclass
class QueryTable:
    """Per-cell candidate lists: idx ``[C, qcap]`` int32 (-1 empty), pos
    ``[C, 3, qcap]`` f32 (inf where empty), built for radius ``r``.
    ``n_points`` gates the packed-key K1 variant (ids must fit 15 bits;
    0 = unknown, exact variant)."""
    idx: torch.Tensor
    pos: torch.Tensor
    r: float = 2.0
    n_points: int = 0


def _f32(v, device):
    return constant(v, torch.float32, device)


def _cell_ids(points: torch.Tensor, spec: VoxelGridSpec) -> torch.Tensor:
    """Linear cell id per point (int32); out of range -> num_cells."""
    dev = points.device
    lo = _f32(spec.lo, dev)
    dims = constant(spec.dims, torch.int32, dev)
    ijk = torch.floor((points - lo) / _f32(spec.cell_size, dev)).to(torch.int32)
    in_range = torch.all((ijk >= 0) & (ijk < dims), dim=-1)
    ijk = torch.minimum(torch.clamp(ijk, min=0), dims - 1)
    lin = (ijk[..., 0] * dims[1] + ijk[..., 1]) * dims[2] + ijk[..., 2]
    return torch.where(in_range, lin, spec.num_cells).to(torch.int32)


def build_grid(points: torch.Tensor, spec: VoxelGridSpec) -> torch.Tensor:
    """``[num_cells, max_pts_per_cell]`` int32 point ids, -1 empty; points
    beyond the cap of a cell are dropped (CUDA max_pts_per_voxel)."""
    n = points.shape[0]
    cap = spec.max_pts_per_cell
    cells = spec.num_cells
    cid = _cell_ids(points, spec)
    order = torch.argsort(cid, stable=True)
    cid_sorted = cid[order]
    first = torch.searchsorted(cid_sorted, cid_sorted, side="left")
    slot = torch.arange(n, device=points.device) - first
    valid = (cid_sorted < cells) & (slot < cap)
    flat = torch.where(valid, cid_sorted.long() * cap + slot, cells * cap)
    table = torch.full((cells * cap + 1,), -1, dtype=torch.int32,
                       device=points.device)
    table[flat] = order.to(torch.int32)
    return table[:-1].reshape(cells, cap)


def _kernel_offsets(spec: VoxelGridSpec, radius: float) -> np.ndarray:
    # at least the configured window, widened if the radius exceeds a cell
    half = max(spec.kernel // 2, int(np.ceil(radius / spec.cell_size)))
    rng = np.arange(-half, half + 1)
    return np.stack(np.meshgrid(rng, rng, rng, indexing="ij"),
                    axis=-1).reshape(-1, 3).astype(np.int32)


def build_query_table(points: torch.Tensor, spec: VoxelGridSpec,
                      r: float = 2.0) -> QueryTable:
    """Per-cell candidate lists for radius ``r * voxel_size``: the points of
    the cell's window whose exact distance to the cell BOX is <= radius,
    first ``qcap`` kept, packed front-first."""
    dev = points.device
    radius = spec.radius(r)
    offsets = torch.as_tensor(_kernel_offsets(spec, radius), device=dev)
    dims = torch.tensor(spec.dims, dtype=torch.int32, device=dev)
    lo = _f32(spec.lo, dev)
    cell = _f32(spec.cell_size, dev)
    cap = spec.max_pts_per_cell
    cells = spec.num_cells
    qcap = spec.qcap

    table = build_grid(points, spec)                          # [C, cap]

    cell_lin = torch.arange(cells, dtype=torch.int32, device=dev)
    iz = cell_lin % dims[2]
    iy = (cell_lin // dims[2]) % dims[1]
    ix = cell_lin // (dims[2] * dims[1])
    ijk = torch.stack([ix, iy, iz], -1)                       # [C, 3]

    nb = ijk[:, None, :] + offsets[None]                      # [C, W, 3]
    nb_in = torch.all((nb >= 0) & (nb < dims), dim=-1)
    nbc = torch.minimum(torch.clamp(nb, min=0), dims - 1)
    nb_lin = (nbc[..., 0] * dims[1] + nbc[..., 1]) * dims[2] + nbc[..., 2]
    cand = table[torch.where(nb_in, nb_lin, 0).long()].reshape(cells, -1)
    cand = torch.where(torch.repeat_interleave(nb_in, cap, dim=-1), cand, -1)

    box_lo = lo + ijk.to(torch.float32) * cell                # [C, 3]
    box_hi = box_lo + cell
    safe = torch.clamp(cand, min=0).long()
    d2 = torch.zeros(cand.shape, dtype=torch.float32, device=dev)
    for d in range(3):
        pc = points[:, d][safe]
        excess = torch.clamp(box_lo[:, d:d + 1] - pc, min=0.0) + torch.clamp(
            pc - box_hi[:, d:d + 1], min=0.0)
        d2 = d2 + excess * excess
    keep = (cand >= 0) & (d2 <= _f32(radius * radius, dev))

    width = cand.shape[-1]
    pos_key = torch.where(keep, torch.arange(width, dtype=torch.int32,
                                             device=dev), width)
    order = torch.argsort(pos_key, dim=-1, stable=True)[:, :qcap]
    qidx = torch.gather(cand, 1, order)
    qkeep = torch.gather(keep, 1, order)
    qidx = torch.where(qkeep, qidx, -1)                       # [C, qcap]

    safe_q = torch.clamp(qidx, min=0).long()
    qpos = torch.stack([torch.where(qkeep, points[:, d][safe_q], float("inf"))
                        for d in range(3)], dim=1)            # [C, 3, qcap]
    return QueryTable(idx=qidx.to(torch.int32).contiguous(),
                      pos=qpos.contiguous(), r=r, n_points=points.shape[0])


def fine_spec(spec: VoxelGridSpec) -> VoxelGridSpec:
    """The occupancy-bitmap grid: same bounds, cell edge = voxel_size."""
    return dataclasses.replace(spec, voxel_scale=1.0)


def build_occupancy_bitmap(points: torch.Tensor, spec: VoxelGridSpec,
                           r: float = 2.0) -> torch.Tensor:
    """``[rows, 128]`` int8 (cell ``c`` at ``[c >> 7, c & 127]``, zero past
    ``num_cells``): fine cell has a point within ``r * voxel_size`` of its
    BOX -- the exact cell-granular superset of "a query in this cell can
    have a neighbour".  The JAX package's layout, kept for parity."""
    dev = points.device
    fs = fine_spec(spec)
    radius = spec.radius(r)
    h = _f32(fs.cell_size, dev)
    half = int(np.ceil(radius / fs.cell_size))
    rng = np.arange(-half, half + 1)
    offsets = torch.as_tensor(
        np.stack(np.meshgrid(rng, rng, rng, indexing="ij"),
                 axis=-1).reshape(-1, 3).astype(np.int32), device=dev)
    dims = torch.tensor(fs.dims, dtype=torch.int32, device=dev)
    lo = _f32(fs.lo, dev)

    ijk0 = torch.floor((points - lo) / h).to(torch.int32)     # [N, 3]
    nb = ijk0[:, None, :] + offsets[None]                     # [N, W, 3]
    in_r = torch.all((nb >= 0) & (nb < dims), dim=-1)
    box_lo = lo + nb.to(torch.float32) * h
    box_hi = box_lo + h
    p = points[:, None, :]
    excess = torch.clamp(box_lo - p, min=0.0) + torch.clamp(p - box_hi,
                                                            min=0.0)
    e2 = excess * excess
    d2 = (e2[..., 0] + e2[..., 1]) + e2[..., 2]
    ok = in_r & (d2 <= _f32(radius * radius, dev))
    lin = (nb[..., 0] * dims[1] + nb[..., 1]) * dims[2] + nb[..., 2]
    cells = fs.num_cells
    occ = torch.zeros((cells + 1,), dtype=torch.int8, device=dev)
    occ[torch.where(ok, lin, cells).long()] = 1
    occ = occ[:cells]
    pad = (-cells) % 128
    return torch.cat([occ, occ.new_zeros(pad)]).reshape(-1, 128)


def fine_occupancy(x: torch.Tensor, occ_fine: torch.Tensor,
                   spec: VoxelGridSpec) -> torch.Tensor:
    """Per-position occupancy against the fine bitmap; False guarantees
    query_grid finds no neighbour there.  A direct byte lookup: the JAX
    package's 128-cell row gather + lane select works around the TPU's slow
    one-element gathers and gives the same answer."""
    fs = fine_spec(spec)
    cid = _cell_ids(x, fs)
    in_grid = cid < fs.num_cells
    cid_s = torch.where(in_grid, cid, 0).long()
    return (occ_fine.reshape(-1)[cid_s] != 0) & in_grid


def query_grid(x: torch.Tensor, qt: QueryTable, spec: VoxelGridSpec,
               k: int = 8):
    """k nearest neighbours within the table's radius, nearest first.

    Returns (idx ``[M, k]`` int32, -1 missing; d2 ``[M, k]``, inf invalid).
    The packed K1 variant runs when the cloud's ids fit 15 bits, the gate
    of ``spurfies_tpu/ops/voxel_grid.py:340``; the exact variant otherwise.
    Neighbour selection carries no gradient (x is detached).
    """
    x = x.detach().contiguous()
    radius2 = float(np.float32(spec.radius(qt.r) ** 2))
    cid = _cell_ids(x, spec)          # num_cells (outside) has no neighbours
    packed = 0 < qt.n_points <= 2 ** 15
    return select_knn(x, cid, qt.idx, qt.pos, radius2, k=k, packed=packed)


def compact_rays(valid: torch.Tensor, max_keep: int):
    """First ``max_keep`` True positions along the last axis (the
    reference's ``max_shading_pts`` compaction as gather indices + masks).

    Returns (sel ``[R, max_keep]`` int64 (clipped, garbage where invalid),
    sel_valid ``[R, max_keep]`` bool).
    """
    s = valid.shape[-1]
    ar = torch.arange(s, device=valid.device).expand(valid.shape)
    key = torch.where(valid, ar, s)
    key = torch.sort(key, dim=-1).values[..., :max_keep]
    sel_valid = key < s
    return torch.clamp(key, max=s - 1), sel_valid
