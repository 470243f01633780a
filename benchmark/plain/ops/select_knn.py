"""Radius-limited k-nearest selection over per-cell candidate lists (the
plain version of the port's K1).

Two variants, picked by the caller (``ops.voxel_grid.query_grid`` gates on
the cloud size):
  * exact: order by (d2 ascending, id descending);
  * packed: key = f32 bits of d2 with the low 15 mantissa bits replaced by
    the id; ids must be < 2**15; d2 comes back rounded to ~2**-8 relative.
"""

import torch

ID_BITS = 15
_ID_MASK = (1 << ID_BITS) - 1
_SENTINEL = 1 << 30            # > every packed key (d2 < 2)
SUPPORTED_K = (1, 2, 4, 8, 16)


def select_knn_ref(x, cid, qidx, qpos, radius2: float, k: int = 8,
                   packed: bool = False):
    """Plain version.

    Args:
      x: ``[M, 3]`` f32 queries.
      cid: ``[M]`` int32 cell of each query; outside ``[0, C)`` (e.g. -1):
        outside the grid, no neighbours.
      qidx: ``[C, Q]`` int32 per-cell candidate ids (-1 empty).
      qpos: ``[C, 3, Q]`` f32 candidate positions.
      radius2: squared radius (compared in f32).

    Returns (idx ``[M, k]`` int32 nearest-first, -1 empty; d2 ``[M, k]``
    f32, inf empty).
    """
    m, q = x.shape[0], qidx.shape[1]
    r2 = torch.tensor(radius2, dtype=torch.float32, device=x.device)
    in_grid = (cid >= 0) & (cid < qidx.shape[0])
    c = torch.where(in_grid, cid, 0).long()
    cand = torch.where(in_grid[:, None], qidx[c], -1)          # [M, Q]
    diff = qpos[c] - x[:, :, None]                             # [M, 3, Q]
    d2 = (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]) \
        + diff[:, 2] * diff[:, 2]
    ok = (cand >= 0) & (d2 <= r2)
    if q < k:
        pad = k - q
        cand = torch.cat([cand, cand.new_full((m, pad), -1)], 1)
        d2 = torch.cat([d2, d2.new_full((m, pad), float("inf"))], 1)
        ok = torch.cat([ok, ok.new_zeros((m, pad))], 1)
    if packed:
        key = (d2.view(torch.int32) & ~_ID_MASK) | cand
        key = torch.where(ok, key, _SENTINEL)
        key = torch.sort(key, dim=1).values[:, :k]
        valid = key < _SENTINEL
        idx = torch.where(valid, key & _ID_MASK, -1)
        dk = torch.where(valid, (key & ~_ID_MASK).view(torch.float32),
                         float("inf"))
        return idx.to(torch.int32), dk
    d2 = torch.where(ok, d2, float("inf"))
    # (d2 ascending, id descending): a stable sort by id, then by d2
    by_id = torch.argsort(cand, dim=1, descending=True, stable=True)
    by_d2 = torch.argsort(torch.gather(d2, 1, by_id), dim=1, stable=True)
    pos = torch.gather(by_id, 1, by_d2[:, :k])
    dk = torch.gather(d2, 1, pos)
    idx = torch.where(torch.isfinite(dk), torch.gather(cand, 1, pos), -1)
    return idx.to(torch.int32), dk


def select_knn(x, cid, qidx, qpos, radius2: float, k: int = 8,
               packed: bool = False):
    """The plain selection on any device."""
    return select_knn_ref(x, cid, qidx, qpos, radius2, k, packed)
