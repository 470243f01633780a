"""Brute-force radius-kNN: the test oracle for the voxel-grid query (port of
``spurfies_tpu/ops/knn_brute.py``)."""

import torch


def knn_brute(x: torch.Tensor, points: torch.Tensor, k: int = 8,
              radius: float = 0.05, chunk: int = 4096):
    """k nearest points within ``radius`` of each query, nearest first.

    Returns (idx ``[M, k]`` int32, -1 where missing; d2 ``[M, k]``, inf
    invalid).  Distances are taken directly (no |x|^2 - 2 x.p + |p|^2
    expansion, which loses digits near the radius).
    """
    r2 = torch.tensor(radius * radius, dtype=torch.float32)
    out_i, out_d = [], []
    for s in range(0, x.shape[0], chunk):
        diff = x[s:s + chunk, None, :] - points[None]
        d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) \
            + diff[..., 2] * diff[..., 2]
        d2 = torch.where(d2 <= r2.to(d2.device), d2, float("inf"))
        kk = min(k, d2.shape[1])
        top_d, top_i = torch.topk(d2, kk, dim=1, largest=False, sorted=True)
        if kk < k:
            top_d = torch.cat([top_d, top_d.new_full((top_d.shape[0], k - kk),
                                                     float("inf"))], 1)
            top_i = torch.cat([top_i, top_i.new_zeros((top_i.shape[0],
                                                       k - kk))], 1)
        out_i.append(torch.where(torch.isfinite(top_d), top_i, -1))
        out_d.append(top_d)
    return torch.cat(out_i).to(torch.int32), torch.cat(out_d)
