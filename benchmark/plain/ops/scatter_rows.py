"""Row scatter-add: ``out[idx[m]] += ct[m]``, a row whose index lies
outside ``[0, n)`` dropped (the plain version of the port's K5)."""

import torch


def scatter_add_rows(ct: torch.Tensor, idx: torch.Tensor, n: int):
    """``index_add_`` of the kept rows into ``[n, d]`` f32."""
    keep = (idx >= 0) & (idx < n)
    out = torch.zeros((n + 1, ct.shape[1]), dtype=torch.float32,
                      device=ct.device)
    out.index_add_(0, torch.where(keep, idx, n).long(), ct.float())
    return out[:n]
