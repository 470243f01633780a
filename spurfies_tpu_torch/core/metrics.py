"""Image metrics (port of ``spurfies_tpu/core/metrics.py``)."""

import math

import torch


def psnr(img1: torch.Tensor, img2: torch.Tensor,
         mask: torch.Tensor | None = None) -> torch.Tensor:
    """PSNR over (optionally masked) pixels (reference
    ``rend_util.get_psnr`` and the masked variant of ``train.py:445-451``)."""
    se = (img1 - img2) ** 2
    if mask is not None:
        mask = torch.broadcast_to(mask, se.shape).to(se.dtype)
        mse = torch.sum(se * mask) / torch.clamp(torch.sum(mask), min=1.0)
    else:
        mse = torch.mean(se)
    return -10.0 * torch.log(mse) / math.log(10.0)
