"""VolSDF loss stack (port of ``spurfies_tpu/model/losses.py``).

Reference ``spurfies/model/loss.py:18-101`` + ``config/ours.yaml:15-20``:
total = 1.0*rgb(L1) + 0.001*eikonal + 0.01*TV + 0.5*local + 0.5*pseudo +
1.0*mask-BCE(sum-weights vs mask), plus the two beyond-reference terms
(cloud anchor, finite-difference eikonal) whose weights default to 0.
"""

import torch

from spurfies_tpu_torch.config import LossConfig
from spurfies_tpu_torch.device import constant


def rgb_loss(pred, gt, kind: str = "l1"):
    if kind == "l1":
        return torch.mean(torch.abs(pred - gt))
    return torch.mean((pred - gt) ** 2)


def eikonal_loss(grad_theta, valid):
    """``(|grad| - 1)^2``, a masked mean over the valid shading points
    (reference loss.py:47-49).

    Invalid rows carry exactly-zero gradients; a unit vector stands in for
    them before the norm, so that the backward pass stays finite (the
    norm's derivative at 0 is 0/0)."""
    unit = constant((1.0, 0.0, 0.0), grad_theta.dtype, grad_theta.device)
    safe = torch.where(valid[..., None], grad_theta, unit)
    per = (torch.linalg.norm(safe, dim=-1) - 1.0) ** 2
    per = torch.where(valid, per, 0.0)
    return torch.sum(per) / torch.clamp(torch.sum(valid), min=1)


def mask_bce_loss(weights_sum, mask_gt):
    """BCE of the accumulated weights against the foreground mask, clipped
    (reference loss.py:69-75)."""
    p = torch.clamp(weights_sum, 1e-3, 1.0 - 1e-3)
    return -torch.mean(mask_gt * torch.log(p)
                       + (1.0 - mask_gt) * torch.log(1.0 - p))


def fd_eikonal_weight_at(cfg: LossConfig, step=None):
    """The fd-eikonal weight at ``step`` (an int tensor): with annealing,
    it decays geometrically from ``fd_eikonal_anneal_init`` to
    ``fd_eikonal_weight`` over ``fd_eikonal_anneal_steps``, then stays."""
    w = cfg.fd_eikonal_weight
    if (cfg.fd_eikonal_anneal_init <= 0 or cfg.fd_eikonal_anneal_steps <= 0
            or w <= 0 or step is None):
        return w
    frac = torch.clamp(
        1.0 - step.to(torch.float32) / cfg.fd_eikonal_anneal_steps, 0.0, 1.0)
    return w * (cfg.fd_eikonal_anneal_init / w) ** frac


def total_loss(outputs, ground_truth, cfg: LossConfig, step=None):
    """Weighted sum; returns (scalar, dict of parts).  Terms the outputs do
    not hold (tv, local, pseudo, cloud anchor, fd eikonal) count 0."""
    gt_rgb = ground_truth["rgb"].reshape(-1, 3)
    mask = ground_truth["mask"]
    gt_mask = mask.reshape(-1, mask.shape[-1])[:, :1]
    zero = torch.zeros((), dtype=gt_rgb.dtype, device=gt_rgb.device)

    parts = {
        "rgb_loss": rgb_loss(outputs["rgb_values"], gt_rgb, cfg.rgb_loss),
        "eikonal_loss": eikonal_loss(outputs["grad_theta"],
                                     outputs["valid_pt"]),
        "tv_loss": outputs.get("tv_loss", zero),
        "mask_loss": mask_bce_loss(
            torch.sum(outputs["weights"], -1, keepdim=True), gt_mask),
        "local_loss": outputs.get("local_loss", zero),
        "pseudo_loss": outputs.get("pseudo_pts_loss", zero),
        "cloud_anchor_loss": outputs.get("cloud_anchor_loss", zero),
        "fd_eikonal_loss": outputs.get("fd_eikonal_loss", zero),
    }
    loss = (cfg.rgb_weight * parts["rgb_loss"]
            + cfg.eikonal_weight * parts["eikonal_loss"]
            + cfg.tv_weight * parts["tv_loss"]
            + cfg.local_weight * parts["local_loss"]
            + cfg.pseudo_weight * parts["pseudo_loss"]
            + cfg.mask_weight * parts["mask_loss"]
            + cfg.cloud_anchor_weight * parts["cloud_anchor_loss"]
            + fd_eikonal_weight_at(cfg, step) * parts["fd_eikonal_loss"])
    parts["loss"] = loss
    return loss, parts
