"""Multi-view feature-consistency ("local") loss (port of
``spurfies_tpu/model/local_loss.py``).

Reference ``spurfies/feat_utils.py:377-451`` (get_local_loss) and the
surface localization of ``pointneus_disent.py:586-612, 727-763``:
  * surface points = the first backward-facing SDF zero crossing along each
    ray, lerped between its two samples;
  * the points go to world mm by ``p / 2 * size + center``, are projected
    into the reference and source Vis-MVSNet cameras (cam[0] extrinsic,
    cam[1] intrinsic), and the features are sampled bilinearly at half the
    camera's pixel coordinates (the feature maps are at half resolution);
  * loss = the mean over (points x source views) of ``|1 - cos(f_ref,
    f_src)|``, kept where both projections are in range and the term is
    below 0.5.

Everything stays ``[R]``-shaped with masks (no boolean indexing, nothing
read back).  The JAX package computes all of this outside any Pallas
kernel, so plain PyTorch ops are the port: the bilinear sample is the
JAX module's four-tap gather with zero padding (``align_corners=False``),
equal to ``F.grid_sample`` (``tests/test_torch_local_loss.py``).
"""

import torch

from benchmark.plain.model.losses import valid_count


def find_surface_depth(sdf: torch.Tensor, z_vals: torch.Tensor,
                       valid: torch.Tensor, filler: float = 1000.0):
    """First backward-facing zero crossing per ray, lerped.

    Args:
      sdf: ``[R, S]`` (filler where invalid); z_vals: ``[R, S]``;
      valid: ``[R, S]``.

    Returns (d_surface ``[R]``, mask ``[R]``): 0 and False where no ray
    crossing.  The first crossing is the ``argmax`` of the crossings as
    int32 (``torch.argmax`` returns the first maximum; a bool argmax is not
    defined on every backend).

    The lerp divides by ``sdf0 - sdf1`` only where that is above 1e-12 (the
    JAX function divides everywhere and selects after): the values are the
    same, and so is the gradient wherever JAX's is finite, but a ray with
    no crossing whose first two samples carry the same SDF (two samples a
    few ulps apart) gives JAX a 0/0 and a NaN gradient, which skips the
    whole training step (``tests/test_torch_local_loss.py``).
    """
    ok = valid & (sdf < filler / 2)
    s0, s1 = sdf[:, :-1], sdf[:, 1:]
    pair_ok = ok[:, :-1] & ok[:, 1:]
    crossing = (s0 * s1 < 0) & (s1 < s0) & pair_ok          # [R, S-1]
    has = torch.any(crossing, dim=-1)
    first = torch.argmax(crossing.to(torch.int32), dim=-1)[:, None]
    sdf0 = torch.gather(sdf, 1, first)[:, 0]
    sdf1 = torch.gather(sdf, 1, first + 1)[:, 0]
    d0 = torch.gather(z_vals, 1, first)[:, 0]
    d1 = torch.gather(z_vals, 1, first + 1)[:, 0]
    denom = sdf0 - sdf1
    big = torch.abs(denom) > 1e-12
    safe = torch.where(big, denom, 1.0)
    d = torch.where(big, (sdf0 * d1 - sdf1 * d0) / safe, d0)
    return torch.where(has, d, 0.0), has


def grid_sample_bilinear(feat: torch.Tensor, xy: torch.Tensor):
    """Bilinear sample with zero padding, ``align_corners=False``.

    Args:
      feat: ``[H, W, C]``; xy: ``[N, 2]`` pixel coordinates (x, y) in the
        feature map's scale.

    Returns ``[N, C]``.
    """
    h, w, _ = feat.shape
    x = xy[:, 0] - 0.5
    y = xy[:, 1] - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = (x - x0)[:, None]
    ty = (y - y0)[:, None]
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)

    def tap(yy, xx):
        inb = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        v = feat[torch.clamp(yy, 0, h - 1), torch.clamp(xx, 0, w - 1)]
        return torch.where(inb[:, None], v, 0.0)

    return (tap(y0, x0) * (1 - tx) * (1 - ty)
            + tap(y0, x0 + 1) * tx * (1 - ty)
            + tap(y0 + 1, x0) * (1 - tx) * ty
            + tap(y0 + 1, x0 + 1) * tx * ty)


def project_mvs(pts_world: torch.Tensor, cam: torch.Tensor):
    """World points to image pixels through a Vis-MVSNet camera pair
    (cam[0] the 4x4 extrinsic w2c, cam[1] the 4x4 intrinsic; reference
    idx_world2cam / idx_cam2img, feat_utils.py:43-55).

    Returns (xy ``[N, 2]``, z ``[N]``).
    """
    pc = pts_world @ cam[0, :3, :3].T + cam[0, :3, 3]
    pi = pc @ cam[1, :3, :3].T
    return pi[:, :2] / (pi[:, 2:3] + 1e-9), pc[:, 2]


def local_feature_loss(surface_pts, surf_mask, feat_ref, feats_src,
                       cam_ref, cams_src, size, center,
                       feat_scale: float = 0.5, count_fn=None):
    """The dense local loss.

    Args:
      surface_pts: ``[R, 3]`` normalized-space surface points.
      surf_mask: ``[R]`` rays with a surface crossing.
      feat_ref: ``[Hf, Wf, C]``; feats_src: ``[V, Hf, Wf, C]``.
      cam_ref: ``[2, 4, 4]``; cams_src: ``[V, 2, 4, 4]`` (the hd cams; the
        feature maps are at ``feat_scale`` times their resolution,
        reference grid/2, feat_utils.py:417-420).
      size, center: the world denormalization (dtu.py:225-226).
      count_fn: as in :func:`model.losses.valid_count`.

    Returns the mean of the kept terms over (points x source views).
    """
    pts_world = surface_pts / 2.0 * size + center
    xy_ref, _ = project_mvs(pts_world, cam_ref)
    f_ref = grid_sample_bilinear(feat_ref, xy_ref * feat_scale)
    h, w, _ = feat_ref.shape

    def in_range(xy):
        # the reference normalizes by size, then clamps: in range = |n| <= 1
        gx = xy[:, 0] * feat_scale / w * 2 - 1
        gy = xy[:, 1] * feat_scale / h * 2 - 1
        return (torch.abs(gx) <= 1) & (torch.abs(gy) <= 1)

    ref_in = in_range(xy_ref)
    nr = torch.linalg.norm(f_ref, dim=-1)
    total = 0.0
    n_views = feats_src.shape[0]
    for v in range(n_views):
        xy_s, _ = project_mvs(pts_world, cams_src[v])
        f_src = grid_sample_bilinear(feats_src[v], xy_s * feat_scale)
        valid = ref_in & in_range(xy_s) & surf_mask
        ns = torch.linalg.norm(f_src, dim=-1)
        corr = torch.sum(f_ref * f_src, -1) / (
            torch.clamp(nr, min=1e-9) * torch.clamp(ns, min=1e-9))
        corr_loss = torch.abs(1.0 - corr)
        keep = valid & (corr_loss < 0.5)
        # the reference means over all (points x src) elements of the slice
        total = total + torch.sum(torch.where(keep, corr_loss, 0.0))
    return total / (torch.clamp(valid_count(surf_mask, count_fn), min=1)
                    * n_views)
