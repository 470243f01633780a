"""Neural-point VolSDF forward pass and its training losses: the plain
version of the port's ``model/renderer.py`` (reference
``spurfies/model/pointneus_disent.py:614-908``) at the default model
options: dense ``[R, S]`` with masks, the has-neighbour compaction to
``max_shading_pts`` columns, colour on the top-W samples per ray by
rendering weight with the mass rescale, the training ray budget and the
probe budget's first/rest split.
"""

import torch

from benchmark.plain.config import ModelConfig
from benchmark.plain.core.cameras import get_camera_params
from benchmark.plain.core.density import get_beta, laplace_density
from benchmark.plain.core.quadrature import render_weights
from benchmark.plain.device import constant
from benchmark.plain.model import field
from benchmark.plain.model.losses import valid_count
from benchmark.plain.model.sampler import (
    error_bound_z_vals,
    linspace,
    training_draws,
)
from benchmark.plain.ops.pair_mlp import PriorLayers
from benchmark.plain.ops.voxel_grid import (
    compact_rays,
    fine_occupancy,
    query_grid,
)


def _take(vals: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """``vals[r, sel[r, s], ...]`` -- ``torch.gather``.  The JAX package's
    one-hot compare-reduce (``_take_z`` / ``_take_rows``) works around the
    TPU's slow gathers and gives the same values."""
    if vals.ndim == 2:
        return torch.gather(vals, 1, sel)
    idx = sel[..., None].expand(*sel.shape, vals.shape[-1])
    return torch.gather(vals, 1, idx)


def render_rays(params, scene, inputs, cfg: ModelConfig, *, train: bool,
                iters: int, generator=None, draws=None):
    """Render a batch of rays.

    Args:
      params: ``{"frozen": PriorLayers, "train": ...}``; the frozen prior is
        prepared once by ``ops.pair_mlp._prep_layers``, whose compute dtype
        the pair MLP runs in.
      scene: SceneState.
      inputs: ``uv [1, R, 2]``, ``pose [1, 4, 4]``, ``intrinsics [1, 4, 4]``.
      train: stratified sampling, the ray budget, differentiable
        ``grad_theta``; eval adds ``normal_map``.
      iters: sampler iterations.
      generator: ``torch.Generator`` on the rays' device for the training
        draws that ``draws`` does not give.
      draws: optional training draws of the sampler
        (:func:`model.sampler.training_draws`), shaped for the whole
        batch's rays the body renders: the ray budget's width when it is
        active.
    Returns a dict of dense ``[R, ...]`` outputs + ``ray_mask``, with the
    ``[]`` bool flags ``ray_budget_overflow`` and ``probe_budget_overflow``
    """
    uv, pose, intrinsics = inputs["uv"], inputs["pose"], inputs["intrinsics"]
    ray_dirs_b, cam_loc_b = get_camera_params(uv, pose, intrinsics)
    ray_dirs = ray_dirs_b.reshape(-1, 3)
    cam_loc = torch.broadcast_to(cam_loc_b[:, None, :],
                                 ray_dirs_b.shape).reshape(-1, 3)
    # depth scale: z-component of the rays in the camera frame
    eye = torch.eye(4, dtype=pose.dtype, device=pose.device).expand(
        pose.shape)
    dirs_cam, _ = get_camera_params(uv, eye, intrinsics)
    depth_scale = dirs_cam.reshape(-1, 3)[:, 2:]
    if train:
        return _render_share(params, scene, cam_loc, ray_dirs, depth_scale,
                             cfg, iters, generator, draws)
    out = _render_body(params["frozen"], params["train"], scene, cam_loc,
                       ray_dirs, depth_scale, cfg, train=False, iters=iters)
    out["ray_budget_overflow"] = torch.zeros((), dtype=torch.bool,
                                             device=ray_dirs.device)
    return out


def ray_budget(n_rays: int, cfg: ModelConfig):
    """The training ray budget's width for a batch of ``n_rays`` rays, or
    None when it renders every ray (off, or a budget
    as wide as the batch)."""
    if not 0 < cfg.ray_budget_frac < 1:
        return None
    budget = -(-int(n_rays * cfg.ray_budget_frac) // 64) * 64
    budget = min(n_rays, max(128, budget))
    return budget if budget < n_rays else None


def _render_share(params, scene, cam_loc, ray_dirs, depth_scale,
                  cfg: ModelConfig, iters: int, generator, draws):
    """A training render.  The training ray budget (renderer.py:65-94): a
    coarse occupancy test over the uniform grid picks the candidate rays
    first, the render runs at the budget's width, and the outputs scatter
    back dense; overflow rays drop from the batch like misses."""
    n_rays = ray_dirs.shape[0]
    dev = ray_dirs.device
    budget = ray_budget(n_rays, cfg)
    if budget is not None:
        ray_occ = coarse_ray_occupancy(cam_loc, ray_dirs, scene,
                                       cfg.ray_sampler)
        slot, ok, overflowed = field.compact_pair_slots(ray_occ, budget)
    else:
        overflowed = torch.zeros((), dtype=torch.bool, device=dev)
    width = n_rays if budget is None else slot.shape[0]
    draws = training_draws(cfg.ray_sampler, width, iters, dev, generator,
                           given=draws)
    body = dict(cfg=cfg, train=True, iters=iters)
    if budget is None:
        out = _render_body(params["frozen"], params["train"], scene,
                           cam_loc, ray_dirs, depth_scale, draws=draws,
                           **body)
        out["ray_budget_overflow"] = overflowed
        return out
    out = _render_body(params["frozen"], params["train"], scene,
                       cam_loc[slot], ray_dirs[slot], depth_scale[slot],
                       draws=draws, ray_ok=ok, **body)
    probe_ovf = out.pop("probe_budget_overflow")
    dense = _scatter_rays_back(out, slot, ok, n_rays, cfg.ray_sampler.far)
    dense["probe_budget_overflow"] = probe_ovf
    dense["ray_budget_overflow"] = overflowed
    return dense


_SCATTER_DEFAULTS = {
    "rgb_values": 0.0, "depth_values": 1.0, "acc": 0.0, "weights": 0.0,
    "depth_vals": None, "xyz": 0.0, "sdf": field.SDF_FILLER, "z_sel": 0.0,
    "valid_pt": False, "ray_mask": False, "pts_rendered": 0.0,
    "grad_theta": 0.0, "nbr_idx": -1, "nbr_valid": False, "cam_loc": 0.0,
    "ray_dirs": 0.0, "normal_map": 0.0,
}


def _scatter_rays_back(out, slot, ok, n_rays: int, far: float):
    """Expand a ray-compacted output dict back to dense ``[n_rays, ...]``.

    Unused budget slots (ok False) land on a spare last row that is cut
    off (a masked index would wait on the card); rays the budget dropped
    keep defaults that read as 'ray missed' to every consumer.  Gradients
    flow back through the scatter."""
    to = torch.where(ok, slot, n_rays)
    dense = {}
    for key, v in out.items():
        d = far if key == "depth_vals" else _SCATTER_DEFAULTS[key]
        buf = torch.full((n_rays + 1,) + v.shape[1:], d, dtype=v.dtype,
                         device=v.device)
        dense[key] = torch.index_put(buf, (to,), v)[:n_rays]
    return dense


def coarse_ray_occupancy(cam_loc, ray_dirs, scene, scfg):
    """Per ray: does any of the n_samples_eval uniform-grid samples land in
    an occupied FINE cell?  A superset of the render's has-neighbour ray
    mask (the eval skip-empty test)."""
    z = linspace(scfg.near, scfg.far, scfg.n_samples_eval, cam_loc.device)
    pts = cam_loc[:, None, :] + z[None, :, None] * ray_dirs[:, None, :]
    occ = fine_occupancy(pts.reshape(-1, 3), scene.occ_fine, scene.spec)
    return torch.any(occ.reshape(pts.shape[0], -1), dim=-1)


def _sample_z(prior: PriorLayers, tp, scene, cam_loc, ray_dirs,
              cfg: ModelConfig, train: bool, iters: int, beta0, draws,
              ray_ok):
    """The error-bounded z-values of the disentangled model and the probe
    budget's overflow flag.  Probe budgets (renderer.py:205-211): dense at
    >= 1; a training render's calibrated fraction applies to the first,
    uniform-z probe only, the later surface-concentrated probes keep the
    gated 0.25."""
    n_rays = ray_dirs.shape[0]
    if cfg.probe_budget_frac >= 1:
        pf_first = pf_rest = None
    elif train and 0 < cfg.probe_budget_frac < 1:
        pf_first, pf_rest = cfg.probe_budget_frac, 0.25
    else:
        pf_first = pf_rest = 0.25
    geo = tp["feats_geometry"].detach()

    def sdf_probe_fn(x, first=False):
        # the sampler's probe points are ray-major [R * Z]
        live = None if ray_ok is None else ray_ok[:, None].expand(
            n_rays, x.shape[0] // n_rays).reshape(-1)
        return field.sdf_probe(prior, geo, scene, x, cfg.probe_k or cfg.k,
                               cfg.r, cfg.rbf,
                               budget_frac=pf_first if first else pf_rest,
                               need_grad=False, return_overflow=True,
                               live=live)

    return error_bound_z_vals(sdf_probe_fn, cam_loc, ray_dirs,
                              cfg.ray_sampler, beta0, iters, train=train,
                              draws=draws)


def _render_body(prior: PriorLayers, tp, scene, cam_loc, ray_dirs,
                 depth_scale, cfg: ModelConfig, *, train: bool, iters: int,
                 draws=None, ray_ok=None):
    """The render of ``[R]`` rays; a training render's ``draws`` are every
    draw of its sampler (:func:`model.sampler.training_draws`).
    ``ray_ok`` ``[R]`` bool: the ray budget's live slots
    (:func:`field.compact_pair_slots`' ok, a prefix);
    the spare slots repeat the batch's last ray and their outputs are cut
    away, so their probe points take no probe-budget slot and read as
    empty space.  The live points keep their ranks (every spare point
    comes after them), so every output of a live ray is what it was, and
    ``probe_budget_overflow`` counts only a live ray's dropped probe.
    ``prior`` is None for the entangled model, which has no frozen
    prior."""
    scfg = cfg.ray_sampler
    S = cfg.max_shading_pts
    K = cfg.k
    n_rays = ray_dirs.shape[0]

    beta0 = get_beta(tp["beta"], cfg.density.beta_min).detach()
    z_all, probe_overflow = _sample_z(prior, tp, scene, cam_loc, ray_dirs,
                                      cfg, train, iters, beta0, draws,
                                      ray_ok)
    z_all = z_all.detach()
    S = min(S, z_all.shape[1])
    points = cam_loc[:, None, :] + z_all[..., None] * ray_dirs[:, None, :]
    flat_pts = points.reshape(-1, 3)

    # query all samples, then first-S compaction by has-neighbour
    idx_all, _ = query_grid(flat_pts, scene.table, scene.spec, k=K)
    idx_all = idx_all.reshape(n_rays, -1, K)
    has_any = torch.any(idx_all >= 0, dim=-1)               # [R, Z]
    sel, sel_valid = compact_rays(has_any, S)               # [R, S]
    z_sel = torch.where(sel_valid, _take(z_all, sel), 0.0)
    nbr_idx = _take(idx_all, sel)                           # [R, S, K]
    nbr_valid = (nbr_idx >= 0) & sel_valid[..., None]

    # deltas over the compacted grid (reference filter_points :226-232)
    z_pad = torch.cat([z_sel, torch.zeros_like(z_sel[..., :1])], -1)
    deltas = z_pad[..., 1:] - z_pad[..., :-1]
    deltas = torch.clamp(torch.where(sel_valid, deltas, 0.0), min=0.0)

    shading_pts = cam_loc[:, None, :] + z_sel[..., None] * ray_dirs[:, None, :]
    flat_x = shading_pts.reshape(-1, 3)
    flat_idx = nbr_idx.reshape(-1, K)
    flat_valid = nbr_valid.reshape(-1, K)

    sdf_flat, grad_flat = field.sdf_and_grad(
        prior, tp["feats_geometry"], scene.points, flat_idx, flat_valid,
        flat_x, cfg.rbf)
    sdf = sdf_flat.reshape(n_rays, S)
    gradients = grad_flat.reshape(n_rays, S, 3)

    valid_pt = sel_valid
    beta = get_beta(tp["beta"], cfg.density.beta_min)
    density = torch.where(valid_pt, laplace_density(sdf, beta), 0.0)
    weights = render_weights(deltas, density)               # [R, S]
    acc = torch.sum(weights, -1, keepdim=True)

    W = cfg.color_top_samples
    if 0 < W < S:
        # colour only the top-W samples per ray by rendering weight,
        # rescaled to the total weight mass.  A stable descending sort
        # breaks ties by the lower index, as lax.top_k does.
        w_masked = torch.where(valid_pt, weights, -1.0)
        w_top, top = torch.sort(w_masked, dim=-1, descending=True,
                                stable=True)
        w_top = torch.clamp(w_top[:, :W], min=0.0)
        top = top[:, :W]
        t_idx = _take(nbr_idx, top)
        t_valid = _take(nbr_valid, top)
        t_x = _take(shading_pts, top)
        t_dirs = ray_dirs[:, None, :].expand(n_rays, W, 3)
        colors_w = _color(
            tp, scene, t_idx.reshape(-1, K), t_valid.reshape(-1, K),
            t_x.reshape(-1, 3), t_dirs.reshape(-1, 3), cfg).reshape(
                n_rays, W, 3)
        mass_top = torch.sum(w_top, -1, keepdim=True)
        rgb = torch.sum(w_top[..., None] * colors_w, dim=1)
        rgb = rgb * (acc / torch.clamp(mass_top, min=1e-10))
    else:
        flat_dirs = ray_dirs[:, None, :].expand(n_rays, S, 3).reshape(-1, 3)
        colors = _color(tp, scene, flat_idx, flat_valid, flat_x, flat_dirs,
                        cfg).reshape(n_rays, S, 3)
        colors = torch.where(valid_pt[..., None], colors, 0.0)
        rgb = torch.sum(weights[..., None] * colors, dim=1)
    depth = torch.sum(weights * z_sel, -1, keepdim=True) / (acc + 1e-8)

    ray_mask = torch.any(valid_pt, dim=-1)

    # pseudo-SDF points: weight-normalized rendered depth (reference :765-775)
    w_norm = weights / (torch.sum(weights, -1, keepdim=True) + 1e-10)
    dist_map = torch.sum(w_norm * z_sel, -1)
    pts_rendered = cam_loc + ray_dirs * dist_map[:, None]

    rm = ray_mask[:, None]
    out = {
        "rgb_values": torch.where(rm, rgb, 0.0),
        "depth_values": torch.where(rm, depth, 1.0),
        "acc": torch.where(rm, acc, 0.0),
        "weights": torch.where(rm, weights, 0.0),
        "depth_vals": torch.where(rm, z_sel * depth_scale, scfg.far),
        "xyz": torch.where(valid_pt[..., None], shading_pts, 0.0),
        "sdf": torch.where(valid_pt, sdf, field.SDF_FILLER),
        "z_sel": z_sel,
        "valid_pt": valid_pt,
        "ray_mask": ray_mask,
        "pts_rendered": pts_rendered,
        "grad_theta": gradients,
        "nbr_idx": nbr_idx,
        "nbr_valid": nbr_valid,
        "cam_loc": cam_loc,
        "ray_dirs": ray_dirs,
        "probe_budget_overflow": probe_overflow,
    }
    if cfg.white_bkgd:
        out["rgb_values"] = out["rgb_values"] + (1.0 - acc) * constant(
            tuple(cfg.bg_color), acc.dtype, acc.device)

    if not train:
        g = gradients.detach()
        normals = g / (field._norm3(g)[..., None] + 1e-12)
        normals = torch.where(valid_pt[..., None], normals, 0.0)
        out["normal_map"] = torch.sum(weights[..., None] * normals, dim=1)
    return out


def _color(tp, scene, idx, valid, x, dirs, cfg: ModelConfig):
    return field.aggregate_color(tp, tp["feats_color"], scene.points, idx,
                                 valid, x, dirs, cfg.rbf, cfg.pos_multires,
                                 cfg.view_multires)


def pseudo_sdf_loss(params, scene, out, cfg: ModelConfig):
    """L1-to-zero of the SDF at the rendered depth points (reference
    :765-780), a masked mean over the rays whose point has neighbours."""
    pts, mask = out["pts_rendered"], out["ray_mask"]
    sdf = field.sdf_probe(params["frozen"], params["train"]["feats_geometry"],
                          scene, pts, cfg.k, cfg.r, cfg.rbf,
                          budget_frac=None)
    valid = (sdf < field.SDF_FILLER / 2) & mask
    abs_sdf = torch.where(valid, torch.abs(sdf), 0.0)
    return torch.sum(abs_sdf) / torch.clamp(valid_count(valid), min=1)


def tv_loss(params, scene):
    """Graph TV on the geometry latents (reference utils.tv_regul
    :221-282): inverse-distance-weighted L1 over the scene's kNN graph.
    The neighbour latents are gathered with ``index_select``, whose
    backward is an ``index_add_`` (indexing's would be a sorted
    ``index_put_``)."""
    feats = params["train"]["feats_geometry"]
    pts = scene.points
    idx, valid = scene.tv_idx, scene.tv_valid
    npos = pts[idx]                                       # [N, k, 3]
    d = torch.linalg.norm(npos - pts[:, None, :], dim=-1)
    w = torch.where(valid, 1.0 / (d + 1e-5), 0.0)
    nbr = torch.index_select(feats, 0, idx.reshape(-1)).view(
        *idx.shape, feats.shape[1])
    fdist = torch.sum(torch.abs(nbr - feats[:, None, :]), dim=-1)
    num = torch.sum(w * fdist, dim=-1)
    den = torch.sum(w, dim=-1)
    return torch.mean(num / torch.clamp(den, min=1e-12))
