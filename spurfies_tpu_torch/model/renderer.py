"""Neural-point VolSDF forward pass and its training losses (port of
``spurfies_tpu/model/renderer.py``; reference
``spurfies/model/pointneus_disent.py:614-908``).

Dense ``[R, S]`` with masks, as in the JAX package: the reference's
``max_shading_pts`` ragged compaction is :func:`ops.voxel_grid.compact_rays`
over the has-neighbour mask, and colour runs on the top-W samples per ray
by rendering weight with the mass rescale.

Both branches are ported: the eval render (``train=False``) and the
training render (``train=True``: stratified sampling, the ray budget, the
probe budget's first/rest split, a differentiable ``grad_theta``), with
``model.fused_agg`` passed to every SDF call, the point budget
(``render_budget_frac``), the pair-compacted SDF (``pair_budget_frac``)
and the pair-compacted colour (``color_pair_frac``).  ``entangled`` and
the training ``occ_compact`` raise ``NotImplementedError`` naming the
``ROADMAP.md`` item that ports them.  Nothing here waits on the card:
masks become spare-slot scatters and compactions sorts or cumsums, never
boolean indexing.
"""

import torch

from spurfies_tpu_torch.config import ModelConfig
from spurfies_tpu_torch.core.cameras import get_camera_params
from spurfies_tpu_torch.core.density import get_beta, laplace_density
from spurfies_tpu_torch.core.quadrature import render_weights
from spurfies_tpu_torch.device import constant
from spurfies_tpu_torch.model import field
from spurfies_tpu_torch.model.sampler import error_bound_z_vals, linspace
from spurfies_tpu_torch.ops.pair_mlp import PriorLayers
from spurfies_tpu_torch.ops.voxel_grid import (
    compact_rays,
    fine_occupancy,
    query_grid,
)


def _check_supported(cfg: ModelConfig, train: bool):
    for name, on, item in (
            ("entangled", cfg.entangled, "15 (legacy entangled model)"),
            ("occ_compact", cfg.occ_compact and train
             and not 0 < cfg.ray_budget_frac < 1,
             "9 (occ_compact, left open by the training slice)")):
        if on:
            raise NotImplementedError(
                f"model.{name}: ROADMAP.md Queue 1 item {item}")


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
        (:func:`model.sampler.error_bound_z_vals`), shaped for the rays the
        body renders: the ray budget's width when it is active.

    Returns a dict of dense ``[R, ...]`` outputs + ``ray_mask``, with the
    ``[]`` bool flags ``ray_budget_overflow`` and ``probe_budget_overflow``.
    """
    _check_supported(cfg, train)
    uv, pose, intrinsics = inputs["uv"], inputs["pose"], inputs["intrinsics"]
    ray_dirs_b, cam_loc_b = get_camera_params(uv, pose, intrinsics)
    ray_dirs = ray_dirs_b.reshape(-1, 3)
    n_rays = ray_dirs.shape[0]
    cam_loc = torch.broadcast_to(cam_loc_b[:, None, :],
                                 ray_dirs_b.shape).reshape(-1, 3)
    # depth scale: z-component of the rays in the camera frame
    eye = torch.eye(4, dtype=pose.dtype, device=pose.device).expand(
        pose.shape)
    dirs_cam, _ = get_camera_params(uv, eye, intrinsics)
    depth_scale = dirs_cam.reshape(-1, 3)[:, 2:]
    body = dict(cfg=cfg, train=train, iters=iters, generator=generator,
                draws=draws)

    if train and 0 < cfg.ray_budget_frac < 1:
        # the training ray budget: a coarse occupancy test over the uniform
        # grid picks the candidate rays first, the whole render runs at the
        # budget's width, and the outputs scatter back dense; overflow rays
        # drop from the batch like misses (renderer.py:65-94)
        budget = -(-int(n_rays * cfg.ray_budget_frac) // 64) * 64
        budget = min(n_rays, max(128, budget))
        if budget < n_rays:
            ray_occ = coarse_ray_occupancy(cam_loc, ray_dirs, scene,
                                           cfg.ray_sampler)
            slot, ok, overflowed = field.compact_pair_slots(ray_occ, budget)
            out = _render_body(params["frozen"], params["train"], scene,
                               cam_loc[slot], ray_dirs[slot],
                               depth_scale[slot], **body)
            probe_ovf = out.pop("probe_budget_overflow")
            dense = _scatter_rays_back(out, slot, ok, n_rays,
                                       cfg.ray_sampler.far)
            dense["probe_budget_overflow"] = probe_ovf
            dense["ray_budget_overflow"] = overflowed
            return dense

    out = _render_body(params["frozen"], params["train"], scene, cam_loc,
                       ray_dirs, depth_scale, **body)
    out["ray_budget_overflow"] = torch.zeros((), dtype=torch.bool,
                                             device=ray_dirs.device)
    return out


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


def _render_body(prior: PriorLayers, tp, scene, cam_loc, ray_dirs,
                 depth_scale, cfg: ModelConfig, *, train: bool, iters: int,
                 generator=None, draws=None):
    scfg = cfg.ray_sampler
    S = cfg.max_shading_pts
    K = cfg.k
    n_rays = ray_dirs.shape[0]

    beta0 = get_beta(tp["beta"], cfg.density.beta_min).detach()
    # probe budgets (renderer.py:205-211): dense at >= 1; a training
    # render's calibrated fraction applies to the first, uniform-z probe
    # only, the later surface-concentrated probes keep the gated 0.25
    if cfg.probe_budget_frac >= 1:
        pf_first = pf_rest = None
    elif train and 0 < cfg.probe_budget_frac < 1:
        pf_first, pf_rest = cfg.probe_budget_frac, 0.25
    else:
        pf_first = pf_rest = 0.25
    geo = tp["feats_geometry"].detach()

    def sdf_probe_fn(x, first=False):
        return field.sdf_probe(prior, geo, scene, x, cfg.probe_k or cfg.k,
                               cfg.r, cfg.rbf,
                               budget_frac=pf_first if first else pf_rest,
                               need_grad=False, return_overflow=True,
                               fused_agg=cfg.fused_agg)

    z_all, probe_overflow = error_bound_z_vals(
        sdf_probe_fn, cam_loc, ray_dirs, scfg, beta0, iters, train=train,
        generator=generator, draws=draws)
    z_all = z_all.detach()
    points = cam_loc[:, None, :] + z_all[..., None] * ray_dirs[:, None, :]

    # query all samples, then first-S compaction by has-neighbour
    idx_all, _ = query_grid(points.reshape(-1, 3), scene.table, scene.spec,
                            k=K)
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

    geo_t = tp["feats_geometry"]
    if cfg.render_budget_frac > 0:
        # the first `budget` valid shading points of the flat [R*S] grid
        # (a sort, renderer.py:302-329); dropped points render as empty
        # space
        m = flat_x.shape[0]
        budget = max(int(m * cfg.render_budget_frac) // 128 * 128, 128)
        ar = torch.arange(m, device=flat_x.device)
        order = torch.sort(torch.where(sel_valid.reshape(-1), ar, m)).values
        order = order[:budget]
        bsel_ok = order < m
        bsel = torch.clamp(order, max=m - 1)
        s_c, g_c = field.sdf_and_grad(
            prior, geo_t, scene.points, flat_idx[bsel],
            flat_valid[bsel] & bsel_ok[:, None], flat_x[bsel], cfg.rbf,
            fused_agg=cfg.fused_agg)
        to = (torch.where(bsel_ok, bsel, m),)
        sdf_flat = torch.full((m + 1,), field.SDF_FILLER, device=ar.device)
        sdf_flat = torch.index_put(sdf_flat, to, torch.where(
            bsel_ok, s_c, field.SDF_FILLER))[:m]
        grad_flat = torch.index_put(
            torch.zeros((m + 1, 3), device=ar.device), to,
            torch.where(bsel_ok[:, None], g_c, 0.0))[:m]
        covered = torch.index_put(torch.zeros(
            (m + 1,), dtype=torch.bool, device=ar.device), to, bsel_ok)[:m]
        sel_valid = sel_valid & covered.reshape(n_rays, S)
    elif cfg.pair_budget_frac > 0:
        budget = max(int(n_rays * S * K * cfg.pair_budget_frac) // 256 * 256,
                     256)
        sdf_flat, grad_flat = field.sdf_and_grad_pairs(
            prior, geo_t, scene.points, flat_idx, flat_valid, flat_x,
            cfg.rbf, budget)
    else:
        sdf_flat, grad_flat = field.sdf_and_grad(
            prior, geo_t, scene.points, flat_idx, flat_valid, flat_x,
            cfg.rbf, fused_agg=cfg.fused_agg)
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
        colors_w = _color_maybe_pairs(
            tp, scene, t_idx.reshape(-1, K), t_valid.reshape(-1, K),
            t_x.reshape(-1, 3), t_dirs.reshape(-1, 3), cfg,
            prior.compute_dtype).reshape(n_rays, W, 3)
        mass_top = torch.sum(w_top, -1, keepdim=True)
        rgb = torch.sum(w_top[..., None] * colors_w, dim=1)
        rgb = rgb * (acc / torch.clamp(mass_top, min=1e-10))
    else:
        flat_dirs = ray_dirs[:, None, :].expand(n_rays, S, 3).reshape(-1, 3)
        colors = _color_maybe_pairs(tp, scene, flat_idx, flat_valid, flat_x,
                                    flat_dirs, cfg, prior.compute_dtype
                                    ).reshape(n_rays, S, 3)
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


def _color_maybe_pairs(tp, scene, idx, valid, x, dirs, cfg: ModelConfig,
                       fused_dtype):
    """Dense or pair-compacted colour (``model.color_pair_frac``;
    ``renderer.py:426-438``).  ``fused_dtype``: the prior's compute dtype,
    which the fused colour kernels run in (``field.FUSED_COLOR``)."""
    if cfg.color_pair_frac > 0:
        m, k = idx.shape
        budget = max(int(m * k * cfg.color_pair_frac) // 256 * 256, 256)
        return field.aggregate_color_pairs(
            tp, tp["feats_color"], scene.points, idx, valid, x, dirs,
            cfg.rbf, budget, cfg.pos_multires, cfg.view_multires)
    return field.aggregate_color(tp, tp["feats_color"], scene.points, idx,
                                 valid, x, dirs, cfg.rbf, cfg.pos_multires,
                                 cfg.view_multires, fused_dtype=fused_dtype)


def pseudo_sdf_loss(params, scene, out, cfg: ModelConfig):
    """L1-to-zero of the SDF at the rendered depth points (reference
    :765-780), a masked mean over the rays whose point has neighbours.
    Dense probe (budget None): the points sit on the surface, mostly
    occupied.  Differentiable in the latents (K4) and in the points."""
    sdf = field.sdf_probe(params["frozen"], params["train"]["feats_geometry"],
                          scene, out["pts_rendered"], cfg.k, cfg.r, cfg.rbf,
                          budget_frac=None, fused_agg=cfg.fused_agg)
    valid = (sdf < field.SDF_FILLER / 2) & out["ray_mask"]
    abs_sdf = torch.where(valid, torch.abs(sdf), 0.0)
    return torch.sum(abs_sdf) / torch.clamp(torch.sum(valid), min=1)


FD_EIKONAL_EPS = 5e-3


def fd_eikonal_loss(params, scene, out, cfg: ModelConfig, n_sub: int = 0,
                    generator=None, sel=None, u=None):
    """Finite-difference eikonal at the shading points (beyond the
    reference; ``renderer.py:460-505``): ``((s(x + eps u) - s(x - eps u)) /
    (2 eps)| - 1)^2`` (eps ``FD_EIKONAL_EPS``) with a random unit direction
    u, neighbours reused from the centre.  Draws, each optional: ``sel
    [n_sub]`` the subset of shading points (when ``0 < n_sub < M``), ``u
    [M', 3]`` the normal draw before normalisation; absent ones come from
    ``generator``."""
    valid = out["valid_pt"].reshape(-1)
    x = out["xyz"].reshape(-1, 3)
    idx = out["nbr_idx"].reshape(-1, cfg.k)
    nbr_valid = out["nbr_valid"].reshape(-1, cfg.k)
    if 0 < n_sub < x.shape[0]:
        if sel is None:
            sel = torch.randint(0, x.shape[0], (n_sub,), generator=generator,
                                device=x.device)
        valid, x = valid[sel], x[sel]
        idx, nbr_valid = idx[sel], nbr_valid[sel]
    if u is None:
        u = torch.randn(x.shape, generator=generator, device=x.device)
    u = u / (torch.linalg.norm(u, dim=-1, keepdim=True) + 1e-12)
    geo = params["train"]["feats_geometry"]
    eps = FD_EIKONAL_EPS
    sp, _ = field.aggregate_sdf(params["frozen"], geo, scene.points, idx,
                                nbr_valid, x + eps * u, cfg.rbf,
                                fused_agg=cfg.fused_agg)
    sm, _ = field.aggregate_sdf(params["frozen"], geo, scene.points, idx,
                                nbr_valid, x - eps * u, cfg.rbf,
                                fused_agg=cfg.fused_agg)
    fd = (sp - sm) / (2.0 * eps)
    ok = valid & (torch.abs(sp) < field.SDF_FILLER / 2) & (
        torch.abs(sm) < field.SDF_FILLER / 2)
    pen = torch.where(ok, (torch.abs(fd) - 1.0) ** 2, 0.0)
    return torch.sum(pen) / torch.clamp(torch.sum(ok), min=1)


def cloud_anchor_loss(params, scene, cfg: ModelConfig, n_points: int = 2048,
                      generator=None, sel=None):
    """L1 of the SDF at sampled input-cloud points (beyond the reference;
    ``renderer.py:508-526``).  ``sel [n_points]``: the sampled point ids,
    drawn from ``generator`` when not given."""
    if sel is None:
        sel = torch.randint(0, scene.points.shape[0], (n_points,),
                            generator=generator, device=scene.points.device)
    sdf = field.sdf_probe(params["frozen"], params["train"]["feats_geometry"],
                          scene, scene.points[sel], cfg.k, cfg.r, cfg.rbf,
                          budget_frac=None, fused_agg=cfg.fused_agg)
    valid = sdf < field.SDF_FILLER / 2
    return torch.sum(torch.where(valid, torch.abs(sdf), 0.0)) / torch.clamp(
        torch.sum(valid), min=1)


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
