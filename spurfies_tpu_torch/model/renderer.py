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
(``render_budget_frac``), the pair-compacted SDF (``pair_budget_frac``),
the pair-compacted colour (``color_pair_frac``), the training
``occ_compact`` (the S columns picked by fine occupancy before the kNN
query) and the legacy ``entangled`` model (uniform z-values, one trunk for
SDF and colour, no ray budget).  Nothing here waits on the card: masks
become spare-slot scatters and compactions sorts or cumsums, never boolean
indexing.
"""

import torch

from spurfies_tpu_torch.config import ModelConfig
from spurfies_tpu_torch.core.cameras import get_camera_params
from spurfies_tpu_torch.core.density import get_beta, laplace_density
from spurfies_tpu_torch.core.quadrature import render_weights
from spurfies_tpu_torch.device import constant
from spurfies_tpu_torch.model import field
from spurfies_tpu_torch.model.losses import valid_count
from spurfies_tpu_torch.model.sampler import (
    RAY_DRAWS,
    error_bound_z_vals,
    linspace,
    training_draws,
    uniform_z_vals,
)
from spurfies_tpu_torch.ops.pair_mlp import PriorLayers
from spurfies_tpu_torch.ops.voxel_grid import (
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
                iters: int, generator=None, draws=None, group=None):
    """Render a batch of rays.

    Args:
      params: ``{"frozen": PriorLayers, "train": ...}``; the frozen prior is
        prepared once by ``ops.pair_mlp._prep_layers``, whose compute dtype
        the pair MLP runs in.
      scene: SceneState.
      inputs: ``uv [1, R, 2]``, ``pose [1, 4, 4]``, ``intrinsics [1, 4, 4]``.
      train: stratified sampling, the ray budget, differentiable
        ``grad_theta``; eval adds ``normal_map``.  ``model.occ_compact``
        acts on a training render without the ray budget only, as in the
        JAX package (``renderer.py:229-230``).
      iters: sampler iterations.
      generator: ``torch.Generator`` on the rays' device for the training
        draws that ``draws`` does not give.
      draws: optional training draws of the sampler
        (:func:`model.sampler.training_draws`), shaped for the whole
        batch's rays the body renders: the ray budget's width when it is
        active.  The entangled model draws only ``"u_z"``, its stratified
        jitter ``[R, n_samples]`` (``sampler.py:35``).
      group: a :class:`parallel.mesh.RankGroup` of a ray-sharded training
        step (:func:`_render_share`): this rank renders its share of the
        rays.

    Returns a dict of dense ``[R, ...]`` outputs + ``ray_mask``, with the
    ``[]`` bool flags ``ray_budget_overflow`` and ``probe_budget_overflow``
    (under ``group`` also ``ray_own`` and ``ray_rows``).
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
                             cfg, iters, generator, draws, group)
    out = _render_body(params["frozen"], params["train"], scene, cam_loc,
                       ray_dirs, depth_scale, cfg, train=False, iters=iters)
    out["ray_budget_overflow"] = torch.zeros((), dtype=torch.bool,
                                             device=ray_dirs.device)
    return out


def ray_budget(n_rays: int, cfg: ModelConfig):
    """The training ray budget's width for a batch of ``n_rays`` rays, or
    None when it renders every ray (off, the entangled model, or a budget
    as wide as the batch)."""
    if not 0 < cfg.ray_budget_frac < 1 or cfg.entangled:
        return None
    budget = -(-int(n_rays * cfg.ray_budget_frac) // 64) * 64
    budget = min(n_rays, max(128, budget))
    return budget if budget < n_rays else None


def _render_share(params, scene, cam_loc, ray_dirs, depth_scale,
                  cfg: ModelConfig, iters: int, generator, draws, group):
    """A training render: the whole batch's, or under ``group`` this rank's
    share of a ray-sharded step's (one rank of one: the whole batch).

    The training ray budget (renderer.py:65-94): a coarse occupancy test
    over the uniform grid picks the candidate rays first, the render runs
    at the budget's width, and the outputs scatter back dense; overflow
    rays drop from the batch like misses.  Every rank holds the whole
    batch and computes the whole batch's occupancy and slots; it renders
    slots ``rank, rank + world, ...`` (the budget's live slots are a
    prefix, so each rank gets an equal share of them), or without the
    budget rays ``rank, rank + world, ...``.  The sampler's draws
    (:func:`model.sampler.training_draws`) are made at the whole width and
    sliced alike, so every ray gets the draws it gets unsharded.  The
    budgets inside the body (probe, point and pair) act at the rank's
    width: the result is the unsharded one whenever no rank overflows one
    (ROADMAP Queue 3).

    Outputs are dense ``[R, ...]``: the rays the other ranks render keep
    the defaults of rays that missed, which every masked term ignores.
    Under ``group`` ``ray_own`` ``[R]`` bool marks the rays whose
    plain-mean terms (rgb, mask) this rank counts: those it renders, and
    of the rays nobody renders, every ``world``-th from ``rank``;
    ``ray_rows`` ``[R / world]`` the rows this rank rendered, -1 for a
    spare slot.  ``ray_budget_overflow`` is the whole batch's, the same on
    every rank; ``probe_budget_overflow`` the rank's own."""
    n_rays = ray_dirs.shape[0]
    dev = ray_dirs.device
    world, rank = (1, 0) if group is None else (group.world, group.rank)
    budget = ray_budget(n_rays, cfg)
    if budget is not None:
        ray_occ = coarse_ray_occupancy(cam_loc, ray_dirs, scene,
                                       cfg.ray_sampler)
        slot, ok, overflowed = field.compact_pair_slots(ray_occ, budget)
    else:
        slot = torch.arange(n_rays, device=dev)
        ok = torch.ones(n_rays, dtype=torch.bool, device=dev)
        overflowed = torch.zeros((), dtype=torch.bool, device=dev)
    width = slot.shape[0]
    draws = training_draws(cfg.ray_sampler, width, iters, dev, generator,
                           cfg.entangled, draws)
    pad = (-width) % world
    if pad:
        # spare slots: the last ray again, not live
        slot = torch.cat([slot, slot.new_full((pad,), n_rays - 1)])
        ok = torch.cat([ok, ok.new_zeros(pad)])
        draws = {k: torch.cat([v, v.new_zeros((pad,) + v.shape[1:])])
                 if k in RAY_DRAWS else v for k, v in draws.items()}
    body = dict(cfg=cfg, train=True, iters=iters)
    if budget is None and world == 1:
        # every ray, in order: nothing to pick or scatter back
        out = _render_body(params["frozen"], params["train"], scene,
                           cam_loc, ray_dirs, depth_scale, draws=draws,
                           **body)
        out["ray_budget_overflow"] = overflowed
        return out
    mine = (slice(None) if world == 1   # a view: no gather on one rank
            else torch.arange(rank, width + pad, world, device=dev))
    slot_r, ok_r = slot[mine], ok[mine]
    out = _render_body(params["frozen"], params["train"], scene,
                       cam_loc[slot_r], ray_dirs[slot_r], depth_scale[slot_r],
                       draws={k: v[mine] if k in RAY_DRAWS else v
                              for k, v in draws.items()},
                       ray_ok=ok_r if budget is not None or pad else None,
                       **body)
    probe_ovf = out.pop("probe_budget_overflow")
    dense = _scatter_rays_back(out, slot_r, ok_r, n_rays, cfg.ray_sampler.far)
    dense["probe_budget_overflow"] = probe_ovf
    dense["ray_budget_overflow"] = overflowed
    if group is not None:

        def marked(slots, live):
            buf = torch.zeros(n_rays + 1, dtype=torch.bool, device=dev)
            return buf.index_put_((torch.where(live, slots, n_rays),),
                                  live)[:n_rays]

        nobody = ~marked(slot, ok)
        turn = torch.arange(n_rays, device=dev) % world == rank
        dense["ray_own"] = marked(slot_r, ok_r) | (nobody & turn)
        dense["ray_rows"] = torch.where(ok_r, slot_r, -1)
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
                               fused_agg=cfg.fused_agg, live=live)

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
    if cfg.entangled:
        # the legacy model samples uniformly only (reference
        # pointneus.py:73-75)
        z_all = uniform_z_vals(n_rays, scfg.near, scfg.far, scfg.n_samples,
                               train, cam_loc.device,
                               u=draws["u_z"] if train else None)
        probe_overflow = torch.zeros((), dtype=torch.bool,
                                     device=cam_loc.device)
    else:
        z_all, probe_overflow = _sample_z(prior, tp, scene, cam_loc,
                                          ray_dirs, cfg, train, iters,
                                          beta0, draws, ray_ok)
    z_all = z_all.detach()
    # at most max_shading_pts of a ray's samples are shaded; the entangled
    # model's uniform grid has fewer than that at the default config (64 <
    # 80), where the JAX package's compaction keeps 64 columns and its
    # shading fails on the mismatch (tests/test_torch_entangled.py)
    S = min(S, z_all.shape[1])
    points = cam_loc[:, None, :] + z_all[..., None] * ray_dirs[:, None, :]
    flat_pts = points.reshape(-1, 3)

    if cfg.occ_compact and train and not 0 < cfg.ray_budget_frac < 1:
        # the training occ_compact (renderer.py:231-267): fine occupancy
        # picks the S columns first and only those run the kNN query.
        # Occupancy over-selects; a column with no neighbour renders as
        # empty space (its -1 ids reach the kernels as dump pairs), and
        # each valid column's delta spans to the next VALID column's z (a
        # reverse cummin), as the reference's compacted deltas do
        occ = fine_occupancy(flat_pts, scene.occ_fine, scene.spec)
        sel, sel_col = compact_rays(occ.reshape(n_rays, -1), S)
        z_sel = torch.where(sel_col, _take(z_all, sel), 0.0)
        q_pts = cam_loc[:, None, :] + z_sel[..., None] * ray_dirs[:, None, :]
        nbr_idx, _ = query_grid(q_pts.reshape(-1, 3), scene.table,
                                scene.spec, k=K)
        nbr_idx = torch.where(sel_col[..., None],
                              nbr_idx.reshape(n_rays, S, K), -1)
        nbr_valid = nbr_idx >= 0
        sel_valid = torch.any(nbr_valid, dim=-1)            # [R, S]
        z_v = torch.where(sel_valid, z_sel, torch.inf)
        nxt = torch.flip(torch.cummin(torch.flip(z_v, (-1,)), -1).values,
                         (-1,))
        nxt = torch.cat([nxt[..., 1:], torch.full_like(nxt[..., :1],
                                                       torch.inf)], -1)
        deltas = torch.where(sel_valid & torch.isfinite(nxt), nxt - z_sel,
                             0.0)
        deltas = torch.clamp(deltas, min=0.0)
    else:
        # query all samples, then first-S compaction by has-neighbour
        idx_all, _ = query_grid(flat_pts, scene.table, scene.spec, k=K)
        idx_all = idx_all.reshape(n_rays, -1, K)
        has_any = torch.any(idx_all >= 0, dim=-1)           # [R, Z]
        sel, sel_valid = compact_rays(has_any, S)           # [R, S]
        z_sel = torch.where(sel_valid, _take(z_all, sel), 0.0)
        nbr_idx = _take(idx_all, sel)                       # [R, S, K]
        nbr_valid = (nbr_idx >= 0) & sel_valid[..., None]

        # deltas over the compacted grid (reference filter_points :226-232)
        z_pad = torch.cat([z_sel, torch.zeros_like(z_sel[..., :1])], -1)
        deltas = z_pad[..., 1:] - z_pad[..., :-1]
        deltas = torch.clamp(torch.where(sel_valid, deltas, 0.0), min=0.0)

    shading_pts = cam_loc[:, None, :] + z_sel[..., None] * ray_dirs[:, None, :]
    flat_x = shading_pts.reshape(-1, 3)
    flat_idx = nbr_idx.reshape(-1, K)
    flat_valid = nbr_valid.reshape(-1, K)

    colors = None
    if cfg.entangled:
        flat_dirs = ray_dirs[:, None, :].expand(n_rays, S, 3).reshape(-1, 3)
        sdf_flat, grad_flat, colors_flat = field.entangled_sdf_grad_color(
            tp, tp["feats"], scene.points, flat_idx, flat_valid, flat_x,
            flat_dirs)
        colors = colors_flat.reshape(n_rays, S, 3)
    elif cfg.render_budget_frac > 0:
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
            prior, tp["feats_geometry"], scene.points, flat_idx[bsel],
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
            prior, tp["feats_geometry"], scene.points, flat_idx, flat_valid,
            flat_x, cfg.rbf, budget)
    else:
        sdf_flat, grad_flat = field.sdf_and_grad(
            prior, tp["feats_geometry"], scene.points, flat_idx, flat_valid,
            flat_x, cfg.rbf, fused_agg=cfg.fused_agg)
    sdf = sdf_flat.reshape(n_rays, S)
    gradients = grad_flat.reshape(n_rays, S, 3)

    valid_pt = sel_valid
    beta = get_beta(tp["beta"], cfg.density.beta_min)
    density = torch.where(valid_pt, laplace_density(sdf, beta), 0.0)
    weights = render_weights(deltas, density)               # [R, S]
    acc = torch.sum(weights, -1, keepdim=True)

    W = cfg.color_top_samples
    if colors is not None:
        colors = torch.where(valid_pt[..., None], colors, 0.0)
        rgb = torch.sum(weights[..., None] * colors, dim=1)
    elif 0 < W < S:
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


def pseudo_sdf_loss(params, scene, out, cfg: ModelConfig, count_fn=None):
    """L1-to-zero of the SDF at the rendered depth points (reference
    :765-780), a masked mean over the rays whose point has neighbours.
    Dense probe (budget None): the points sit on the surface, mostly
    occupied.  Differentiable in the latents (K4) and in the points.
    A rank of a ray-sharded step probes only the rays it rendered
    (``out["ray_rows"]``), and ``count_fn`` (as in
    :func:`model.losses.valid_count`) sums the count over the ranks."""
    pts, mask = out["pts_rendered"], out["ray_mask"]
    rows = out.get("ray_rows")
    if rows is not None:
        live = rows >= 0
        rows = torch.clamp(rows, min=0)
        pts, mask = pts[rows], mask[rows] & live
    sdf = field.sdf_probe(params["frozen"], params["train"]["feats_geometry"],
                          scene, pts, cfg.k, cfg.r, cfg.rbf,
                          budget_frac=None, fused_agg=cfg.fused_agg)
    valid = (sdf < field.SDF_FILLER / 2) & mask
    abs_sdf = torch.where(valid, torch.abs(sdf), 0.0)
    return torch.sum(abs_sdf) / torch.clamp(valid_count(valid, count_fn),
                                            min=1)


FD_EIKONAL_EPS = 5e-3


def fd_eikonal_loss(params, scene, out, cfg: ModelConfig, n_sub: int = 0,
                    generator=None, sel=None, u=None, count_fn=None):
    """Finite-difference eikonal at the shading points (beyond the
    reference; ``renderer.py:460-505``): ``((s(x + eps u) - s(x - eps u)) /
    (2 eps)| - 1)^2`` (eps ``FD_EIKONAL_EPS``) with a random unit direction
    u, neighbours reused from the centre.  Draws, each optional: ``sel
    [n_sub]`` the subset of shading points (when ``0 < n_sub < M``), ``u
    [M', 3]`` the normal draw before normalisation; absent ones come from
    ``generator``.  Under ray sharding (``count_fn``, see
    :func:`pseudo_sdf_loss`) the outputs are the whole batch's dense
    layout, so every rank draws the same selection over the whole batch's
    points; the points other ranks rendered are invalid here and count
    there."""
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
    return torch.sum(pen) / torch.clamp(valid_count(ok, count_fn), min=1)


def cloud_anchor_loss(params, scene, cfg: ModelConfig, n_points: int = 2048,
                      generator=None, sel=None):
    """L1 of the SDF at sampled input-cloud points (beyond the reference;
    ``renderer.py:508-526``).  ``sel [n_points]``: the sampled point ids,
    drawn from ``generator`` when not given."""
    if sel is None:
        sel = cloud_anchor_sel(scene, n_points, generator)
    sdf = field.sdf_probe(params["frozen"], params["train"]["feats_geometry"],
                          scene, scene.points[sel], cfg.k, cfg.r, cfg.rbf,
                          budget_frac=None, fused_agg=cfg.fused_agg)
    valid = sdf < field.SDF_FILLER / 2
    return torch.sum(torch.where(valid, torch.abs(sdf), 0.0)) / torch.clamp(
        torch.sum(valid), min=1)


def cloud_anchor_sel(scene, n_points: int = 2048, generator=None):
    """The cloud anchor's draw: ``n_points`` point ids."""
    return torch.randint(0, scene.points.shape[0], (n_points,),
                         generator=generator, device=scene.points.device)


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
