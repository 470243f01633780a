"""Neural-point SDF/colour field: RBF interpolation over kNN latents, the
plain version of the port's ``model/field.py`` at the default model options
(reference ``spurfies/model/pointneus_disent.py``):
  * RBF weights ``exp(-(45 d)^2)`` with detached distances, normalized per
    shading point (:241-247).
  * SDF: frozen F_geometry([geo_latent, x-p]) -> T per pair, weighted
    average over the k neighbours (:300-313); its spatial gradient from
    the down sweep of ``ops.pair_mlp``.
  * colour: F_color([posenc(x-p), colour_latent]) aggregated, then
    R([viewenc(dir), agg_feat]) -> sigmoid (:325-346).
  * empty-space filler SDF = 1000 (:271).
"""

import torch

from benchmark.plain.core.embedder import positional_encoding
from benchmark.plain.model.networks import mlp_apply
from benchmark.plain.ops.pair_mlp import (
    PairSdfAggregate,
    PriorLayers,
    pair_sdf_value_agg,
    pair_table,
)
from benchmark.plain.ops.scatter_rows import scatter_add_rows
from benchmark.plain.ops.voxel_grid import fine_occupancy, query_grid
from benchmark.plain.precision import mm, q

SDF_FILLER = 1000.0


def _norm3(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])
                      + v[..., 2] * v[..., 2])


def rbf_weights(x_pi: torch.Tensor, valid: torch.Tensor, rbf: float):
    """(w ``[M, K]`` unnormalized, invalid -> 0; norm ``[M, 1]``).
    Distances are detached (reference :242)."""
    dist = torch.clamp(_norm3(x_pi.detach()), min=1e-12)
    w = torch.exp(-((dist * rbf) ** 2)) * valid.to(x_pi.dtype)
    return w, torch.sum(w, dim=-1, keepdim=True)


def _idx_ext(idx, valid, n):
    return torch.where(valid, torch.clamp(idx, min=0), n).to(torch.int32)


def aggregate_sdf(prior: PriorLayers, geo_latents, points, idx, valid, x,
                  rbf, need_grad: bool = True):
    """RBF-weighted SDF at ``x`` ``[M, 3]`` from neighbours ``idx``/``valid``
    ``[M, K]``: (sdf ``[M]``, SDF_FILLER where no valid neighbour; has
    ``[M]``).  need_grad=False is the sampler's no-grad probe."""
    idx_ext = _idx_ext(idx, valid, geo_latents.shape[0])
    if not need_grad:
        pt = pair_sdf_value_agg(pair_table(geo_latents, points), idx_ext,
                                x.contiguous(), prior, rbf)
        num, den = pt[:, 0], pt[:, 1]
    else:
        num, den, _ = PairSdfAggregate.apply(geo_latents, points, idx_ext,
                                             x, prior, rbf)
    has = den > 0
    sdf = torch.where(has, num / torch.where(has, den, 1.0), SDF_FILLER)
    return sdf, has


def compact_pair_slots(valid_flat: torch.Tensor, budget: int):
    """First ``budget`` True positions of ``valid_flat``: (slot ``[budget]``
    positions, clipped where unused; ok ``[budget]``; overflowed ``[]``)."""
    p = valid_flat.shape[0]
    dev = valid_flat.device
    ranks = torch.cumsum(valid_flat.to(torch.int64), 0) - 1
    n_valid = ranks[-1] + 1
    dest = torch.where(valid_flat & (ranks < budget), ranks, budget)
    slot = torch.full((budget + 1,), p, dtype=torch.int64, device=dev)
    slot[dest] = torch.arange(p, device=dev)
    slot = slot[:budget]
    ok = slot < p
    return torch.clamp(slot, max=p - 1), ok, n_valid > budget


def sdf_probe(prior: PriorLayers, geo_latents, scene, x, k, r, rbf,
              budget_frac: float | None = 0.25, need_grad: bool = True,
              return_overflow: bool = False,
              live: torch.Tensor | None = None):
    """SDF at arbitrary world points (filler 1000 in empty space).

    budget_frac: only the first ``budget_frac * M`` points in occupied fine
    cells run the query and the prior (None: all M).  return_overflow: also
    return a ``[]`` bool, True when occupied points were dropped.  live:
    ``[M]`` bool or None; under a budget only these points may take a slot.
    """
    m = x.shape[0]
    budget = (max(int(m * budget_frac) // 128 * 128, 128)
              if budget_frac is not None else m)
    if budget_frac is None or m < 1024 or budget >= m:
        idx, _ = query_grid(x, scene.table, scene.spec, k=k)
        sdf, _ = aggregate_sdf(prior, geo_latents, scene.points, idx,
                               idx >= 0, x, rbf, need_grad=need_grad)
        if return_overflow:
            return sdf, torch.zeros((), dtype=torch.bool, device=x.device)
        return sdf

    occ = fine_occupancy(x, scene.occ_fine, scene.spec)
    if live is not None:
        occ = occ & live
    sel, sel_ok, overflowed = compact_pair_slots(occ, budget)
    x_c = x[sel]
    idx_c, _ = query_grid(x_c, scene.table, scene.spec, k=k)
    valid_c = (idx_c >= 0) & sel_ok[:, None]
    sdf_c, _ = aggregate_sdf(prior, geo_latents, scene.points, idx_c,
                             valid_c, x_c, rbf, need_grad=need_grad)
    out = torch.full((m + 1,), SDF_FILLER, dtype=x.dtype, device=x.device)
    out[torch.where(sel_ok, sel, m)] = torch.where(sel_ok, sdf_c, SDF_FILLER)
    out = out[:m]
    if return_overflow:
        return out, overflowed
    return out


def sdf_and_grad(prior: PriorLayers, geo_latents, points, idx, valid, x,
                 rbf):
    """Aggregated SDF and its spatial gradient: the weights are constant in
    x (detached distances), so d(agg)/dx is the weighted sum of the pairs'
    input gradients.  The gradient's latent derivative is zero almost
    everywhere and is dropped."""
    idx_ext = _idx_ext(idx, valid, geo_latents.shape[0])
    num, den, gagg = PairSdfAggregate.apply(geo_latents, points, idx_ext, x,
                                            prior, rbf)
    has = den > 0
    den_s = torch.where(has, den, 1.0)
    sdf = torch.where(has, num / den_s, SDF_FILLER)
    return sdf, gagg / den_s[:, None]


class _GatherRows(torch.autograd.Function):
    """``[latent | position][idx]`` whose backward scatters only the latent
    columns of the cotangent."""

    @staticmethod
    def forward(ctx, latents, points, idx):
        table = torch.cat([latents, points.to(latents.dtype)], 1)
        ctx.save_for_backward(idx)
        ctx.shape = latents.shape
        return table[idx]

    @staticmethod
    def backward(ctx, ct):
        idx, = ctx.saved_tensors
        n, d = ctx.shape
        ct = ct.contiguous().reshape(-1, d + 3)
        g = scatter_add_rows(ct[:, :d], idx.reshape(-1), n)
        return g, None, None


def gather_pair_rows(latents, points, idx):
    """Per-pair rows ``g [M, K, D+3] = [latent | position]``; idx ``[M,
    K]`` int32, clipped into ``[0, N)``."""
    return _GatherRows.apply(latents, points.detach(), idx.contiguous())


def aggregate_color(train_params, color_latents, points, idx, valid, x,
                    ray_dirs, rbf, pos_multires=6, view_multires=3,
                    compute_dtype=None, fused_dtype=None):
    """View-dependent colour ``[M, 3]`` in [0, 1] at shading points ``x``.
    F_color's last layer has no activation, so it commutes with the
    weighted aggregation and runs once per point on the aggregate."""
    safe_idx = torch.clamp(idx, min=0).to(torch.int32)
    d = color_latents.shape[1]
    g3 = gather_pair_rows(color_latents, points, safe_idx)  # [M, K, D+3]
    cfeat = g3[..., :d]
    x_pi = x[:, None, :] - g3[..., d:]
    w, norm = rbf_weights(x_pi, valid, rbf)

    pos_enc = positional_encoding(x_pi, pos_multires)        # [M, K, 39]
    field_in = torch.cat([pos_enc, cfeat], dim=-1)           # [M, K, 103]
    f_color = train_params["F_color"]
    h = mlp_apply(f_color[:-1], field_in, final_act="leaky_relu")
    h = torch.where(valid[..., None], h, 0.0)
    has = norm > 0
    den = torch.where(has, norm, 1.0)
    hbar = torch.sum(w[..., None] * h, dim=-2) / den         # [M, 256]
    swn = torch.sum(w, dim=-1, keepdim=True) / den           # 1 valid, 0 not
    w4, b4 = f_color[-1]["w"], f_color[-1]["b"]
    agg = q(mm(hbar, w4) + swn * b4)

    dir_enc = positional_encoding(ray_dirs, view_multires)   # [M, 21]
    return mlp_apply(train_params["R"], torch.cat([dir_enc, agg], -1),
                     final_act="sigmoid")
