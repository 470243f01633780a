"""Neural-point SDF/color field: RBF interpolation over kNN latents (port of
``spurfies_tpu/model/field.py`` at the default model options).

Reference ``spurfies/model/pointneus_disent.py``:
  * RBF weights ``exp(-(45 d)^2)`` with detached distances, normalized per
    shading point (:241-247).
  * SDF: frozen F_geometry([geo_latent, x-p]) -> T per pair, weighted
    average over the k neighbours (:300-313); its spatial gradient by
    double backprop (:315-323) -- here the K3 kernel's down sweep, and the
    latent gradient of the SDF the K4 kernel.
  * color: F_color([posenc(x-p), color_latent]) aggregated, then
    R([viewenc(dir), agg_feat]) -> sigmoid (:325-346).
  * empty-space filler SDF = 1000 (:271).

The frozen prior arrives prepared once (``ops.pair_mlp._prep_layers``:
cast + exact linear-tail fusion); its compute dtype is the prepared
layers' dtype.  ``model.fused_agg`` reaches the SDF functions as their
``fused_agg`` argument, as ``set_fused_agg`` sets it in the JAX package:
True runs K2/K3/K4 (gather, prior, weights and per-point sums in one
kernel); False the per-pair K6b/K6a on gathered rows, with the weights and
sums in PyTorch and the latent gradient scattered by K5.  The
pair-compacted SDF (``sdf_and_grad_pairs``, ``model.pair_budget_frac``)
runs K7a.  Every latent gradient scatter is K5, for both values of
``model.scatter_mode`` (the JAX package's two modes are the same math in
another order).  The fused-MLP switch has no counterpart: the pair MLP is
always a kernel (the kernel for a CUDA tensor, the plain version for a CPU
tensor).  The fused-colour switch is the module flag :data:`FUSED_COLOR`
(off, as in the JAX package): on, :func:`aggregate_color` runs K8a/K8b
(``ops.fused_color``) in the prior's compute dtype; off, the colour MLPs
are PyTorch products.

The legacy entangled model (``model.entangled``; reference
``pointneus.py``) has no frozen prior and no kernel of its own: one
trainable trunk F([posenc4(x - p), latent64]) feeds T (the SDF) and the R
colour head, its neighbours 1/d-weighted (:func:`entangled_sdf_feat`).
Its products are f32 ``torch.matmul`` (TF32 off, PyTorch's default), as
the JAX package leaves them to XLA in f32.
"""

import torch

from spurfies_tpu_torch.core.embedder import positional_encoding
from spurfies_tpu_torch.model.networks import matmul_in, mlp_apply
from spurfies_tpu_torch.ops.fused_color import fused_color
from spurfies_tpu_torch.ops.pair_mlp import (
    PairSdfAggregate,
    PairSdfRowsGrad,
    PairSdfValueAndInputGrad,
    PriorLayers,
    pair_sdf_rows_value,
    pair_sdf_value_agg,
    pair_table,
)
from spurfies_tpu_torch.ops.scatter_rows import scatter_add_rows
from spurfies_tpu_torch.ops.voxel_grid import fine_occupancy, query_grid
from spurfies_tpu_torch.utils import profiling

SDF_FILLER = 1000.0
FUSED_COLOR = False     # K8a/K8b in aggregate_color (field.py:163)


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


def _aggregate_sdf_value_agg(prior: PriorLayers, geo_latents, points,
                             idx_ext, x, rbf):
    """No-grad value + aggregation (K2): (sdf, has)."""
    pt = pair_sdf_value_agg(pair_table(geo_latents, points), idx_ext,
                            x.contiguous(), prior, rbf)
    num, den = pt[:, 0], pt[:, 1]
    has = den > 0
    sdf = torch.where(has, num / torch.where(has, den, 1.0), SDF_FILLER)
    return sdf, has


def pair_rows(latents, points, idx, x):
    """The per-pair inputs of K6: rows ``g [M*K, D+3] = [latent |
    position]`` (``gather_pair_rows``; invalid slots read row 0 and are
    masked by the caller) and the query of each row ``[M*K, 3]``
    (``field.py:225-227``)."""
    m, k = idx.shape
    g = gather_pair_rows(latents, points, torch.clamp(idx, min=0).to(
        torch.int32)).reshape(m * k, -1)
    return g, x[:, None, :].expand(m, k, 3).reshape(-1, 3)


def _aggregate_rows(s, xpi, valid, rbf):
    """Per-pair values ``s`` and offsets ``xpi`` (``[M*K]``, ``[M*K, 3]``)
    to (masked s ``[M, K]``, w ``[M, K]``, has ``[M]``, den ``[M]``, 1
    where has is False)."""
    m, k = valid.shape
    w, norm = rbf_weights(xpi.reshape(m, k, 3), valid, rbf)
    has = norm[..., 0] > 0
    return (torch.where(valid, s.reshape(m, k), 0.0), w, has,
            torch.where(has, norm[..., 0], 1.0))


def aggregate_sdf(prior: PriorLayers, geo_latents, points, idx, valid, x,
                  rbf, need_grad: bool = True, fused_agg: bool = True):
    """RBF-weighted SDF at positions ``x`` ``[M, 3]`` from neighbours
    ``idx``/``valid`` ``[M, K]``.

    Returns (sdf ``[M]`` -- SDF_FILLER where no valid neighbour, has
    ``[M]`` bool).  With ``fused_agg`` (``model.fused_agg``),
    need_grad=False runs the value-only K2 (no gradient: the sampler's
    probe) and need_grad=True runs K3 through :class:`PairSdfAggregate`,
    differentiable in the latents (K4) and x.  Without it
    (``field.py:223-246``), the gathered rows go through K6b, or K6a
    through :class:`PairSdfRowsGrad`, and the weighted mean is PyTorch's;
    the latent gradient is scattered by K5.
    """
    if not fused_agg:
        g, x_rows = pair_rows(geo_latents, points, idx, x)
        if need_grad:
            s, _, xpi = PairSdfRowsGrad.apply(g, x_rows, prior)
        else:
            s, xpi = pair_sdf_rows_value(g, x_rows, prior)
        s, w, has, den = _aggregate_rows(s, xpi, valid, rbf)
        return torch.where(has, torch.sum(w * s, -1) / den, SDF_FILLER), has
    idx_ext = _idx_ext(idx, valid, geo_latents.shape[0])
    if not need_grad:
        return _aggregate_sdf_value_agg(prior, geo_latents, points, idx_ext,
                                        x, rbf)
    num, den, _ = PairSdfAggregate.apply(geo_latents, points, idx_ext, x,
                                         prior, rbf)
    has = den > 0
    sdf = torch.where(has, num / torch.where(has, den, 1.0), SDF_FILLER)
    return sdf, has


def compact_pair_slots(valid_flat: torch.Tensor, budget: int):
    """First ``budget`` True positions of ``valid_flat`` (fixed shape).

    Returns (slot ``[budget]`` int64 positions, clipped where unused;
    ok ``[budget]`` bool; overflowed ``[]`` bool -- True when valid
    positions were dropped).  ``torch.cumsum`` gives the ranks; the JAX
    package's blocked ``cumsum_1d`` works around a slow TPU scan and gives
    the same ranks.
    """
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
              return_overflow: bool = False, fused_agg: bool = True,
              live: torch.Tensor | None = None):
    """SDF at arbitrary world points (filler 1000 in empty space).

    budget_frac: a fine-occupancy lookup prunes empty-space probe points
    BEFORE the kNN query, and only the first ``budget_frac * M`` occupied
    points (fixed shape) run query + pair MLP.  None disables it (all M
    run, masked).  ``r`` must match the radius of the scene's table.
    return_overflow: also return a ``[]`` bool -- occupied probe points
    were dropped by the budget.  fused_agg: as :func:`aggregate_sdf`.
    live: ``[M]`` bool or None -- under a budget, only these points may take
    a slot; the others read as empty space and never raise the flag (the
    ray budget's spare slots, whose outputs are cut away).
    """
    with profiling.span("field.probe"):
        m = x.shape[0]
        budget = (max(int(m * budget_frac) // 128 * 128, 128)
                  if budget_frac is not None else m)
        if budget_frac is None or m < 1024 or budget >= m:
            idx, _ = query_grid(x, scene.table, scene.spec, k=k)
            sdf, _ = aggregate_sdf(prior, geo_latents, scene.points, idx,
                                   idx >= 0, x, rbf, need_grad=need_grad,
                                   fused_agg=fused_agg)
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
                                 valid_c, x_c, rbf, need_grad=need_grad,
                                 fused_agg=fused_agg)
        # unused budget slots scatter into a spare last element (a masked
        # index would cost a device sync)
        out = torch.full((m + 1,), SDF_FILLER, dtype=x.dtype, device=x.device)
        out[torch.where(sel_ok, sel, m)] = torch.where(sel_ok, sdf_c,
                                                       SDF_FILLER)
        out = out[:m]
        if return_overflow:
            return out, overflowed
        return out


def select_rows(table, idx):
    """``table[idx]`` by ``index_select``, whose backward is an
    ``index_add_``: indexing's would be a sorted ``index_put_``, which took
    85 % of an entangled training step on an H100 (PERF.md)."""
    return torch.index_select(table, 0, idx.reshape(-1)).view(
        *idx.shape, table.shape[1])


def inverse_distance_weights(x_pi: torch.Tensor, valid: torch.Tensor):
    """The legacy model's 1/d weights (reference pointneus.py:184-190):
    (w ``[M, K]``, invalid -> 0; norm ``[M, 1]``).  NOT detached, unlike
    the RBF weights."""
    dist = torch.clamp(torch.linalg.norm(x_pi, dim=-1), min=1e-12)
    w = (1.0 / dist) * valid.to(x_pi.dtype)
    return w, torch.sum(w, dim=-1, keepdim=True)


def entangled_sdf_feat(train_params, feats, points, idx, valid, x,
                       pos_multires: int = 4):
    """The legacy entangled field (``field.py:319-345``; reference
    pointneus.py:260-310): per pair the trunk F([posenc(x - p), latent]),
    T on it for the SDF; both 1/d-weighted over the neighbours.

    Returns (sdf ``[M]``, filler 1000 where no neighbour; the aggregated
    trunk features ``[M, 256]``; has ``[M]`` bool).
    """
    safe_idx = torch.clamp(idx, min=0).long()
    x_pi = x[:, None, :] - points[safe_idx]
    lat = select_rows(feats, safe_idx)                      # [M, K, 64]
    w, norm = inverse_distance_weights(x_pi, valid)
    pos_enc = positional_encoding(x_pi, pos_multires)
    h = mlp_apply(train_params["F"], torch.cat([pos_enc, lat], -1))
    sdf_k = torch.where(valid, mlp_apply(train_params["T"], h)[..., 0], 0.0)
    h = torch.where(valid[..., None], h, 0.0)
    has = norm[..., 0] > 0
    denom = torch.where(has, norm[..., 0], 1.0)
    sdf = torch.where(has, torch.sum(w * sdf_k, -1) / denom, SDF_FILLER)
    feat = torch.sum(w[..., None] * h, -2) / denom[..., None]
    return sdf, feat, has


def entangled_sdf_grad_color(train_params, feats, points, idx, valid, x,
                             ray_dirs, view_multires: int = 6):
    """SDF, its spatial gradient and the colour of the legacy model
    (``field.py:348-362``).

    JAX takes the gradient per point (``vmap(value_and_grad)``); each
    point's SDF depends on its own x only, so the gradient of the sum in
    x is the same.  With autograd on, the gradient stays differentiable
    in the parameters (double backward, for the eikonal term); without it
    (an eval render) only the gradient's value is taken.
    """
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        sdf, feat, _ = entangled_sdf_feat(train_params, feats, points, idx,
                                          valid, xg)
        grad, = torch.autograd.grad(sdf.sum(), xg, create_graph=create)
    if not create:
        sdf, feat = sdf.detach(), feat.detach()
    dir_enc = positional_encoding(ray_dirs, view_multires)
    rgb = mlp_apply(train_params["R"], torch.cat([dir_enc, feat], -1),
                    final_act="sigmoid")
    return sdf, grad, rgb


def sdf_and_grad(prior: PriorLayers, geo_latents, points, idx, valid, x,
                 rbf, fused_agg: bool = True):
    """Aggregated SDF and its spatial gradient d(sdf)/dx.

    The RBF weights are constant in x (detached distances, reference
    :242), so d(agg)/dx is the weighted sum of the per-pair input
    gradients, which the kernels compute in their down sweep: K3 with
    ``fused_agg`` (differentiable through :class:`PairSdfAggregate`: the
    SDF in the latents (K4) and x), else K6a on gathered rows
    (``field.py:406-422``: the SDF differentiable through
    :class:`PairSdfRowsGrad` and K5).  The gradient's latent derivative is
    zero almost everywhere and is dropped, as in the JAX package.
    """
    if not fused_agg:
        g, x_rows = pair_rows(geo_latents, points, idx, x)
        s, r, xpi = PairSdfRowsGrad.apply(g, x_rows, prior)
        s, w, has, den = _aggregate_rows(s, xpi, valid, rbf)
        m, k = valid.shape
        gr = torch.where(valid[..., None],
                         r[:, geo_latents.shape[1]:].reshape(m, k, 3), 0.0)
        sdf = torch.where(has, torch.sum(w * s, -1) / den, SDF_FILLER)
        return sdf, torch.sum(w[..., None] * gr, -2) / den[..., None]
    idx_ext = _idx_ext(idx, valid, geo_latents.shape[0])
    num, den, gagg = PairSdfAggregate.apply(geo_latents, points, idx_ext, x,
                                            prior, rbf)
    has = den > 0
    den_s = torch.where(has, den, 1.0)
    sdf = torch.where(has, num / den_s, SDF_FILLER)
    return sdf, gagg / den_s[:, None]


class _GatherLatents(torch.autograd.Function):
    """``table[idx]`` whose backward scatters the cotangent with K5
    (``field.py:75-104`` of the JAX package)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, ct):
        idx, = ctx.saved_tensors
        return scatter_add_rows(ct.reshape(-1, ct.shape[-1]), idx.reshape(-1),
                                ctx.n), None


def gather_latents(table, idx):
    """``table[idx]`` (idx int32 ``[B]``, clipped into ``[0, N)``),
    differentiable in ``table`` through K5.  The cotangent of a column
    slice of a wider array (``torch.cat``'s backward) is read in place
    through its row stride."""
    return _GatherLatents.apply(table, idx.contiguous())


class _GatherRows(torch.autograd.Function):
    """``[latent | position][idx]`` whose backward scatters only the latent
    columns of the cotangent, with K5 (``field.py:107-133`` of the JAX
    package)."""

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
    """Per-pair rows ``g [M, K, D+3] = [latent | position]`` from one
    combined-row gather (``spurfies_tpu/model/field.py:136-159``).

    idx ``[M, K]`` int32, clipped into ``[0, N)``.  Positions are static
    scene geometry, so the backward scatters only the latent columns: K5
    reads them from the ``[M*K, D+3]`` cotangent through its row stride.
    """
    return _GatherRows.apply(latents, points.detach(), idx.contiguous())


def _compact_pairs(idx, valid, points, x, rbf, budget: int):
    """The ``[M, K]`` pair grid compacted column-major (nearest neighbours
    first) to its first ``budget`` valid pairs (``field.py:609-624``):
    (pt ``[B]`` owning point, pidx ``[B]`` int32 neighbour id, x_pi
    ``[B, 3]``, w ``[B]`` the RBF weight of the detached distance, 0 for an
    unused slot, seg ``[B]`` pt, or M for an unused slot)."""
    m, k = idx.shape
    slot, ok, _ = compact_pair_slots(valid.t().reshape(-1), budget)
    pt = slot % m
    pidx = torch.clamp(idx.reshape(-1)[pt * k + slot // m], min=0)
    x_pi = x[pt] - points[pidx]
    dist = torch.clamp(_norm3(x_pi.detach()), min=1e-12)
    w = torch.exp(-((dist * rbf) ** 2)) * ok.to(x.dtype)
    return pt, pidx.to(torch.int32), x_pi, w, torch.where(ok, pt, m)


def _seg_sum(v, seg, m: int):
    """Per-point sums of the pair values ``v`` (``[B]`` or ``[B, c]``):
    ``index_add`` into ``m + 1`` rows, the unused slots (seg == m) into the
    spare last one."""
    out = v.new_zeros((m + 1,) + tuple(v.shape[1:]))
    return out.index_add(0, seg, v)[:m]


def sdf_and_grad_pairs(prior: PriorLayers, geo_latents, points, idx, valid,
                       x, rbf, pair_budget: int):
    """Pair-compacted :func:`sdf_and_grad` (``field.py:584-646``).

    The ``[M, K]`` pair grid is compacted column-major (nearest neighbours
    first) to its first ``pair_budget`` valid pairs; K7a runs on each kept
    pair's ``u = [latent | x_pi]`` (through :class:`PairSdfValueAndInputGrad`,
    the latents gathered by :func:`gather_latents`, whose backward is K5),
    and the weighted sums go back per point with ``index_add`` into a spare
    row M (no boolean indexing, no host sync).  Overflow sheds the
    farthest neighbours of the tail points; the weights renormalize.
    Equal to :func:`sdf_and_grad` when nothing overflows.
    """
    m = idx.shape[0]
    d = geo_latents.shape[1]
    _, pidx, x_pi, w, seg = _compact_pairs(idx, valid, points, x, rbf,
                                           pair_budget)
    u = torch.cat([gather_latents(geo_latents, pidx), x_pi], -1)
    s, r = PairSdfValueAndInputGrad.apply(u, prior)
    num = _seg_sum(w * s, seg, m)
    den = _seg_sum(w, seg, m)
    gnum = _seg_sum(w[:, None] * r[:, d:], seg, m)
    has = den > 0
    safe_den = torch.where(has, den, 1.0)
    return (torch.where(has, num / safe_den, SDF_FILLER),
            gnum / safe_den[:, None])


def aggregate_color_pairs(train_params, color_latents, points, idx, valid,
                          x, ray_dirs, rbf, pair_budget: int, pos_multires=6,
                          view_multires=3, compute_dtype=torch.bfloat16):
    """Pair-compacted colour (``field.py:649-694``): the same column-major
    compaction as :func:`sdf_and_grad_pairs`; F_color (all four layers) runs
    on the kept pairs only, the normalized-weight aggregate goes back per
    point with ``index_add``, then the per-point R head.  The colour
    latents' gradient is K5 (:func:`gather_latents`).  Equal to
    :func:`aggregate_color` (up to rounding) when nothing overflows."""
    m = idx.shape[0]
    pt, pidx, x_pi, w, seg = _compact_pairs(idx, valid, points, x, rbf,
                                            pair_budget)
    cfeat = gather_latents(color_latents, pidx)
    den = _seg_sum(w, seg, m)
    wn = w / torch.where(den > 0, den, 1.0)[pt]
    pos_enc = positional_encoding(x_pi, pos_multires)        # [B, 39]
    feat = mlp_apply(train_params["F_color"], torch.cat([pos_enc, cfeat], -1),
                     compute_dtype=compute_dtype)            # [B, 256]
    agg = _seg_sum(wn[:, None] * feat.to(x.dtype), seg, m)
    dir_enc = positional_encoding(ray_dirs, view_multires)   # [M, 21]
    return mlp_apply(train_params["R"], torch.cat([dir_enc, agg], -1),
                     final_act="sigmoid", compute_dtype=compute_dtype)


def aggregate_color(train_params, color_latents, points, idx, valid, x,
                    ray_dirs, rbf, pos_multires=6, view_multires=3,
                    compute_dtype=torch.bfloat16, fused_dtype=torch.bfloat16):
    """View-dependent color ``[M, 3]`` in [0, 1] at shading points ``x``.

    The color MLPs run in ``compute_dtype`` (bf16 by default, as in the JAX
    package); aggregation stays f32.  F_color's last layer has no
    activation, so it commutes with the weighted aggregation and runs once
    per point on the aggregate (the exact linear-tail fold of
    ``spurfies_tpu/model/field.py:745-773``).

    With :data:`FUSED_COLOR`, k == 8 and ``pos_multires == 6``
    (``field.py:725-743``), the stack runs instead through
    :func:`ops.fused_color.fused_color` (K8a, backward K8b) in
    ``fused_dtype``, the JAX package's ``FUSED_MLP_DTYPE``: the renderer
    passes the prior's compute dtype.  It has no linear-tail fold and its
    own rounding points.  The kernel masks its ragged last block, so no
    point is padded.
    """
    safe_idx = torch.clamp(idx, min=0).to(torch.int32)
    d = color_latents.shape[1]
    g3 = gather_pair_rows(color_latents, points, safe_idx)  # [M, K, D+3]
    cfeat = g3[..., :d]
    x_pi = x[:, None, :] - g3[..., d:]
    w, norm = rbf_weights(x_pi, valid, rbf)

    if FUSED_COLOR and idx.shape[1] == 8 and pos_multires == 6:
        wn = w / torch.where(norm > 0, norm, 1.0)            # 0 where empty
        return fused_color(train_params["F_color"], train_params["R"],
                           x_pi.reshape(-1, 3),
                           cfeat.reshape(-1, d).contiguous(), wn.reshape(-1),
                           positional_encoding(ray_dirs, view_multires)
                           .contiguous(), fused_dtype)

    pos_enc = positional_encoding(x_pi, pos_multires)        # [M, K, 39]
    field_in = torch.cat([pos_enc, cfeat], dim=-1)           # [M, K, 103]
    f_color = train_params["F_color"]
    h = mlp_apply(f_color[:-1], field_in, final_act="leaky_relu",
                  compute_dtype=compute_dtype)               # [M, K, 256]
    h = torch.where(valid[..., None], h, 0.0)
    has = norm > 0
    den = torch.where(has, norm, 1.0)
    hbar = torch.sum(w[..., None] * h, dim=-2) / den         # [M, 256]
    swn = torch.sum(w, dim=-1, keepdim=True) / den           # 1 valid, 0 not
    w4, b4 = f_color[-1]["w"], f_color[-1]["b"]
    if compute_dtype is not None and compute_dtype != torch.float32:
        agg = matmul_in(hbar, w4, compute_dtype).to(compute_dtype).to(
            hbar.dtype) + swn * b4
    else:
        agg = hbar @ w4 + swn * b4

    dir_enc = positional_encoding(ray_dirs, view_multires)   # [M, 21]
    return mlp_apply(train_params["R"], torch.cat([dir_enc, agg], -1),
                     final_act="sigmoid", compute_dtype=compute_dtype)
