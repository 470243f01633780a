"""Ray samplers: uniform + VolSDF error-bounded upsampling (port of
``spurfies_tpu/model/sampler.py``).

Reference ``spurfies/model/ray_sampler.py``:
  * UniformSampler (:17-59): linspace near..far, stratified when training.
  * ErrorBoundSampler_pn (:337-588): VolSDF Algorithm 1 -- iterative
    error-bound-driven upsampling with per-iteration beta bisection, then a
    final weights-PDF draw, plus near/far + N_samples_extra merged columns.

As in the JAX package the loop is unrolled with per-ray convergence masks,
and the SDF evaluations go through a no-grad probe.  At eval no random
number is drawn: the first grid is not stratified, every ``sample_pdf``
round is deterministic and the extra columns are a linspace.  A training
render draws three times: the stratified jitter, the last round's
``sample_pdf`` and the extra columns, all made up front by
:func:`training_draws`.  Each draw can be given as a tensor (``draws``), so
that a test can hand both packages the same numbers; a draw that is not
given comes from the caller's ``torch.Generator``, on the render's device.
"""

import numpy as np
import torch

from benchmark.plain.config import SamplerConfig
from benchmark.plain.core.density import laplace_density
from benchmark.plain.device import constant, resolve_device


def linspace(start: float, stop: float, n: int, device) -> torch.Tensor:
    """f32 ``[n]``, each value correctly rounded from float64 (a shared
    constant: do not write to it)."""
    return constant(tuple(np.linspace(start, stop, n).astype(np.float32)
                          .tolist()), torch.float32, device)


def uniform_z_vals(n_rays: int, near: float, far: float, n: int,
                   stratified: bool, device, u=None):
    """[R, n] z values on ``device``; stratified jitter within bins when
    training, by ``u`` ``[R, n]`` in [0, 1) (:func:`training_draws`'
    ``"u_z"``)."""
    device = resolve_device(device)
    t = linspace(0.0, 1.0, n, device)
    z = near * (1.0 - t) + far * t
    z = z.expand(n_rays, n)
    if stratified:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], -1)
        lower = torch.cat([z[..., :1], mids], -1)
        z = lower + (upper - lower) * u
    return z


def sample_pdf(bins: torch.Tensor, pdf: torch.Tensor, n: int,
               deterministic: bool, u=None):
    """Inverse-CDF sampling (reference ray_sampler.py:505-529).

    bins ``[R, Z]`` non-decreasing along Z; pdf ``[R, Z-1]`` (need not be
    normalized); u ``[R, n]``: the draw when not deterministic.
    ``torch.searchsorted(cdf, u, right=True)`` brackets each u; the JAX
    package's masked max/min reduce over an ``[R, U, Z]`` mask is its TPU
    stand-in for the same bracket
    (and a ``[4096, 128, 640]`` temporary at eval shapes).  The top bracket
    is clamped to the last column as there
    (``spurfies_tpu/model/sampler.py:82-87``).
    """
    r, z = bins.shape
    pdf = pdf / torch.sum(pdf, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)   # [R, Z]
    if deterministic:
        u = linspace(0.0, 1.0, n, bins.device).expand(r, n).contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=z - 1)
    cdf_g0 = torch.gather(cdf, 1, below)
    bins_g0 = torch.gather(bins, 1, below)
    cdf_g1 = torch.gather(cdf, 1, above)
    bins_g1 = torch.gather(bins, 1, above)
    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < 1e-5, 1.0, denom)
    t = (u - cdf_g0) / denom
    return bins_g0 + t * (bins_g1 - bins_g0)


def _d_star(z_vals, sdf):
    """Theorem-1 distance bound (reference ray_sampler.py:417-432)."""
    d = sdf
    dists = z_vals[:, 1:] - z_vals[:, :-1]
    a, b, c = dists, torch.abs(d[:, :-1]), torch.abs(d[:, 1:])
    first = a ** 2 + b ** 2 <= c ** 2
    second = a ** 2 + c ** 2 <= b ** 2
    s = (a + b + c) / 2.0
    area = torch.clamp(s * (s - a) * (s - b) * (s - c), min=0.0)
    height = 2.0 * torch.sqrt(area) / torch.clamp(a, min=1e-12)
    d_star = torch.where(first, b, torch.where(
        second, c, torch.where(b + c - a > 0, height, 0.0)))
    same_sign = torch.sign(d[:, 1:]) * torch.sign(d[:, :-1]) == 1
    return torch.where(same_sign, d_star, 0.0), dists


def _error_bound(beta, sdf, z_vals, dists, d_star):
    """Max per-ray opacity error bound (reference ray_sampler.py:576-588)."""
    density = laplace_density(sdf, beta)
    shifted = torch.cat([torch.zeros_like(dists[:, :1]),
                         dists * density[:, :-1]], -1)
    integral = torch.cumsum(shifted, -1)
    err_sec = torch.exp(-d_star / beta) * (dists ** 2.0) / (4.0 * beta ** 2)
    err_int = torch.cumsum(err_sec, -1)
    bound = (torch.clamp(torch.exp(err_int), max=1.0e6) - 1.0) * torch.exp(
        -integral[:, :-1])
    return torch.amax(bound, -1)


# the ray-shaped training draws: one row per ray
RAY_DRAWS = ("u_z", "u_pdf")


def training_draws(cfg: SamplerConfig, n_rays: int, iters: int, device,
                   generator, given=None) -> dict:
    """The draws of a training render of ``n_rays`` rays, made from
    ``generator`` in this order (the keys in ``given`` are kept and not
    drawn): ``"u_z"`` the stratified jitter, ``"u_pdf"`` the last
    ``sample_pdf`` round's (when ``iters`` > 0) and ``"extra_cols"`` the
    merged extra columns."""
    draws = dict(given or {})

    def draw(key, fn):
        if key not in draws:
            draws[key] = fn()

    draw("u_z", lambda: torch.rand((n_rays, cfg.n_samples_eval),
                                   generator=generator, device=device))
    if iters > 0:
        draw("u_pdf", lambda: torch.rand((n_rays, cfg.n_samples),
                                         generator=generator, device=device))
    if cfg.n_samples_extra > 0:
        z_cols = cfg.n_samples_eval * max(iters, 1)
        draw("extra_cols", lambda: torch.randperm(
            z_cols, generator=generator,
            device=device)[:cfg.n_samples_extra])
    return draws


def error_bound_z_vals(sdf_fn, cam_loc, ray_dirs, cfg: SamplerConfig,
                       beta0, iters: int, train: bool, generator=None,
                       draws=None):
    """Full error-bounded sampling.

    Args:
      sdf_fn: ``([M, 3], first: bool) -> ([M], [] bool)`` no-grad SDF probe
        (filler 1000 in empty space) and its budget-overflow flag;
        ``first=True`` marks the initial uniform-grid probe.
      cam_loc/ray_dirs: ``[R, 3]``.
      beta0: ``[]`` current density beta (detached by the caller).
      iters: sampler iterations (eval: max_total_iters).
      generator: the source of a training render's draws that ``draws``
        does not give (:func:`training_draws`; unused at eval).
      draws: optional training draws -- ``"u_z"`` ``[R, n_samples_eval]``
        the stratified jitter, ``"u_pdf"`` ``[R, n_samples]`` the last
        round's ``sample_pdf`` and ``"extra_cols"`` ``[n_samples_extra]``
        the merged extra columns (indices into the last z grid).

    Returns:
      (z_vals ``[R, n_samples + n_samples_extra + 2]`` sorted,
       probe_overflow ``[]`` bool -- OR over every probe round).
    """
    n_rays = cam_loc.shape[0]
    dev = cam_loc.device
    if train:
        draws = training_draws(cfg, n_rays, iters, dev, generator,
                               given=draws)

    def probe(z, first=False):
        pts = cam_loc[:, None, :] + z[..., None] * ray_dirs[:, None, :]
        s, ovf = sdf_fn(pts.reshape(-1, 3), first)
        return s.reshape(z.shape).detach(), ovf

    z_vals = uniform_z_vals(n_rays, cfg.near, cfg.far, cfg.n_samples_eval,
                            train, dev, u=draws["u_z"] if train else None)
    sdf, probe_overflow = probe(z_vals, first=True)

    dists0 = z_vals[:, 1:] - z_vals[:, :-1]
    log_eps = torch.log(constant(cfg.eps + 1.0, torch.float32, dev))
    bound = (1.0 / (4.0 * log_eps)) * torch.sum(dists0 ** 2.0, -1)
    beta = torch.sqrt(bound)
    samples = z_vals

    for it in range(iters):
        d_star, dists = _d_star(z_vals, sdf)

        # beta bisection in [beta0, beta] (reference :434-445)
        err0 = _error_bound(beta0, sdf, z_vals, dists, d_star)
        beta = torch.where(err0 <= cfg.eps, beta0, beta)
        beta_lo = torch.broadcast_to(beta0, beta.shape)
        beta_hi = beta
        for _ in range(cfg.beta_iters):
            mid = 0.5 * (beta_lo + beta_hi)
            err = _error_bound(mid[:, None], sdf, z_vals, dists, d_star)
            ok = err <= cfg.eps
            beta_hi = torch.where(ok, mid, beta_hi)
            beta_lo = torch.where(ok, beta_lo, mid)
        beta = beta_hi

        # rendering weights under the current beta (reference :447-464)
        density = laplace_density(sdf, beta[:, None])
        dists_inf = torch.cat([dists, torch.full_like(dists[:, :1], 1e10)],
                              -1)
        free = dists_inf * density
        shifted = torch.cat([torch.zeros_like(free[:, :1]), free[:, :-1]],
                            -1)
        alpha = 1.0 - torch.exp(-free)
        trans = torch.exp(-torch.cumsum(shifted, -1))
        weights = alpha * trans

        converged = beta <= beta0
        w_pdf = weights[:, :-1] + 1e-5

        if it < iters - 1:
            err_sec = (torch.exp(-d_star / beta[:, None])
                       * (dists ** 2.0) / (4.0 * beta[:, None] ** 2))
            err_int = torch.cumsum(err_sec, -1)
            bound_op = (torch.clamp(torch.exp(err_int), max=1.0e6)
                        - 1.0) * trans[:, :-1]
            e_pdf = bound_op + cfg.add_tiny
            pdf = torch.where(converged[:, None], w_pdf, e_pdf)
            samples = sample_pdf(z_vals, pdf, cfg.n_samples_eval,
                                 deterministic=True)
            new_sdf, ovf_it = probe(samples)
            probe_overflow = probe_overflow | ovf_it
            z_cat = torch.cat([z_vals, samples], -1)
            s_cat = torch.cat([sdf, new_sdf], -1)
            order = torch.argsort(z_cat, dim=-1, stable=True)
            z_vals = torch.gather(z_cat, 1, order)
            sdf = torch.gather(s_cat, 1, order)
        else:
            samples = sample_pdf(z_vals, w_pdf, cfg.n_samples,
                                 deterministic=not train,
                                 u=draws["u_pdf"] if train else None)

    # near/far + extra merged columns (reference :537-559)
    near_col = torch.full((n_rays, 1), cfg.near, device=dev)
    far_col = torch.full((n_rays, 1), cfg.far, device=dev)
    z_cols = z_vals.shape[-1]
    if cfg.n_samples_extra > 0:
        if train:
            cols = draws["extra_cols"]
        else:
            cols = linspace(0, z_cols - 1, cfg.n_samples_extra,
                            dev).to(torch.int64)
        z_extra = torch.cat([near_col, far_col, z_vals[:, cols]], -1)
    else:
        z_extra = torch.cat([near_col, far_col], -1)

    z_all = torch.sort(torch.cat([samples, z_extra], -1), -1).values
    return z_all, probe_overflow
