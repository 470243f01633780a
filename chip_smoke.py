#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``spurfies_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package.  Phases, in order (any
failure exits non-zero before the last line):

  1. device: the card's name and ``nvidia-smi`` name / power limit;
  2. build: every kernel of ``spurfies_tpu_torch/csrc`` with nvcc for
     sm_90a, one process per source, all at once (seconds, registers,
     spills);
  3. scenes: the DUSt3R-like cloud of ``make_dust3r_like_scene`` (the
     JAX package's bench scene, 192x256 views; ~6k points -> the packed K1
     variant) and a dense 40k-point sphere (>2**15 points -> the exact K1
     variant), both with the repo's pretrained prior
     (``spurfies_tpu_torch/assets/local_prior.npz``) and seeded latents;
  4. render kernels: K1-K3 against their plain PyTorch versions on the
     card, in bf16, on the inputs of the first 4096-ray chunk of each
     scene's render (probe and shading shapes), with timings and bounds;
     on dust3r_like also K6b / K6a on that chunk's probe and shading pair
     rows (``model.fused_agg=false``) and K7a on its shading pairs
     compacted as ``model.pair_budget_frac=0.625`` compacts them;
  5. render path: launch counters set to 0, then ``make_render_fn`` renders
     view 0 of both scenes in full (2 x 49,152 rays, default ModelConfig,
     render_chunk=4096, 5 sampler iterations); outputs must be finite and
     every kernel's counter must have moved by the count the chunking
     implies; prints rays/s and the masked PSNR against the analytic view;
     then view 0 of dust3r_like again with ``model.fused_agg=false``, its
     counters read on their own (K1 6, K6b 5 and K6a 1 per chunk, no K2/K3);
  6. reference render: the first 4096-ray chunk rendered again with the
     plain versions substituted for the kernels, compared ray by ray; the
     same for the chunk under ``model.fused_agg=false`` and under
     ``model.render_budget_frac=0.9``;
  7. where the render's time goes: view 0 of the DUSt3R-like scene
     rendered warm TIMED_RENDERS times (rays/s), then once under
     ``torch.profiler`` (the ``profile:`` JSON line);
  8. training kernels: a ``Trainer`` on the DUSt3R-like scene at full
     width (1024 rays/step, default config, auto budgets) takes one step
     whose kernel inputs are kept; every launch of it runs again against
     its plain version: K1 (probe, shading, pseudo-SDF), K2 (probe) and K3
     (render SDF, pseudo-SDF) by the limits of phase 4; K4 and K5 within
     the f32 sum-order limit of ``sum_order_within`` (an f32-reordered
     plain sum is read beside it as a control), with timings, bounds and
     ``index_add_`` as the library yardstick;
  9. reference step: the loss and the gradient of every trained tensor of
     one batch, through the kernels and through the plain versions, with
     the same batch and draws, compared by ``compare_grads``; then two
     steps under ``torch.cuda.set_sync_debug_mode`` count the host syncs;
 10. training path: the DUSt3R-like scene renders view 0 (masked PSNR),
     trains a warm-up window, then -- counters set to 0 -- TRAIN_STEPS
     timed steps (train rays/s), and renders view 0 again; the loss must
     stay finite, no step may be skipped, rgb_loss must fall and every
     kernel's counter must equal steps x its per-step count; a few steps
     on the dense sphere drive K4/K5 with N > 2**15 and the exact K1;
 11. where a step's time goes: PROFILE_STEPS steps under
     ``torch.profiler`` (the ``train profile:`` JSON line);
 12. two more training paths on dust3r_like, each through phases 8-11
     (every launch of one step against its plain version, one batch's
     loss and gradients, host syncs, OPTION_WARMUP + OPTION_STEPS steps
     with launch counts, a profiled window; the ``train profile <tag>:``
     JSON line): ``model.fused_agg=false`` (K6a, K6b, K5; no
     K2/K3/K4) and ``model.pair_budget_frac=0.625
     model.color_pair_frac=0.75`` (K7a, and K5 behind ``gather_latents``);
 13. pair-MLP microbenchmark (``scripts/microbench.py:88-104``): K7b and
     K7a on MICRO_PAIRS random pairs, counters read on their own, each
     timed and held against its plain version;
 14. the fused colour (``field.FUSED_COLOR``, set and restored around each
     use), in three places: after phase 5, view 0 of dust3r_like rendered
     in full with its launch counts (K8a once per chunk); after phase 6,
     the first chunk against the plain versions (``compare_chunk``), K8a
     held against its plain version on that chunk's colour inputs, and the
     colour path timed through ``aggregate_color`` fused and dense
     (FUSED_COLOR off) at the same shapes, forward and forward+backward;
     after phase 13, the training path of phase 12 with FUSED_COLOR on (K8a
     and K8b once a step; K8b's dlat by phase 4's limits, its dW/db by
     ``compare_grads``' 1e-2 relative L2), OPTION_WARMUP + OPTION_STEPS
     steps, and the colour path timed at one step's shapes;
 15. the ``kernels`` JSON line, the ``redesign_order`` line (the kernels
     ranked by launches x (ms - bound_ms) in this run), the ``nvidia-smi``
     line, then the device JSON line.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import time

# peak rates of one H100 SXM (NVIDIA data sheet; dense, at 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
CHUNK = 4096
TIMED_RENDERS = 3
TRAIN_WARMUP = 20
TRAIN_STEPS = 200
TRAIN_WINDOW = 50
DENSE_STEPS = 3
PROFILE_STEPS = 10
# kernel launches of one training step at the default config (fast_iters=1:
# one sampler probe; the shading query and the pseudo-SDF probe; K3 and K4
# for the render's SDF and for the pseudo-SDF loss; K5 for the colour
# latents); K1 is the packed or the exact variant by the cloud's size
PER_STEP = {"select_knn": 3, "pair_sdf_value_agg": 1, "pair_sdf_aggregate": 2,
            "pair_sdf_aggregate_bwd": 2, "scatter_add_rows": 1}
# the two option paths: fused_agg=false probes with K6b and runs K6a for the
# render SDF and the pseudo-SDF, each scattering its latent gradient with K5
# (as does the colour); the pair-compacted SDF runs K7a (its latents' K5),
# the probe stays K2 and the pseudo-SDF K3/K4, and the colour's K5 is
# gather_latents'
OPTIONS = {
    "unfused": (["model.fused_agg=false"],
                {"select_knn": 3, "pair_sdf_rows_value": 1,
                 "pair_sdf_rows_grad": 2, "scatter_add_rows": 3}),
    "pairs": (["model.pair_budget_frac=0.625", "model.color_pair_frac=0.75"],
              {"select_knn": 3, "pair_sdf_value_agg": 1,
               "pair_sdf_value_and_input_grad": 1, "pair_sdf_aggregate": 1,
               "pair_sdf_aggregate_bwd": 1, "scatter_add_rows": 2}),
}
OPTION_WARMUP = 20
OPTION_STEPS = 50
# the fused colour path's training step: the default's launches, with the
# colour stack through K8a forward and K8b backward (its latents' K5 stays)
FUSED_COLOR_STEP = dict(PER_STEP, fused_color_fwd=1, fused_color_bwd=1)
MICRO_PAIRS = 655360
# device-kernel names of the port's kernels, by the kernels line's label
KERNEL_NAMES = (("K1 select_knn packed", "select_packed_kernel"),
                ("K1 select_knn exact", "select_exact_kernel"),
                ("K2 pair_sdf_value_agg", "pair_mlp_kernel<false>"),
                ("K3 pair_sdf_aggregate", "pair_mlp_kernel<true>"),
                ("K4 pair_sdf_aggregate_bwd", "agg_bwd_kernel"),
                ("K5 scatter_add_rows", "scatter_rows_kernel"),
                ("K6a pair_sdf_rows_grad", "pair_rows_kernel<true, true>"),
                ("K6b pair_sdf_rows_value", "pair_rows_kernel<false, true>"),
                ("K7a pair_sdf_value_and_input_grad",
                 "pair_rows_kernel<true, false>"),
                ("K7b pair_sdf_value", "pair_rows_kernel<false, false>"),
                ("K8a fused_color_fwd", "color_kernel<false>"),
                ("K8b fused_color_bwd", "color_kernel<true>"))
# MACs of the colour stack: F_color per pair, R per point; the backward's
# dW products repeat the forward's, its delta products skip what no output
# reads (F0's posenc rows, R0's dir_enc rows)
F_MACS = 103 * 256 + 3 * 256 * 256
R_MACS = 277 * 256 + 256 * 256 + 256 * 3
F_BWD_MACS = F_MACS + 3 * 256 * 256 + 64 * 256
R_BWD_MACS = R_MACS + 256 * 3 + 2 * 256 * 256
COLOR_PARAMS = F_MACS + 4 * 256 + R_MACS + 2 * 256 + 3      # 361,731 f32
TRAINED = ("feats_geometry", "feats_color", "F_color", "R", "beta")


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events,
    after one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound_ms(n_bytes, flops, peak_flops):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def setup_scene(pts, cols, cfg, prior_path, seed, dev):
    import torch

    from spurfies_tpu_torch.convert.from_jax import load_prior_npz
    from spurfies_tpu_torch.model.networks import init_model_params
    from spurfies_tpu_torch.model.neural_points import build_scene

    gen = torch.Generator().manual_seed(seed)
    scene, latents = build_scene(pts, cfg.model, cols, generator=gen,
                                 device=dev)
    params = init_model_params(cfg.model, gen, device=dev)
    tp = dict(params["train"], **latents)
    return scene, tp, load_prior_npz(prior_path, device=dev)


def first_chunk(scene, view, cfg, dev):
    """cam_loc / ray_dirs of the first CHUNK occupied rays of a view (the
    render's first chunk) and the number of occupied rays."""
    import torch

    from spurfies_tpu_torch.core.cameras import get_camera_params
    from spurfies_tpu_torch.model.renderer import coarse_ray_occupancy

    uv = torch.as_tensor(view["uv"], device=dev)[None]
    pose = torch.as_tensor(view["pose"], device=dev)[None]
    K = torch.as_tensor(view["intrinsics"], device=dev)[None]
    dirs_b, cam_b = get_camera_params(uv, pose, K)
    dirs = dirs_b.reshape(-1, 3)
    cam = cam_b.expand(dirs.shape[0], 3)
    occ = coarse_ray_occupancy(cam, dirs, scene, cfg.model.ray_sampler)
    sel = torch.nonzero(occ)[:, 0]
    return cam[sel[:CHUNK]], dirs[sel[:CHUNK]], int(sel.numel()), sel[:CHUNK]


def kernel_inputs(scene, tp, prior, cam, dirs, cfg):
    """The first chunk's kernel inputs: the first (uniform-z) probe's K1 and
    K2 inputs, and the shading query's K1 and K3 inputs, made by the port's
    own functions as ``_render_body`` makes them."""
    import torch

    from spurfies_tpu_torch.core.density import get_beta
    from spurfies_tpu_torch.model import field
    from spurfies_tpu_torch.model.sampler import (
        error_bound_z_vals,
        uniform_z_vals,
    )
    from spurfies_tpu_torch.ops.voxel_grid import (
        _cell_ids,
        compact_rays,
        fine_occupancy,
        query_grid,
    )

    m = cfg.model
    spec = scene.spec
    geo = tp["feats_geometry"]
    n = geo.shape[0]
    table = field.pair_table(geo, scene.points)

    def k1_in(x):
        x = x.contiguous()
        return x, _cell_ids(x, spec)

    # probe: uniform z, occupancy budget 0.25
    z = uniform_z_vals(cam.shape[0], m.ray_sampler.near, m.ray_sampler.far,
                       m.ray_sampler.n_samples_eval, False,
                       device=cam.device)
    pts = (cam[:, None, :] + z[..., None] * dirs[:, None, :]).reshape(-1, 3)
    budget = max(int(pts.shape[0] * 0.25) // 128 * 128, 128)
    sel, sel_ok, _ = field.compact_pair_slots(
        fine_occupancy(pts, scene.occ_fine, spec), budget)
    xp, cidp = k1_in(pts[sel])
    idx_p, _ = query_grid(xp, scene.table, spec, k=m.k)
    idx_ext_p = field._idx_ext(idx_p, (idx_p >= 0) & sel_ok[:, None], n)

    # shading: the sampler's z-values, then the has-neighbour compaction
    def probe(x, first=False):
        return field.sdf_probe(prior, geo, scene, x, m.k, m.r, m.rbf,
                               budget_frac=0.25, need_grad=False,
                               return_overflow=True)

    z_all, _ = error_bound_z_vals(probe, cam, dirs, m.ray_sampler,
                                  get_beta(tp["beta"], m.density.beta_min),
                                  m.ray_sampler.max_total_iters, False)
    q = (cam[:, None, :] + z_all[..., None] * dirs[:, None, :]).reshape(-1, 3)
    xs, cids = k1_in(q)
    idx_all, _ = query_grid(xs, scene.table, spec, k=m.k)
    idx_all = idx_all.reshape(cam.shape[0], -1, m.k)
    csel, cval = compact_rays(torch.any(idx_all >= 0, -1), m.max_shading_pts)
    zs = torch.gather(z_all, 1, csel)
    nbr = torch.gather(idx_all, 1, csel[..., None].expand(-1, -1, m.k))
    x3 = (cam[:, None, :] + zs[..., None] * dirs[:, None, :]).reshape(-1, 3)
    valid = ((nbr >= 0) & cval[..., None]).reshape(-1, m.k)
    idx_ext_s = field._idx_ext(nbr.reshape(-1, m.k), valid, n)
    # K6: the same probe and shading pairs as gathered rows; K7: the
    # shading pairs compacted as pair_budget_frac=0.625 compacts them
    valid_p = (idx_p >= 0) & sel_ok[:, None]
    budget = max(int(x3.shape[0] * m.k * 0.625) // 256 * 256, 256)
    _, pidx, x_pi, _, seg = field._compact_pairs(
        nbr.reshape(-1, m.k), valid, scene.points, x3, m.rbf, budget)
    ok = seg < x3.shape[0]
    u = torch.cat([geo[pidx.long()], x_pi], -1).contiguous()
    return {"probe_k1": (xp, cidp), "k2": (table, idx_ext_p, xp.contiguous()),
            "shade_k1": (xs, cids),
            "k3": (table, idx_ext_s, x3.contiguous()),
            "k6b": (field.pair_rows(geo, scene.points, idx_p, xp),
                    valid_p.reshape(-1)),
            "k6a": (field.pair_rows(geo, scene.points, nbr.reshape(-1, m.k),
                                    x3), valid.reshape(-1)),
            "k7": ((u,), ok)}


def k1_args(x, cid, scene, k, packed):
    """K1's arguments as ``query_grid`` passes them for ``scene``."""
    import numpy as np

    qt = scene.table
    r2 = float(np.float32(scene.spec.radius(qt.r) ** 2))
    return (x, cid, qt.idx, qt.pos, r2, k, packed)


def check_k1(name, args, reps):
    """K1 against its plain version on ``args`` (:func:`k1_args`)."""
    import torch

    from spurfies_tpu_torch.ops import select_knn as sk

    x, cid, qidx, qpos, r2, k, packed = args
    ki, kd = sk.select_knn(*args)
    ri, rd = sk.select_knn_ref(*args)
    torch.cuda.synchronize()
    # tolerance: bit-equal ids and d2 (the kernel avoids FMA contraction,
    # so it does the plain version's f32 operations)
    if not bool((ki == ri).all()):
        fail(f"{name}: {int((ki != ri).sum())} neighbour ids differ")
    fin = torch.isfinite(rd)
    if not bool((torch.isfinite(kd) == fin).all()):
        fail(f"{name}: validity differs")
    err = float((kd[fin] - rd[fin]).abs().max()) if bool(fin.any()) else 0.0
    if err != 0.0:
        fail(f"{name}: d2 differs by {err}")
    ms = cuda_ms(lambda: sk.select_knn(*args), reps)
    plain_ms = cuda_ms(lambda: sk.select_knn_ref(*args), 3)
    # library yardstick: torch.topk over the [M, qcap] distance matrix
    in_grid = (cid >= 0) & (cid < qidx.shape[0])
    c = torch.where(in_grid, cid, 0).long()
    diff = qpos[c] - x[:, :, None]
    d2m = (diff * diff).sum(1)
    d2m = torch.where((qidx[c] >= 0) & in_grid[:, None] & (d2m <= r2),
                      d2m, float("inf"))
    lib_ms = cuda_ms(lambda: torch.topk(d2m, k, dim=1, largest=False), reps)
    # bound: x, cid and the outputs once, the table rows of the cells that
    # are queried once; ~9 f32 ops per candidate a query really scans
    m = x.shape[0]
    cells = torch.unique(cid[in_grid])
    q = qidx.shape[1]
    scanned = (qidx[c] >= 0).sum(1)[in_grid].sum()
    n_bytes = m * (12 + 4 + k * 8) + int(cells.numel()) * q * 16
    b_ms, b_by = bound_ms(n_bytes, 9.0 * float(scanned), PEAK_F32_FLOPS)
    log(f"{name}: M={m} qcap={q} ids+d2 bit-equal; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, topk {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "max_abs_err": err}


def check_pair(name, fn, ref, args, prior, prior_f32, rbf, reps):
    import torch

    with torch.no_grad():
        outs = fn(*args, prior, rbf)
        refs = ref(*args, prior, rbf)
        # control: the plain version in f32, read against the limits below
        # and never held to them; it shows what a change of rounding reads
        ctrl = ref(*args, prior_f32, rbf)
    torch.cuda.synchronize()
    if not isinstance(outs, tuple):
        outs, refs, ctrl = (outs,), (refs,), (ctrl,)
    pt, pt_r = outs[0], refs[0]
    if not bool(torch.isfinite(pt).all()):
        fail(f"{name}: non-finite output")
    # tolerance: bf16 on both sides with the same rounding points; only the
    # f32 sums inside each product run in another order, so a bf16 rounding
    # can land one ulp (2**-8 relative) apart and carry through the layers
    err = within(f"{name} per-point sums", pt, pt_r)
    within(f"{name} per-point sums, control f32 plain", ctrl[0], pt_r,
           hold=False)
    if len(outs) == 3:
        w_err = float((outs[1] - refs[1]).abs().max())
        if w_err > 1e-6:               # expf against torch.exp, ulps
            fail(f"{name}: w differs by {w_err}")
        within(f"{name} r_lat", outs[2].float(), refs[2].float())
        within(f"{name} r_lat, control f32 plain", ctrl[2].float(),
               refs[2].float(), hold=False)
    del ctrl
    table, idx_ext, x = args
    p, k = idx_ext.shape
    with torch.no_grad():
        ms = cuda_ms(lambda: fn(*args, prior, rbf), reps)
        plain_ms = cuda_ms(lambda: ref(*args, prior, rbf), 2)
    # MACs per pair: up 32*256 + 3*256 + 3*256*256 + 256; K3 adds the down
    # sweep 3*256*256 + 256*35 (the first delta is elementwise).  The work
    # this data needs is that of the real pairs: a pair on the dump row
    # has w == 0 and adds nothing (the kernel computes it all the same).
    up = 32 * 256 + 3 * 256 + 3 * 256 * 256 + 256
    down = 3 * 256 * 256 + 256 * 35
    grad = len(outs) == 3
    pairs = int((idx_ext != table.shape[0] - 1).sum())
    flops = 2.0 * pairs * (up + (down if grad else 0))
    n_bytes = table.numel() * 4 + p * k * 4 + p * 12 + \
        (p * 20 + p * k * (4 + 64) if grad else p * 8)
    b_ms, b_by = bound_ms(n_bytes, flops, PEAK_BF16_FLOPS)
    log(f"{name}: P={p} k={k}, {pairs} real pairs "
        f"({pairs / (p * k):.3f}); kernel {ms:.4f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s on real pairs, "
        f"{flops * p * k / max(pairs, 1) / ms / 1e9:.1f} executed), "
        f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "max_abs_err": err}


def check_rows(name, fn, ref, args, prior, prior_f32, reps, radius,
               n_real=None):
    """A per-row pair-MLP kernel (K6a/K6b on (g, x), K7a/K7b on (u,))
    against its plain version: x_pi bit-equal (the same f32 subtraction),
    s and r by the limits of phase 4 (the 0.05 rule on the rows whose x_pi
    lies in the query ``radius``: no RBF weight reads the others), with
    the f32 control beside them.  ``n_real``: the rows this data needs
    (valid pairs; default all)."""
    import torch

    xpi = args[1] - args[0][:, 32:] if len(args) == 2 else args[0][:, 32:]
    keep = (xpi * xpi).sum(1) <= radius * radius

    with torch.no_grad():
        outs = fn(*args, prior)
        refs = ref(*args, prior)
        ctrl = ref(*args, prior_f32)
    torch.cuda.synchronize()
    if not isinstance(outs, tuple):
        outs, refs, ctrl = (outs,), (refs,), (ctrl,)
    grad = len(outs) == 3 or (len(args) == 1 and len(outs) == 2)
    labels = ("s", "r", "x_pi")[:len(outs)] if grad else ("s", "x_pi")
    err = 0.0
    for label, o, r, c in zip(labels, outs, refs, ctrl):
        if not bool(torch.isfinite(o).all()):
            fail(f"{name}: non-finite {label}")
        if label == "x_pi":
            if not torch.equal(o, r):
                fail(f"{name}: x_pi differs from x - pos")
            continue
        err = max(err, within(f"{name} {label}", o, r, keep=keep))
        within(f"{name} {label}, control f32 plain", c, r, hold=False,
               keep=keep)
    del ctrl
    with torch.no_grad():
        ms = cuda_ms(lambda: fn(*args, prior), reps)
        plain_ms = cuda_ms(lambda: ref(*args, prior), 2)
    rows = args[0].shape[0]
    needed = ("" if n_real is None else
              f", {n_real} rows the data needs ({n_real / max(rows, 1):.3f})")
    n_real = rows if n_real is None else n_real
    up = 32 * 256 + 3 * 256 + 3 * 256 * 256 + 256
    down = 3 * 256 * 256 + 256 * 35
    per_row = 2.0 * (up + (down if grad else 0))
    # bytes: every input row read once, every output written once, and the
    # packed bf16 weights and f32 biases
    wbuf, bbuf = prior.kernel_buffers()
    n_bytes = sum(t.numel() * 4 for t in args) + \
        sum(o.numel() * 4 for o in outs) + wbuf.numel() * 2 + bbuf.numel() * 4
    b_ms, b_by = bound_ms(n_bytes, per_row * n_real, PEAK_BF16_FLOPS)
    b_all, _ = bound_ms(n_bytes, per_row * rows, PEAK_BF16_FLOPS)
    log(f"{name}: M={rows}{needed}; kernel {ms:.4f} ms "
        f"({per_row * rows / ms / 1e9:.1f} TFLOP/s executed), plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {b_all:.4f} ms "
        "counting every row)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "max_abs_err": err,
            "bound_all_rows_ms": b_all, "rows": rows, "rows_needed": n_real}


def within(what, out, ref, hold=True, keep=None):
    """|out - ref| <= 2**-6 |ref| + 1e-3 scale for 99.9% of the entries and
    <= 0.05 scale for all, per column (scale: the column's max |ref|; the
    0.1% allows a LeakyReLU gate that flips on a kink).  ``keep`` (bool per
    row): the rows the data can use; the 0.05 rule is then held on them,
    with their own scale, and the reading over every row is printed beside
    it (a per-pair kernel also runs masked slots, whose gate flips no
    output reads).  Returns the max abs error; fails on a breach when
    ``hold``."""
    out = out.reshape(out.shape[0], -1)
    ref = ref.reshape(ref.shape[0], -1)
    scale = ref.abs().amax(0, keepdim=True) + 1e-30
    d = (out - ref).abs()
    beyond = (d > 2.0 ** -6 * ref.abs() + 1e-3 * scale).float().mean()
    worst = every = float((d / scale).max())
    if keep is not None:
        kept = ref[keep].abs().amax(0, keepdim=True) + 1e-30
        worst = float((d[keep] / kept).max()) if bool(keep.any()) else 0.0
    err = float(d.max())
    log(f"  {what}: max abs err {err:.3e}, max err / column scale "
        f"{worst:.3e}" + ("" if keep is None else
                          f" on the {int(keep.sum())} rows in the query "
                          f"radius ({every:.3e} on every row)")
        + f", share beyond 2^-6 rel {float(beyond):.2e}")
    if hold and (float(beyond) > 1e-3 or worst > 0.05):
        fail(f"{what}: kernel and plain version disagree")
    return err


def compare_chunk(a, b):
    """Ray-by-ray agreement of two renders of one chunk (kernels vs plain
    versions, both bf16).

    The SDF values agree to a bf16 ulp, but the sampler's beta bisection
    makes discrete choices on them, so a few rays place their samples
    elsewhere; and an RBF weight exp(-(45 d)^2) moves ~10% when a sample
    moves by 1e-3, so such a ray's normal and colour move with it.  Hence:
    ray_mask may flip on 0.2% of the rays; depth and acc agree within 2e-3
    on 95% of the rays (median within 1e-4); and on the rays whose depth
    and acc agree within 1e-6 (the same samples; at least half of them),
    normal and colour agree within 1e-2 on 99% (median within 1e-3)."""
    import numpy as np

    mask = a["ray_mask"].cpu().numpy()
    if (mask != b["ray_mask"].cpu().numpy()).mean() > 0.002:
        fail("chunk: ray_mask differs on more than 0.2% of the rays")
    both = mask & b["ray_mask"].cpu().numpy()
    if not both.any():
        fail("chunk: no ray hit the cloud")
    err = {key: (a[key] - b[key]).abs().reshape(len(mask), -1).amax(-1)
           .cpu().numpy()[both]
           for key in ("depth_values", "acc", "normal_map", "rgb_values")}
    same = (err["depth_values"] <= 1e-6) & (err["acc"] <= 1e-6)
    stats = {"same_sample_share": float(same.mean())}
    for key, t, t_med, sub in (("depth_values", 2e-3, 1e-4, None),
                               ("acc", 2e-3, 1e-4, None),
                               ("normal_map", 1e-2, 1e-3, same),
                               ("rgb_values", 1e-2, 1e-3, same)):
        e = err[key] if sub is None else err[key][sub]
        share = 0.05 if sub is None else 0.01
        stats[key] = {q: float(np.quantile(e, v)) for q, v in
                      (("p50", 0.5), ("p95", 0.95), ("p99", 0.99),
                       ("max", 1.0))}
        stats[key]["share_beyond"] = float((e > t).mean())
        if (e > t).mean() > share or np.median(e) > t_med:
            fail(f"chunk: {key} differs: {stats[key]}")
    if same.mean() < 0.5:
        fail(f"chunk: only {same.mean():.2f} of the rays kept their samples")
    return stats


def profile_summary(prof, wall_ms):
    """Device-busy share and device time by kernel and by PyTorch op of a
    ``torch.profiler`` run.  Device time is counted once, on the kernel
    events; a PyTorch op's self device time is the time of the kernels it
    launched directly."""
    from torch.autograd import DeviceType

    kernels, ops = {}, {}
    for evt in prof.key_averages():
        us = evt.self_device_time_total
        if us <= 0 or evt.is_user_annotation:
            continue
        into = ops if evt.device_type == DeviceType.CPU else kernels
        into[evt.key] = into.get(evt.key, 0.0) + us
    groups = {label: 0.0 for label, _ in KERNEL_NAMES}
    for key, us in kernels.items():
        label = next((lb for lb, pat in KERNEL_NAMES if pat in key), None)
        if label is not None:
            groups[label] += us / 1e3
    busy_ms = sum(kernels.values()) / 1e3
    if busy_ms <= 0:
        fail("profile: the profiler saw no device time")
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:15]
    return {"profiled_wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "kernel_ms": groups,
            "pytorch_ops_ms": {k: v / 1e3 for k, v in top_ops},
            "pytorch_ops_total_ms": sum(ops.values()) / 1e3}


def profiled(fn):
    """``fn()`` once under ``torch.profiler``, between synchronisations;
    returns :func:`profile_summary` of it."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return profile_summary(prof, wall_ms)


def profile_render(render_image, scene, tp, frozen, view):
    """Rays/s of TIMED_RENDERS warm renders of ``view`` (host clock around
    work that ends in a synchronise), then one render under
    ``torch.profiler``."""
    import torch

    args = (tp, scene, frozen, view["uv"], view["pose"], view["intrinsics"])
    n = len(view["uv"])
    walls = []
    for _ in range(TIMED_RENDERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_image(*args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return {"rays": n, "render_wall_s": walls,
            "rays_per_s": [n / w for w in walls],
            **profiled(lambda: render_image(*args))}


def kernel_sites():
    """Where the port calls each kernel's wrapper: (module, attribute,
    plain version), K1 to K7a and K8a/K8b (K7b has no caller in the port:
    the microbenchmark calls it)."""
    from spurfies_tpu_torch.model import field
    from spurfies_tpu_torch.ops import (
        fused_color,
        pair_mlp,
        scatter_rows,
        voxel_grid,
    )
    from spurfies_tpu_torch.ops import select_knn as sk

    return [(fused_color, "fused_color_fwd", fused_color.fused_color_fwd_ref),
            (fused_color, "fused_color_bwd", fused_color.fused_color_bwd_ref),
            (voxel_grid, "select_knn", sk.select_knn_ref),
            (field, "pair_sdf_value_agg", pair_mlp.pair_sdf_value_agg_ref),
            (pair_mlp, "pair_sdf_aggregate", pair_mlp.pair_sdf_aggregate_ref),
            (pair_mlp, "pair_sdf_aggregate_bwd",
             pair_mlp.pair_sdf_aggregate_bwd_ref),
            (field, "scatter_add_rows", scatter_rows.scatter_add_rows_ref),
            (field, "pair_sdf_rows_value", pair_mlp.pair_sdf_rows_value_ref),
            (pair_mlp, "pair_sdf_rows_grad", pair_mlp.pair_sdf_rows_grad_ref),
            (pair_mlp, "pair_sdf_value_and_input_grad",
             pair_mlp.pair_sdf_value_and_input_grad_ref)]


class substituted:
    """Put ``make(wrapper, plain)`` in place of each kernel's wrapper where
    the port calls it (the port has no switch), or at ``sites`` (the same
    triples), and restore them on exit."""

    def __init__(self, make, sites=None):
        self.make = make
        self.given = sites

    def __enter__(self):
        self.sites = self.given or kernel_sites()
        self.saved = [getattr(mod, name) for mod, name, _ in self.sites]
        for (mod, name, ref), fn in zip(self.sites, self.saved):
            setattr(mod, name, self.make(fn, ref))
        return self

    def __exit__(self, *exc):
        for (mod, name, _), fn in zip(self.sites, self.saved):
            setattr(mod, name, fn)
        return False


def plain_versions():
    """The plain PyTorch versions in place of the kernels' wrappers."""
    return substituted(lambda fn, ref: ref)


@contextlib.contextmanager
def fused_color_set(on):
    """``field.FUSED_COLOR = on``, and put back as it was on exit."""
    from spurfies_tpu_torch.model import field

    saved = field.FUSED_COLOR
    field.FUSED_COLOR = on
    try:
        yield
    finally:
        field.FUSED_COLOR = saved


def counters():
    from spurfies_tpu_torch.ops import fused_color, pair_mlp, scatter_rows
    from spurfies_tpu_torch.ops import select_knn as sk
    return (sk.LAUNCHES, pair_mlp.LAUNCHES, scatter_rows.LAUNCHES,
            fused_color.LAUNCHES)


def zero_counts():
    for c in counters():
        for key in c:
            c[key] = 0


def read_counts():
    return {k: v for c in counters() for k, v in c.items()}


def sum_order_within(what, out, ref, abs_sum, count, hold=True):
    """|out - ref| <= 2 c 2**-24 sum|terms| on every entry: two f32 sums of
    the same c terms in any two orders lie that close (each lies within
    (c - 1) 2**-24 sum|terms| of the exact sum).  ``abs_sum``: the same
    scatter of |terms|; ``count``: the terms of each output row.  Prints
    the largest share of the limit used; fails on a breach when ``hold``.
    Returns the max abs error."""
    tol = 2.0 * count[:, None].float() * 2.0 ** -24 * abs_sum
    d = (out - ref).abs()
    used = float((d / tol.clamp(min=1e-38)).max())
    err = float(d.max())
    log(f"  {what}: max abs err {err:.3e}, max share of the sum-order "
        f"limit {used:.3e}, entries beyond it {int((d > tol).sum())}")
    if hold and bool((d > tol).any()):
        fail(f"{what}: kernel and plain version disagree beyond f32 "
             "reordering")
    return err


def capture_step(trainer, sites=None):
    """One training step; returns, by wrapper name, the arguments of each
    kernel launch in it (references, all of the wrapper's parameters in
    order, in launch order), or of each call at ``sites``."""
    return capture(lambda: trainer.train_step(trainer.bundle, trainer.state,
                                              trainer.generator), sites)


def capture(fn, sites=None):
    """``fn()``; returns, by function name, the arguments of each call of
    the kernels' wrappers (or of the functions at ``sites``) in it."""
    import inspect

    seen = {}

    def recorder(fn, ref):
        sig = inspect.signature(fn)

        def rec(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            seen.setdefault(fn.__name__, []).append(
                tuple(bound.arguments.values()))
            return fn(*args, **kwargs)
        return rec

    with substituted(recorder, sites):
        fn()
    return seen


def check_step(tag, seen, prior_f32, radius):
    """Every kernel launch of one captured step (:func:`capture_step`)
    against its plain version: K1 bit-equal, the pair-MLP kernels and K8a
    by the limits of phase 4, K4/K5 by ``sum_order_within``, K8b's dlat by
    phase 4's and its dW/db by 1e-2 relative L2.  Returns, by wrapper name,
    the result of its largest launch."""
    from spurfies_tpu_torch.ops import pair_mlp

    best = {}
    for name, calls in seen.items():
        big = 1 if name in ("pair_sdf_value_agg", "pair_sdf_aggregate") else 0
        calls = sorted(calls, key=lambda a: -a[big].shape[0])
        for i, args in enumerate(calls):
            what = f"{name} ({tag}, launch {i + 1} of {len(calls)})"
            if name == "fused_color_fwd":
                r = check_k8a(what, args, 10)
            elif name == "fused_color_bwd":
                r = check_k8b(what, args, 5)
            elif name == "select_knn":
                r = check_k1(what, args, 10)
            elif name == "pair_sdf_aggregate_bwd":
                r = check_k4(what, args, 50)
            elif name == "scatter_add_rows":
                r = check_k5(what, args, 50)
            elif big:
                table, idx_ext, x, layers, rbf = args
                r = check_pair(what, getattr(pair_mlp, name),
                               getattr(pair_mlp, f"{name}_ref"),
                               (table, idx_ext, x), layers, prior_f32, rbf,
                               5)
            else:                                    # K6a, K6b, K7a
                r = check_rows(what, getattr(pair_mlp, name),
                               getattr(pair_mlp, f"{name}_ref"),
                               tuple(args[:-1]), args[-1], prior_f32, 5,
                               radius)
            if i == 0:
                best[name] = r
        del calls
    return best


def expected_counts(keys, per_step, steps, knn):
    """Launch counts of ``steps`` steps: ``per_step`` each, K1 under the
    variant ``knn``, every other counter 0."""
    expect = {k: 0 for k in keys}
    for key, per in per_step.items():
        expect[knn if key == "select_knn" else key] = per * steps
    return expect


def train_path(tag, trainer, per_step, warmup, steps, window):
    """Phases 8-10 for one ``Trainer`` on dust3r_like: one captured step
    with every launch against its plain version, one batch's loss and
    gradients through the kernels and through the plain versions, host
    syncs in two steps, then ``warmup`` steps and -- counters set to 0 --
    ``steps`` timed ones.  Fails unless the loss stays finite, no step is
    skipped, rgb_loss falls and the counters equal steps x ``per_step``.
    Returns (results by wrapper name, launches, history)."""
    import numpy as np
    import torch

    from spurfies_tpu_torch.ops.pair_mlp import _prep_layers

    dev = trainer.device
    mc = trainer.cfg.model
    log(f"trainer {tag}: {trainer.scene.points.shape[0]} points, auto "
        f"budgets ray {mc.ray_budget_frac:.4f} probe "
        f"{mc.probe_budget_frac:.4f}")
    seen = capture_step(trainer)
    got = {k: len(v) for k, v in seen.items()}
    if got != per_step:
        fail(f"{tag}: one step launched {got}, expected {per_step}")
    spec = trainer.scene.spec
    best = check_step(tag, seen, _prep_layers(trainer.frozen, torch.float32),
                      spec.radius(trainer.scene.table.r))
    del seen
    torch.cuda.empty_cache()

    batch = trainer.sample_batch(
        trainer.views, torch.Generator(device=dev).manual_seed(7))
    parts_k, grads_k = loss_and_grads(trainer, batch, seed=8)
    with plain_versions():
        parts_p, grads_p = loss_and_grads(trainer, batch, seed=8)
    log(f"{tag} step, kernels vs plain versions (same batch and draws):")
    compare_grads(parts_k, grads_k, parts_p, grads_p)
    del grads_k, grads_p
    n_sync, first_sync = count_host_syncs(trainer, 2)
    log(f"{tag}: host syncs in 2 training steps: {n_sync}"
        + (f" (first: {first_sync})" if n_sync else ""))
    if n_sync:
        fail(f"{tag}: a training step waits on the card")

    history = []
    trainer.run(warmup, window=warmup,
                callback=lambda s_, m: history.append((s_, m)))
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.run(steps, window=window,
                callback=lambda s_, m: history.append((s_, m)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    n_pix = trainer.cfg.train.num_pixels
    log(f"train {tag}: {steps} steps x {n_pix} rays in {wall:.3f} s = "
        f"{steps * n_pix / wall:.1f} train rays/s "
        f"({wall / steps * 1e3:.2f} ms/step); launches {launches}")
    for step, m in history:
        log(f"  step {step}: " + ", ".join(
            f"{k} {m[k]:.5g}" for k in ("loss", "rgb_loss", "eikonal_loss",
                                        "mask_loss", "pseudo_loss", "tv_loss",
                                        "psnr", "ray_overflow",
                                        "probe_overflow", "notfinite")))
    if not all(np.isfinite(m["loss"]) and m["notfinite"] == 0
               for _, m in history):
        fail(f"{tag}: a non-finite loss or a skipped step")
    if not history[-1][1]["rgb_loss"] < history[0][1]["rgb_loss"]:
        fail(f"{tag}: rgb_loss did not fall")
    expect = expected_counts(launches, per_step, steps, "select_knn_packed")
    if launches != expect:
        fail(f"{tag}: launch counts {launches} != expected {expect}")
    return best, launches, history


def check_k4(name, args, reps):
    """K4 against its plain version on one real launch's inputs."""
    import torch

    from spurfies_tpu_torch.ops import pair_mlp

    num_bar, w, r_lat, idx_ext, n = args
    p, k = idx_ext.shape
    out = pair_mlp.pair_sdf_aggregate_bwd(*args)
    ref = pair_mlp.pair_sdf_aggregate_bwd_ref(*args)
    flat = idx_ext.reshape(-1).long()
    keep = (flat >= 0) & (flat < n) & (w != 0)
    count = torch.bincount(flat[keep], minlength=n)
    abs_sum = pair_mlp.pair_sdf_aggregate_bwd_ref(
        num_bar.abs(), w.abs(), r_lat.abs(), idx_ext, n)
    # control: the plain sum over the points in another order
    perm = torch.randperm(p, device=w.device)
    ctrl = pair_mlp.pair_sdf_aggregate_bwd_ref(
        num_bar[perm], w.view(p, k)[perm].reshape(-1),
        r_lat.view(p, k, -1)[perm].reshape(p * k, -1), idx_ext[perm], n)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        fail(f"{name}: non-finite output")
    err = sum_order_within(name, out, ref, abs_sum, count)
    sum_order_within(f"{name}, control: plain summed in another order",
                     ctrl, ref, abs_sum, count, hold=False)
    ms = cuda_ms(lambda: pair_mlp.pair_sdf_aggregate_bwd(*args), reps)
    plain_ms = cuda_ms(lambda: pair_mlp.pair_sdf_aggregate_bwd_ref(*args),
                       5)
    # library yardstick: index_add_ of the expanded cotangent's kept rows
    # (the expansion itself is left out of the time)
    ct = ((torch.repeat_interleave(num_bar, k) * w)[:, None]
          * r_lat.float())[keep]
    idx_k = flat[keep]
    lib_ms = cuda_ms(lambda: torch.zeros((n, 32), device=w.device)
                     .index_add_(0, idx_k, ct), reps)
    kept = int(keep.sum())
    dump = int((flat == n).sum())
    # bytes: idx and w of every row, r_lat of the kept rows, num_bar, and
    # the output written once
    n_bytes = p * k * 8 + kept * 64 + p * 4 + n * 32 * 4
    b_ms, b_by = bound_ms(n_bytes, 2.0 * 32 * kept, PEAK_F32_FLOPS)
    log(f"{name}: P={p} k={k} rows {p * k}, kept {kept} "
        f"({kept / (p * k):.3f}), dump rows {dump} ({dump / (p * k):.3f}), "
        f"{kept / max(int((count > 0).sum()), 1):.1f} adds per latent row "
        f"hit; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "max_abs_err": err}


def check_k5(name, args, reps):
    """K5 against its plain version on one real launch's inputs."""
    import torch

    from spurfies_tpu_torch.ops import scatter_rows as sr

    ct, idx, n = args
    m, d = ct.shape
    out = sr.scatter_add_rows(*args)
    ref = sr.scatter_add_rows_ref(*args)
    keep = (idx >= 0) & (idx < n)
    count = torch.bincount(idx[keep].long(), minlength=n)
    abs_sum = sr.scatter_add_rows_ref(ct.abs(), idx, n)
    perm = torch.randperm(m, device=ct.device)
    ctrl = sr.scatter_add_rows_ref(ct[perm], idx[perm], n)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        fail(f"{name}: non-finite output")
    err = sum_order_within(name, out, ref, abs_sum, count)
    sum_order_within(f"{name}, control: plain summed in another order",
                     ctrl, ref, abs_sum, count, hold=False)
    ms = cuda_ms(lambda: sr.scatter_add_rows(*args), reps)
    plain_ms = cuda_ms(lambda: sr.scatter_add_rows_ref(*args), 5)
    ct_k, idx_k = ct[keep].contiguous(), idx[keep].long()
    lib_ms = cuda_ms(lambda: torch.zeros((n, d), device=ct.device)
                     .index_add_(0, idx_k, ct_k), reps)
    kept = int(keep.sum())
    n_bytes = m * 4 + kept * d * 4 + n * d * 4
    b_ms, b_by = bound_ms(n_bytes, float(kept * d), PEAK_F32_FLOPS)
    log(f"{name}: M={m} d={d} row stride {ct.stride(0)}, kept {kept}, "
        f"{kept / max(int((count > 0).sum()), 1):.1f} rows per latent row "
        f"hit; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "max_abs_err": err}


def rel_l2_within(what, out, ref, limit, hold=True):
    """||out - ref|| / ||ref|| <= ``limit``; prints the reading, fails on a
    breach when ``hold``.  Returns the max abs error."""
    import torch

    rel = float(torch.linalg.vector_norm(out - ref)
                / max(float(torch.linalg.vector_norm(ref)), 1e-30))
    err = float((out - ref).abs().max())
    log(f"  {what}: relative L2 {rel:.3e} (limit {limit:g}), max abs err "
        f"{err:.3e}")
    if hold and not rel <= limit:
        fail(f"{what}: kernel and plain version disagree")
    return err


def k8_work(wn, p, bwd):
    """(flops of the real pairs, flops of every row, bytes) of K8a or K8b
    on ``p`` points: F_color's work on the pairs with wn != 0 (an invalid
    pair adds nothing: its weight, and so its delta, is 0) and R's on
    every point; each input read once, each output written once, the f32
    weights read once."""
    real = int((wn != 0).sum())
    f, r = (F_MACS + F_BWD_MACS, R_MACS + R_BWD_MACS) if bwd else (F_MACS,
                                                                   R_MACS)
    n_bytes = 8 * p * (12 + 256 + 4) + p * 84 + 4 * COLOR_PARAMS
    n_bytes += (p * 12 + 8 * p * 256 + 4 * COLOR_PARAMS) if bwd else p * 12
    return (2.0 * (real * f + p * r), 2.0 * (8 * p * f + p * r), n_bytes,
            real)


def check_k8a(name, args, reps):
    """K8a against its plain version on one launch's inputs: rgb by the
    limits of phase 4, with the f32 plain control beside them."""
    import torch

    from spurfies_tpu_torch.ops import fused_color as fc

    x_pi, lat, wn, dir_enc, f_color, r, dt = args
    with torch.no_grad():
        out = fc.fused_color_fwd(*args)
        ref = fc.fused_color_fwd_ref(*args)
        ctrl = fc.fused_color_fwd_ref(*args[:-1], torch.float32)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out).all()):
            fail(f"{name}: non-finite rgb")
        err = within(f"{name} rgb", out, ref)
        within(f"{name} rgb, control f32 plain", ctrl, ref, hold=False)
        del ctrl
        ms = cuda_ms(lambda: fc.fused_color_fwd(*args), reps)
        plain_ms = cuda_ms(lambda: fc.fused_color_fwd_ref(*args), 3)
    p = dir_enc.shape[0]
    flops, flops_all, n_bytes, real = k8_work(wn, p, False)
    b_ms, b_by = bound_ms(n_bytes, flops, PEAK_BF16_FLOPS)
    b_all, _ = bound_ms(n_bytes, flops_all, PEAK_BF16_FLOPS)
    log(f"{name}: P={p}, {real} real pairs of {8 * p} "
        f"({real / max(8 * p, 1):.3f}); kernel {ms:.4f} ms "
        f"({flops_all / ms / 1e9:.1f} TFLOP/s executed), plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {b_all:.4f} ms "
        "counting every pair)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "max_abs_err": err,
            "bound_all_rows_ms": b_all, "rows": 8 * p, "rows_needed": real}


def check_k8b(name, args, reps):
    """K8b against its plain version on one launch's inputs: dlat by the
    limits of phase 4, each dW/db within ``compare_grads``' 1e-2 relative
    L2 (the dW/db sums run in another order: atomics), the f32 plain
    control read beside each; and no latent gradient on a pair of weight
    0."""
    import torch

    from spurfies_tpu_torch.ops import fused_color as fc

    x_pi, lat, wn, dir_enc, f_color, r, rgb_bar, dt = args
    with torch.no_grad():
        dlat, dws, dbs = fc.fused_color_bwd(*args)
        ref = fc.fused_color_bwd_ref(*args)
        ctrl = fc.fused_color_bwd_ref(*args[:-1], torch.float32)
        torch.cuda.synchronize()
        outs = [dlat] + dws + dbs
        if not all(bool(torch.isfinite(o).all()) for o in outs):
            fail(f"{name}: non-finite output")
        if bool((dlat[wn == 0] != 0).any()):
            fail(f"{name}: a pair of weight 0 got a latent gradient")
        err = within(f"{name} dlat", dlat, ref[0])
        within(f"{name} dlat, control f32 plain", ctrl[0], ref[0],
               hold=False)
        names = ("F0", "F1", "F2", "F3", "R0", "R1", "R2")
        labels = [f"dW {n}" for n in names] + [f"db {n}" for n in names]
        for label, o, rf, c in zip(labels, outs[1:], ref[1] + ref[2],
                                   ctrl[1] + ctrl[2]):
            err = max(err, rel_l2_within(f"{name} {label}", o, rf, 1e-2))
            rel_l2_within(f"{name} {label}, control f32 plain", c, rf, 1e-2,
                          hold=False)
        del ref, ctrl, outs, dlat, dws, dbs
        ms = cuda_ms(lambda: fc.fused_color_bwd(*args), reps)
        plain_ms = cuda_ms(lambda: fc.fused_color_bwd_ref(*args), 3)
    p = dir_enc.shape[0]
    flops, flops_all, n_bytes, real = k8_work(wn, p, True)
    b_ms, b_by = bound_ms(n_bytes, flops, PEAK_BF16_FLOPS)
    b_all, _ = bound_ms(n_bytes, flops_all, PEAK_BF16_FLOPS)
    adds = -(-p // 16) * COLOR_PARAMS
    log(f"{name}: P={p}, {real} real pairs of {8 * p}; kernel {ms:.4f} ms "
        f"({flops_all / ms / 1e9:.1f} TFLOP/s executed; {adds} dW/db atomic "
        f"adds), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
        f"{b_all:.4f} ms counting every pair)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "max_abs_err": err,
            "bound_all_rows_ms": b_all, "rows": 8 * p, "rows_needed": real,
            "atomic_adds": adds}


def colour_paths(args, reps):
    """``field.aggregate_color`` on one call's captured arguments, fused
    (K8a, K8b) and dense (FUSED_COLOR off, the PyTorch colour MLPs) at the
    same shapes: ms of the forward and of forward + backward (the gradient
    of every colour leaf for a random cotangent)."""
    import torch

    from spurfies_tpu_torch.model import field

    tp = args[0]
    leaves = [tp["feats_color"].detach().requires_grad_(True)]
    nets = {}
    for n in ("F_color", "R"):
        nets[n] = [{k: layer[k].detach().requires_grad_(True)
                    for k in ("w", "b")} for layer in tp[n]]
        leaves += [layer[k] for layer in nets[n] for k in ("w", "b")]
    tp2 = dict(nets, feats_color=leaves[0])
    call = (tp2, leaves[0]) + tuple(args[2:])
    c = torch.randn((args[5].shape[0], 3), device=args[5].device)

    def fwd():
        with torch.no_grad():
            field.aggregate_color(*call)

    def fwd_bwd():
        rgb = field.aggregate_color(*call)
        torch.autograd.grad((rgb * c).sum(), leaves)

    out = {}
    for mode, on in (("fused", True), ("dense", False)):
        with fused_color_set(on):
            out[f"{mode}_fwd_ms"] = cuda_ms(fwd, reps)
            out[f"{mode}_fwd_bwd_ms"] = cuda_ms(fwd_bwd, reps)
    log(f"  colour path through aggregate_color, M={args[5].shape[0]} "
        f"points: " + ", ".join(f"{k} {v:.4f}" for k, v in out.items()))
    return out


def redesign_order(rows):
    """The kernels line's rows ranked by the time this run spent above
    their bounds: launches x (ms - bound_ms), the render and microbenchmark
    launches at the row's own shape and the training launches at its
    ``train_shape`` where it has one (else the row's shape is the training
    one).  Returns [(label, excess ms)], largest first."""
    order = []
    for row in rows:
        t = row.get("train_shape", row)
        excess = ((row["launches_render"] + row["launches_microbench"])
                  * (row["ms"] - row["bound_ms"])
                  + row["launches_train"] * (t["ms"] - t["bound_ms"]))
        order.append((row["name"], excess))
    return sorted(order, key=lambda kv: -kv[1])


def loss_and_grads(trainer, batch, seed):
    """Loss parts and the gradient of every trained tensor of one batch,
    the draws from a generator seeded ``seed`` (no update)."""
    import torch

    from spurfies_tpu_torch.train.optim import flatten

    gen = torch.Generator(device=trainer.device).manual_seed(seed)
    tp = trainer.state.params
    leaves = flatten({k: tp[k] for k in TRAINED})
    loss, parts = trainer.loss_fn(tp, trainer.bundle, batch,
                                  trainer.state.step, gen)
    grads = torch.autograd.grad(loss, leaves)
    names = [f"{k}[{i}]" for k in TRAINED for i in range(len(flatten(tp[k])))]
    return ({k: float(v.detach()) for k, v in parts.items()},
            dict(zip(names, grads)))


def compare_grads(parts_k, grads_k, parts_p, grads_p):
    """One batch's loss parts and gradients through the kernels against
    the plain versions (same batch, same draws, bf16 on both sides).

    The kernels' per-point sums agree with the plain ones to a bf16 ulp
    (phase 4), but the sampler's beta bisection and the top-W colour
    selection make discrete choices on them, so a few rays place or weigh
    their samples elsewhere, and every loss and gradient is a sum over
    the rays.  Limits: each loss part within 1e-3 relative (+ 1e-6), each
    gradient within 1e-2 relative L2: room for a few of the ~830 rays to
    move (read on the H100: 8.6e-7 and 8.2e-4, no ray moved).  Returns the
    worst readings."""
    import torch

    worst_part = max(abs(parts_k[k] - parts_p[k]) / (abs(parts_p[k]) + 1e-6)
                     for k in parts_p)
    rel = {k: float(torch.linalg.vector_norm(grads_k[k] - grads_p[k])
                    / (torch.linalg.vector_norm(grads_p[k]) + 1e-30))
           for k in grads_p}
    log(f"  loss parts: worst relative difference {worst_part:.3e}; "
        f"gradients, relative L2: " + ", ".join(f"{k} {v:.2e}"
                                                for k, v in rel.items()))
    for k, g in grads_k.items():
        if not bool(torch.isfinite(g).all()):
            fail(f"gradient {k} through the kernels is not finite")
    if worst_part > 1e-3:
        fail(f"loss parts differ by {worst_part:.3e} relative")
    bad = {k: v for k, v in rel.items() if v > 1e-2}
    if bad:
        fail(f"gradients differ beyond 1e-2 relative L2: {bad}")
    return worst_part, max(rel.values())


def syncs_in(fn):
    """The host syncs that ``torch.cuda.set_sync_debug_mode("warn")``
    reports while ``fn()`` runs (their messages)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # a sync reads "called a synchronizing CUDA operation"; the mode's own
    # notice ("... is a prototype feature and does not yet detect all
    # synchronizing operations") is none
    return [str(w.message) for w in caught
            if "synchroniz" in str(w.message).lower()
            and "prototype" not in str(w.message)]


def count_host_syncs(trainer, steps):
    """Host syncs of ``steps`` training steps; returns (count, first
    message).  A ``.item()`` read first shows that the count sees one."""
    import torch

    probe = torch.ones((), device=trainer.device)
    if not syncs_in(lambda: probe.item()):
        fail("the sync debug mode does not report a .item() read")

    def steps_fn():
        for _ in range(steps):
            trainer.train_step(trainer.bundle, trainer.state,
                               trainer.generator)

    msgs = syncs_in(steps_fn)
    return len(msgs), (msgs[0] if msgs else "")


def masked_psnr(trainer, view):
    import torch

    from spurfies_tpu_torch.core.metrics import psnr

    out = trainer.render_image(view["uv"], view["pose"], view["intrinsics"])
    return float(psnr(torch.as_tensor(out["rgb_values"]),
                      torch.as_tensor(view["rgb"]),
                      torch.as_tensor(view["mask"])))


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: needs PyTorch", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port "
              "on a GPU and has nothing to report without one",
              file=sys.stderr)
        return 2
    import numpy as np

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from spurfies_tpu_torch.config import Config, apply_overrides
        from spurfies_tpu_torch.convert.from_jax import PRIOR_ASSET
        from spurfies_tpu_torch.core.metrics import psnr
        from spurfies_tpu_torch.data.synthetic import (
            make_dust3r_like_scene,
            make_synthetic_scene,
        )
        from spurfies_tpu_torch.model import field, renderer
        from spurfies_tpu_torch.ops import cuda_build, pair_mlp
        from spurfies_tpu_torch.ops.pair_mlp import _prep_layers
        from spurfies_tpu_torch.train.trainer import Trainer, make_render_fn
    except ImportError as e:
        print(f"chip_smoke: run it from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2

    # --- 1. device ---
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    device_name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {device_name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    # --- 2. build ---
    t0 = time.perf_counter()
    secs = cuda_build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s wall "
        + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items()))
    for src in cuda_build.SOURCES:
        path = cuda_build.BUILD_DIR / f"{src}.log"
        if path.exists():
            for line in path.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {src}: {line.strip()}")

    # --- 3. scenes ---
    cfg = Config()
    prior_path = PRIOR_ASSET
    t0 = time.perf_counter()
    pts_a, cols_a, views_a = make_dust3r_like_scene()
    pts_b, cols_b, views_b = make_synthetic_scene(
        n_points=40000, n_views=3, img_res=(192, 256), radius=0.8,
        cam_dist=2.4, seed=1)
    scenes = {}
    for tag, pts, cols, views, seed in (("dust3r_like", pts_a, cols_a,
                                         views_a, 0),
                                        ("dense_sphere", pts_b, cols_b,
                                         views_b, 1)):
        scene, tp, frozen = setup_scene(pts, cols, cfg, prior_path, seed,
                                        dev)
        view = {"uv": views["uv"], "pose": views["pose"][0],
                "intrinsics": views["intrinsics"][0],
                "rgb": views["rgb"][0], "mask": views["mask"][0]}
        packed = 0 < scene.table.n_points <= 2 ** 15
        scenes[tag] = (scene, tp, frozen, view, packed)
        log(f"scene {tag}: {scene.points.shape[0]} points, qcap "
            f"{scene.spec.qcap}, K1 variant {'packed' if packed else 'exact'}")
    torch.cuda.synchronize()
    log(f"scenes built in {time.perf_counter() - t0:.2f} s")
    if scenes["dust3r_like"][4] is not True or scenes["dense_sphere"][4]:
        fail("scene sizes do not select both K1 variants")

    # --- 4. kernels against their plain versions ---
    results = {}
    chunk_rays = {}
    n_occ = {}
    for tag, (scene, tp, frozen, view, packed) in scenes.items():
        prior = _prep_layers(frozen, torch.bfloat16)
        prior_f32 = _prep_layers(frozen, torch.float32)
        cam, dirs, n_occ[tag], sel = first_chunk(scene, view, cfg, dev)
        chunk_rays[tag] = sel
        with torch.no_grad():
            inp = kernel_inputs(scene, tp, prior, cam, dirs, cfg)
        k1 = "K1 select_knn packed" if packed else "K1 select_knn exact"
        radius = scene.spec.radius(scene.table.r)
        check_k1(k1 + " (probe)", k1_args(*inp["probe_k1"], scene,
                                          cfg.model.k, packed), 20)
        results[k1] = check_k1(k1 + " (shading)", k1_args(
            *inp["shade_k1"], scene, cfg.model.k, packed), 20)
        if tag == "dust3r_like":
            results["K2 pair_sdf_value_agg"] = check_pair(
                "K2 pair_sdf_value_agg", pair_mlp.pair_sdf_value_agg,
                pair_mlp.pair_sdf_value_agg_ref, inp["k2"], prior,
                prior_f32, cfg.model.rbf, 10)
            results["K3 pair_sdf_aggregate"] = check_pair(
                "K3 pair_sdf_aggregate", pair_mlp.pair_sdf_aggregate,
                pair_mlp.pair_sdf_aggregate_ref, inp["k3"], prior,
                prior_f32, cfg.model.rbf, 5)
            for label, key, what, reps in (
                    ("K6b pair_sdf_rows_value", "k6b", "probe", 10),
                    ("K6a pair_sdf_rows_grad", "k6a", "shading", 5),
                    ("K7a pair_sdf_value_and_input_grad", "k7",
                     "shading pairs, pair_budget_frac=0.625", 5)):
                args, needed = inp[key]
                fn = label.split()[1]
                results[label] = check_rows(
                    f"{label} ({what})", getattr(pair_mlp, fn),
                    getattr(pair_mlp, f"{fn}_ref"), args, prior,
                    prior_f32, reps, radius, int(needed.sum()))
            # K6a runs K3's sweeps on the same shading pairs: on every
            # valid pair its r_lat is K3's, bit for bit
            with torch.no_grad():
                _, _, r_lat = pair_mlp.pair_sdf_aggregate(
                    *inp["k3"], prior, cfg.model.rbf)
                (g, xr), valid = inp["k6a"]
                r6 = pair_mlp.pair_sdf_rows_grad(g, xr, prior)[1]
                same = torch.equal(r6[valid, :32].to(torch.bfloat16),
                                   r_lat[valid])
            log(f"K6a r_lat vs K3 r_lat on the {int(valid.sum())} valid "
                f"shading pairs: {'bit-equal' if same else 'DIFFERENT'}")
            if not same:
                fail("K6a and K3 disagree on the same pairs")
            del r_lat, r6
        del inp
        torch.cuda.empty_cache()

    # --- 5. render path ---
    render_image = make_render_fn(cfg, device="cuda")
    zero_counts()
    outs, walls = {}, {}
    for tag, (scene, tp, frozen, view, _) in scenes.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[tag] = render_image(tp, scene, frozen, view["uv"], view["pose"],
                                 view["intrinsics"])
        torch.cuda.synchronize()
        walls[tag] = time.perf_counter() - t0
    launches_render = read_counts()
    log(f"render path launches: {launches_render}")

    iters = cfg.model.ray_sampler.max_total_iters
    chunks = {t: math.ceil(n_occ[t] / CHUNK) for t in scenes}
    expect = dict({k: 0 for k in launches_render},
                  select_knn_packed=(iters + 1) * chunks["dust3r_like"],
                  select_knn_exact=(iters + 1) * chunks["dense_sphere"],
                  pair_sdf_value_agg=iters * sum(chunks.values()),
                  pair_sdf_aggregate=sum(chunks.values()))
    if launches_render != expect:
        fail(f"launch counts {launches_render} != expected {expect}")
    for tag, out in outs.items():
        n = len(scenes[tag][3]["uv"])
        for key, v in out.items():
            if v.shape[0] != n or not np.isfinite(v.astype(np.float64)).all():
                fail(f"{tag}: output {key} not finite / wrong shape")
        if out["ray_mask"].sum() < 0.1 * n:
            fail(f"{tag}: almost no ray hit the cloud")
        view = scenes[tag][3]
        m = torch.as_tensor(view["mask"])
        p = float(psnr(torch.as_tensor(out["rgb_values"]),
                       torch.as_tensor(view["rgb"]), m))
        log(f"render {tag}: {n} rays ({n_occ[tag]} occupied, "
            f"{chunks[tag]} chunks) in {walls[tag]:.3f} s = "
            f"{n / walls[tag]:.1f} rays/s; hit rays {int(out['ray_mask'].sum())}"
            f"; masked PSNR vs the analytic view {p:.2f} dB (random colour "
            "MLPs)")

    # the same view with model.fused_agg=false: K6b probes, K6a shades
    scene, tp, frozen, view, _ = scenes["dust3r_like"]
    cfg_unfused = apply_overrides(cfg, OPTIONS["unfused"][0])
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_u = make_render_fn(cfg_unfused, device="cuda")(
        tp, scene, frozen, view["uv"], view["pose"], view["intrinsics"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_unfused = read_counts()
    expect = expected_counts(
        launches_unfused, {"select_knn": iters + 1,
                           "pair_sdf_rows_value": iters,
                           "pair_sdf_rows_grad": 1},
        chunks["dust3r_like"], "select_knn_packed")
    if launches_unfused != expect:
        fail(f"fused_agg=false launch counts {launches_unfused} != "
             f"expected {expect}")
    n = len(view["uv"])
    for key, v in out_u.items():
        if v.shape[0] != n or not np.isfinite(v.astype(np.float64)).all():
            fail(f"fused_agg=false: output {key} not finite / wrong shape")
    p = float(psnr(torch.as_tensor(out_u["rgb_values"]),
                   torch.as_tensor(view["rgb"]), torch.as_tensor(view["mask"])))
    log(f"render dust3r_like, fused_agg=false: {n} rays in {wall:.3f} s = "
        f"{n / wall:.1f} rays/s; hit rays {int(out_u['ray_mask'].sum())} "
        f"(fused: {int(outs['dust3r_like']['ray_mask'].sum())}); masked PSNR "
        f"{p:.2f} dB; launches {launches_unfused}")
    del out_u

    # the same view with field.FUSED_COLOR: K8a colours each chunk
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with fused_color_set(True):
        out_c = make_render_fn(cfg, device="cuda")(
            tp, scene, frozen, view["uv"], view["pose"], view["intrinsics"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_colour_render = read_counts()
    expect = expected_counts(
        launches_colour_render, {"select_knn": iters + 1,
                                 "pair_sdf_value_agg": iters,
                                 "pair_sdf_aggregate": 1,
                                 "fused_color_fwd": 1},
        chunks["dust3r_like"], "select_knn_packed")
    if launches_colour_render != expect:
        fail(f"FUSED_COLOR render launch counts {launches_colour_render} != "
             f"expected {expect}")
    for key, v in out_c.items():
        if v.shape[0] != n or not np.isfinite(v.astype(np.float64)).all():
            fail(f"FUSED_COLOR render: output {key} not finite / wrong shape")
    p = float(psnr(torch.as_tensor(out_c["rgb_values"]),
                   torch.as_tensor(view["rgb"]), torch.as_tensor(view["mask"])))
    log(f"render dust3r_like, FUSED_COLOR: {n} rays in {wall:.3f} s = "
        f"{n / wall:.1f} rays/s; hit rays {int(out_c['ray_mask'].sum())}; "
        f"masked PSNR {p:.2f} dB (random colour MLPs); launches "
        f"{launches_colour_render}")
    del out_c

    # --- 6. one chunk through the plain versions, on the card ---
    scene, tp, frozen, view, _ = scenes["dust3r_like"]
    sel = chunk_rays["dust3r_like"].cpu().numpy()
    inputs = {"uv": torch.as_tensor(view["uv"][sel], device=dev)[None],
              "pose": torch.as_tensor(view["pose"], device=dev)[None],
              "intrinsics": torch.as_tensor(view["intrinsics"],
                                            device=dev)[None]}
    params = {"frozen": _prep_layers(frozen, torch.bfloat16), "train": tp}
    with torch.no_grad():
        out_k = renderer.render_rays(params, scene, inputs, cfg.model,
                                     train=False, iters=iters)
        with plain_versions():
            out_p = renderer.render_rays(params, scene, inputs, cfg.model,
                                         train=False, iters=iters)
    worst = compare_chunk(out_k, out_p)
    log(f"chunk of {len(sel)} rays, kernels vs plain versions, per-ray "
        f"max abs differences: {json.dumps(worst)}")
    for label, ov in (("fused_agg=false", OPTIONS["unfused"][0]),
                      ("render_budget_frac=0.9",
                       ["model.render_budget_frac=0.9"])):
        mcfg = apply_overrides(cfg, ov).model
        with torch.no_grad():
            out_k = renderer.render_rays(params, scene, inputs, mcfg,
                                         train=False, iters=iters)
            with plain_versions():
                out_p = renderer.render_rays(params, scene, inputs, mcfg,
                                             train=False, iters=iters)
        worst = compare_chunk(out_k, out_p)
        log(f"chunk, {label}, kernels vs plain versions: "
            f"{json.dumps(worst)}")
    # FUSED_COLOR: the chunk through K8a, recording its colour inputs
    chunk = {}
    with fused_color_set(True), torch.no_grad():
        seen = capture(lambda: chunk.update(out=renderer.render_rays(
            params, scene, inputs, cfg.model, train=False, iters=iters)),
            kernel_sites() + [(field, "aggregate_color", None)])
        with plain_versions():
            out_p = renderer.render_rays(params, scene, inputs, cfg.model,
                                         train=False, iters=iters)
    out_k = chunk.pop("out")
    worst = compare_chunk(out_k, out_p)
    log(f"chunk, FUSED_COLOR, kernels vs plain versions: {json.dumps(worst)}")
    if len(seen.get("fused_color_fwd", ())) != 1:
        fail("FUSED_COLOR chunk: K8a was not launched once")
    results["K8a fused_color_fwd"] = check_k8a(
        "K8a fused_color_fwd (first chunk's colour)",
        seen["fused_color_fwd"][0], 5)
    colour_render = colour_paths(seen["aggregate_color"][0], 3)
    del seen

    # --- 7. where the time goes (the dust3r_like scene of phase 6) ---
    prof = profile_render(render_image, scene, tp, frozen, view)
    log(f"profile: {json.dumps(prof)}")

    del render_image, outs, out_k, out_p
    torch.cuda.empty_cache()

    # --- 8-10. training: every launch of one step against its plain
    # version, one batch through both, host syncs, the timed path ---
    _, _, prior_a, view_a, _ = scenes["dust3r_like"]
    t0 = time.perf_counter()
    trainer = Trainer(cfg, pts_a, cols_a, views_a, device="cuda")
    trainer.load_frozen(prior_a)
    torch.cuda.synchronize()
    log(f"trainer dust3r_like built in {time.perf_counter() - t0:.2f} s")
    psnr0 = masked_psnr(trainer, view_a)
    best, launches_train, _ = train_path("dust3r_like", trainer, PER_STEP,
                                         TRAIN_WARMUP, TRAIN_STEPS,
                                         TRAIN_WINDOW)
    results["K4 pair_sdf_aggregate_bwd"] = best["pair_sdf_aggregate_bwd"]
    results["K5 scatter_add_rows"] = best["scatter_add_rows"]
    default_best = {k: best[k] for k in ("select_knn", "pair_sdf_value_agg",
                                         "pair_sdf_aggregate")}
    del best
    psnr1 = masked_psnr(trainer, view_a)
    log(f"view 0 masked PSNR vs the analytic view: {psnr0:.2f} dB before "
        f"training, {psnr1:.2f} dB after {TRAIN_WARMUP + TRAIN_STEPS + 3} "
        "steps")

    # a few steps on the dense sphere: N > 2**15, the exact K1
    dense = Trainer(cfg, pts_b, cols_b, views_b, device="cuda")
    dense.load_frozen(prior_a)
    dense_hist = []
    zero_counts()
    dense.run(DENSE_STEPS, window=DENSE_STEPS,
              callback=lambda s_, m: dense_hist.append(m))
    launches_dense = read_counts()
    expect = expected_counts(launches_dense, PER_STEP, DENSE_STEPS,
                             "select_knn_exact")
    log(f"train dense_sphere: {dense.scene.points.shape[0]} points, "
        f"{DENSE_STEPS} steps, loss {dense_hist[-1]['loss']:.5g}; launches "
        f"{launches_dense}")
    if launches_dense != expect or not np.isfinite(dense_hist[-1]["loss"]):
        fail(f"dense_sphere training: launches {launches_dense} != {expect} "
             "or a non-finite loss")
    del dense
    torch.cuda.empty_cache()

    # --- 11. where a training step's time goes ---
    tprof = profiled(lambda: trainer.run(PROFILE_STEPS,
                                         window=PROFILE_STEPS))
    tprof["steps"] = PROFILE_STEPS
    tprof["ms_per_step"] = tprof["profiled_wall_ms"] / PROFILE_STEPS
    log(f"train profile: {json.dumps(tprof)}")

    del trainer
    torch.cuda.empty_cache()

    # --- 12. the two option paths ---
    option_best, launches_options = {}, []
    for tag, (ov, per_step) in OPTIONS.items():
        tr = Trainer(apply_overrides(cfg, ov), pts_a, cols_a, views_a,
                     device="cuda")
        tr.load_frozen(prior_a)
        best, counts, _ = train_path(f"dust3r_like {tag}", tr, per_step,
                                     OPTION_WARMUP, OPTION_STEPS,
                                     OPTION_STEPS)
        option_best.update(best)
        launches_options.append(counts)
        oprof = profiled(lambda: tr.run(PROFILE_STEPS, window=PROFILE_STEPS))
        oprof["ms_per_step"] = oprof["profiled_wall_ms"] / PROFILE_STEPS
        log(f"train profile {tag}: {json.dumps(oprof)}")
        del tr
        torch.cuda.empty_cache()

    # --- 13. pair-MLP microbenchmark: K7b's path ---
    rng = np.random.default_rng(0)
    u = torch.as_tensor(np.concatenate(
        [rng.normal(0, 0.3, (MICRO_PAIRS, 32)),
         rng.normal(0, 0.03, (MICRO_PAIRS, 3))], -1).astype(np.float32),
        device=dev)
    prior = _prep_layers(prior_a, torch.bfloat16)
    prior_f32 = _prep_layers(prior_a, torch.float32)
    zero_counts()
    with torch.no_grad():
        pair_mlp.pair_sdf_value(u, prior)
        pair_mlp.pair_sdf_value_and_input_grad(u, prior)
    torch.cuda.synchronize()
    launches_micro = read_counts()
    expect = expected_counts(launches_micro, {"pair_sdf_value": 1,
                                              "pair_sdf_value_and_input_grad":
                                              1}, 1, None)
    if launches_micro != expect:
        fail(f"microbench launch counts {launches_micro} != {expect}")
    # every random pair is held (radius inf): none is masked
    results["K7b pair_sdf_value"] = check_rows(
        f"K7b pair_sdf_value (microbench, {MICRO_PAIRS} pairs)",
        pair_mlp.pair_sdf_value, pair_mlp.pair_sdf_value_ref, (u,), prior,
        prior_f32, 20, math.inf)
    check_rows(
        f"K7a pair_sdf_value_and_input_grad (microbench, {MICRO_PAIRS} "
        "pairs)", pair_mlp.pair_sdf_value_and_input_grad,
        pair_mlp.pair_sdf_value_and_input_grad_ref, (u,), prior, prior_f32,
        10, math.inf)
    del u, prior_f32

    # --- 14. the fused colour's training path, FUSED_COLOR set around it
    # (its render parts ran after phases 5 and 6) ---
    with fused_color_set(True):
        tr = Trainer(cfg, pts_a, cols_a, views_a, device="cuda")
        tr.load_frozen(prior_a)
        colour_best, launches_colour_train, _ = train_path(
            "dust3r_like fused_color", tr, FUSED_COLOR_STEP, OPTION_WARMUP,
            OPTION_STEPS, OPTION_STEPS)
        cprof = profiled(lambda: tr.run(PROFILE_STEPS, window=PROFILE_STEPS))
        cprof["ms_per_step"] = cprof["profiled_wall_ms"] / PROFILE_STEPS
        log(f"train profile fused_color: {json.dumps(cprof)}")
        seen = capture_step(tr, [(field, "aggregate_color", None)])
        colour_train = colour_paths(seen["aggregate_color"][0], 10)
        del seen, tr
    torch.cuda.empty_cache()

    # --- 15. report ---
    render_runs = (launches_render, launches_unfused, launches_colour_render)
    train_runs = (launches_train, launches_dense, *launches_options,
                  launches_colour_train)
    results["K8b fused_color_bwd"] = colour_best["fused_color_bwd"]

    def total(runs, key):
        return sum(c[key] for c in runs)

    launches = {k: total(render_runs + train_runs, k) + launches_micro[k]
                for k in launches_render}
    # the training shapes' times, beside phase 4's eval-chunk times
    train_shape = {"K1 select_knn packed": default_best["select_knn"],
                   "K2 pair_sdf_value_agg": default_best["pair_sdf_value_agg"],
                   "K3 pair_sdf_aggregate": default_best["pair_sdf_aggregate"],
                   "K6a pair_sdf_rows_grad": option_best["pair_sdf_rows_grad"],
                   "K6b pair_sdf_rows_value":
                   option_best["pair_sdf_rows_value"],
                   "K7a pair_sdf_value_and_input_grad":
                   option_best["pair_sdf_value_and_input_grad"],
                   "K8a fused_color_fwd": colour_best["fused_color_fwd"]}
    # the colour path through aggregate_color, fused and dense (FUSED_COLOR
    # off: PyTorch's products, not a library call of the same function)
    colour_path = {"render_chunk": colour_render, "train": colour_train}
    rows = []
    meta = {
        "K1 select_knn packed": ("select_knn_packed",
                                 "spurfies_tpu_torch/csrc/select_knn.cu",
                                 "spurfies_tpu/ops/pallas_select.py:69"),
        "K1 select_knn exact": ("select_knn_exact",
                                "spurfies_tpu_torch/csrc/select_knn.cu",
                                "spurfies_tpu/ops/pallas_select.py:33"),
        "K2 pair_sdf_value_agg": ("pair_sdf_value_agg",
                                  "spurfies_tpu_torch/csrc/pair_mlp.cu",
                                  "spurfies_tpu/ops/pallas_mlp.py:640"),
        "K3 pair_sdf_aggregate": ("pair_sdf_aggregate",
                                  "spurfies_tpu_torch/csrc/pair_mlp.cu",
                                  "spurfies_tpu/ops/pallas_mlp.py:576"),
        "K4 pair_sdf_aggregate_bwd": ("pair_sdf_aggregate_bwd",
                                      "spurfies_tpu_torch/csrc/agg_bwd.cu",
                                      "spurfies_tpu/ops/pallas_mlp.py:683"),
        "K5 scatter_add_rows": ("scatter_add_rows",
                                "spurfies_tpu_torch/csrc/scatter_rows.cu",
                                "spurfies_tpu/ops/pallas_scatter.py:37"),
        "K6a pair_sdf_rows_grad": ("pair_sdf_rows_grad",
                                   "spurfies_tpu_torch/csrc/pair_mlp.cu",
                                   "spurfies_tpu/ops/pallas_mlp.py:195"),
        "K6b pair_sdf_rows_value": ("pair_sdf_rows_value",
                                    "spurfies_tpu_torch/csrc/pair_mlp.cu",
                                    "spurfies_tpu/ops/pallas_mlp.py:260"),
        "K7a pair_sdf_value_and_input_grad": (
            "pair_sdf_value_and_input_grad",
            "spurfies_tpu_torch/csrc/pair_mlp.cu",
            "spurfies_tpu/ops/pallas_mlp.py:51"),
        "K7b pair_sdf_value": ("pair_sdf_value",
                               "spurfies_tpu_torch/csrc/pair_mlp.cu",
                               "spurfies_tpu/ops/pallas_mlp.py:146"),
        "K8a fused_color_fwd": ("fused_color_fwd",
                                "spurfies_tpu_torch/csrc/color_mlp.cu",
                                "spurfies_tpu/ops/pallas_color.py:92"),
        "K8b fused_color_bwd": ("fused_color_bwd",
                                "spurfies_tpu_torch/csrc/color_mlp.cu",
                                "spurfies_tpu/ops/pallas_color.py:108"),
    }
    # launches: the render paths', the training paths' and the
    # microbenchmark's runs, each with the counters set to 0 just before it
    for label, (key, src, rep) in meta.items():
        r = results[label]
        row = {"name": label, "route": "cuda", "source": src,
               "replaces": rep, "launches": launches[key],
               "launches_render": total(render_runs, key),
               "launches_train": total(train_runs, key),
               "launches_microbench": launches_micro[key],
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        if label in train_shape:
            t = train_shape[label]
            row["train_shape"] = {k: t[k] for k in (
                "rows", "ms", "plain_ms", "bound_ms", "bound_all_rows_ms",
                "max_abs_err") if k in t}
        if label.startswith("K8"):
            row["colour_path_ms"] = colour_path
        if "atomic_adds" in r:
            row["atomic_adds"] = r["atomic_adds"]
        rows.append(row)
        if launches[key] == 0:
            fail(f"{label} was not launched on the main path")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"redesign_order": redesign_order(rows)}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
