"""The training step and the full-image renderer: the plain version of the
port's ``train/trainer.py`` (reference VolOpt, ``train.py:21-564``) without
ray sharding.  ``make_train_step`` builds ``loss_fn`` and ``train_step``;
``calibrate_budgets`` works out the auto ray and probe budgets on the host;
``make_render_fn`` renders a full image for evaluation.
"""

import numpy as np
import torch

from benchmark.plain.config import Config
from benchmark.plain.core.cameras import get_camera_params
from benchmark.plain.core.metrics import psnr as psnr_fn
from benchmark.plain.faults import FAULTS
from benchmark.plain.model.local_loss import (
    find_surface_depth,
    local_feature_loss,
)
from benchmark.plain.model.losses import total_loss
from benchmark.plain.model.renderer import (
    coarse_ray_occupancy,
    pseudo_sdf_loss,
    render_rays,
    tv_loss,
)
from benchmark.plain.ops.pair_mlp import _prep_layers
from benchmark.plain.ops.voxel_grid import fine_spec
from benchmark.plain.train.optim import flatten

_KEEP = ("rgb_values", "depth_values", "normal_map", "acc", "ray_mask")


def make_render_fn(cfg: Config, device):
    """Return ``render_image(tp, scene, prior, uv, pose, intrinsics)``.

    It renders ``uv [n, 2]`` of one view in ``train.render_chunk``-ray
    slices (the chunk adapts down to the image, in multiples of 128), with
    ``train.eval_iters`` sampler iterations (0: the sampler's
    ``max_total_iters``), and returns numpy ``rgb_values [n, 3]``,
    ``depth_values [n, 1]``, ``normal_map [n, 3]``, ``acc [n, 1]`` and
    ``ray_mask [n]``.  With ``train.render_skip_empty`` a whole-image
    occupancy pass picks the rays that can hit the cloud; only those are
    rendered, the rest get the exact miss defaults.  ``prior`` is the
    prepared frozen prior (``ops.pair_mlp._prep_layers``)."""
    mcfg = cfg.model
    chunk = cfg.train.render_chunk
    iters = cfg.train.eval_iters or mcfg.ray_sampler.max_total_iters
    align = 128

    def _inputs(uv_chunk, pose, intrinsics):
        return {
            "uv": torch.as_tensor(uv_chunk, dtype=torch.float32,
                                  device=device)[None],
            "pose": pose[None],
            "intrinsics": intrinsics[None],
        }

    def _empty(n):
        rgb = np.zeros((n, 3), np.float32)
        if mcfg.white_bkgd:
            rgb[:] = np.asarray(mcfg.bg_color, np.float32)
        return {
            "rgb_values": rgb,
            "depth_values": np.ones((n, 1), np.float32),
            "normal_map": np.zeros((n, 3), np.float32),
            "acc": np.zeros((n, 1), np.float32),
            "ray_mask": np.zeros((n,), bool),
        }

    @torch.no_grad()
    def render_image(tp, scene, prior, uv, pose, intrinsics,
                     pick_chunks=None):
        """``pick_chunks(n_chunks) -> chunk ids``: render only those chunks
        (of the occupied rays with ``render_skip_empty``); returns ``(rays
        [m], outputs [m, ...])`` of theirs, a padding ray -1."""
        pose = torch.as_tensor(pose, dtype=torch.float32, device=device)
        intrinsics = torch.as_tensor(intrinsics, dtype=torch.float32,
                                     device=device)
        params = {"frozen": prior, "train": tp}
        uv = np.asarray(uv, dtype=np.float32)
        n = uv.shape[0]
        eff = min(chunk, -(-n // align) * align)
        pad = (-n) % eff
        uv_p = np.pad(uv, ((0, pad), (0, 0)))

        def rendered(chunks):
            outs = []
            for c in chunks:
                o = render_rays(params, scene, _inputs(c, pose, intrinsics),
                                mcfg, train=False, iters=iters)
                outs.append({k: o[k].reshape(eff, -1).cpu().numpy()
                             for k in _KEEP})
            like = _empty(1)
            return {k: np.concatenate([o[k] for o in outs]).reshape(
                (-1,) + like[k].shape[1:]).astype(like[k].dtype)
                for k in _KEEP}

        if pick_chunks is not None:
            rays = _chunk_rays(uv_p, pose, intrinsics, scene, n, eff)
            picked = [rays[i] for i in pick_chunks(len(rays))]
            full = rendered([uv_p[np.maximum(r, 0)] for r in picked])
            return np.concatenate(picked), full

        if cfg.train.render_skip_empty and scene.occ_fine is not None:
            inp = _inputs(uv_p, pose, intrinsics)
            dirs_b, cam_b = get_camera_params(inp["uv"], inp["pose"],
                                              inp["intrinsics"])
            dirs = dirs_b.reshape(-1, 3)
            cam = torch.broadcast_to(cam_b[:, None, :],
                                     dirs_b.shape).reshape(-1, 3)
            occ = coarse_ray_occupancy(cam, dirs, scene,
                                       mcfg.ray_sampler).cpu().numpy()[:n]
            out = _empty(n)
            sel = np.nonzero(occ)[0]
            if len(sel) == 0:
                return out
            sel_p = np.concatenate(
                [sel, np.zeros((-len(sel)) % eff, dtype=sel.dtype)])
            full = rendered([uv_p[sel_p[i:i + eff]]
                             for i in range(0, len(sel_p), eff)])
            for k in out:
                out[k][sel] = full[k][:len(sel)]
            return out

        full = rendered([uv_p[i:i + eff] for i in range(0, n + pad, eff)])
        return {k: v[:n] for k, v in full.items()}

    def _chunk_rays(uv_p, pose, intrinsics, scene, n, eff):
        """The ray indices of each chunk, as ``render_image`` forms them
        (the occupied rays with ``render_skip_empty``); the padding that
        renders ray 0 again is -1 here."""
        if cfg.train.render_skip_empty and scene.occ_fine is not None:
            inp = _inputs(uv_p, pose, intrinsics)
            dirs_b, cam_b = get_camera_params(inp["uv"], inp["pose"],
                                              inp["intrinsics"])
            dirs = dirs_b.reshape(-1, 3)
            cam = torch.broadcast_to(cam_b[:, None, :],
                                     dirs_b.shape).reshape(-1, 3)
            occ = coarse_ray_occupancy(cam, dirs, scene,
                                       mcfg.ray_sampler).cpu().numpy()[:n]
            sel = np.nonzero(occ)[0]
            sel = np.concatenate(
                [sel, np.full((-len(sel)) % eff, -1, dtype=sel.dtype)])
        else:
            sel = np.arange(len(uv_p))
            sel[n:] = -1
        return [sel[i:i + eff] for i in range(0, len(sel), eff)]

    return render_image


def prepare_prior(frozen):
    """The frozen prior as ``render_rays`` takes it."""
    return _prep_layers(frozen)


def calibrate_budgets(scene, views, cfg: Config):
    """The auto budgets from the scene's fine-bitmap occupancy over the
    train views (host numpy).

    Returns ``(ray_frac, probe_frac)``: the worst view's share of rays that
    hit an occupied fine cell at some uniform z, plus a 4-sigma binomial
    margin for a num_pixels batch; and the worst view's mean per-ray share
    of occupied uniform samples over the rays the ray budget keeps, plus 4
    standard errors of that mean.  Both capped at 1.0 (dense)."""
    occ0 = scene.occ_fine.cpu().numpy().reshape(-1)
    uv_all = np.asarray(views["uv"], dtype=np.float32)
    n_px = uv_all.shape[0]
    sub = np.random.RandomState(0).choice(n_px, size=min(8192, n_px),
                                          replace=False)
    uv = uv_all[sub]
    worst_ray = 0.0
    worst_probe = 0.0
    ray_budget_on = 0 < cfg.model.ray_budget_frac < 1 or (
        cfg.model.ray_budget_frac < 0)
    for v in range(np.asarray(views["pose"]).shape[0]):
        samp = _samples_occupied_np(occ0, scene.spec, cfg.model.ray_sampler,
                                    uv, np.asarray(views["pose"][v]),
                                    np.asarray(views["intrinsics"][v]))
        ray_occ = samp.any(axis=1)
        worst_ray = max(worst_ray, float(ray_occ.mean()))
        per_ray = samp.mean(axis=1)
        kept = per_ray[ray_occ] if ray_budget_on else per_ray
        if kept.size:
            n_kept = max(int(cfg.train.num_pixels
                             * (float(ray_occ.mean()) if ray_budget_on
                                else 1.0)), 1)
            se = float(kept.std()) / np.sqrt(n_kept)
            worst_probe = max(worst_probe, float(kept.mean()) + 4.0 * se)
    sigma = np.sqrt(worst_ray * (1.0 - worst_ray)
                    / max(cfg.train.num_pixels, 1))
    return min(1.0, worst_ray + 4.0 * sigma), min(1.0, worst_probe)


def _samples_occupied_np(occ0, spec, scfg, uv, pose, K):
    """Per (ray, uniform z sample) fine-bitmap occupancy ``[P, Z]`` bool."""
    fs = fine_spec(spec)
    dims = np.asarray(fs.dims)
    lo = np.asarray(fs.lo, dtype=np.float32)
    pose = np.asarray(pose, dtype=np.float32)
    K = np.asarray(K, dtype=np.float32)
    uv = np.asarray(uv, dtype=np.float32)
    z = np.linspace(scfg.near, scfg.far, scfg.n_samples_eval,
                    dtype=np.float32)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy, sk = K[0, 2], K[1, 2], K[0, 1]
    x, y = uv[:, 0], uv[:, 1]
    # pinhole + skew lift at depth 1 (core.cameras.lift)
    xl = (x - cx + cy * sk / fy - sk * y / fy) / fx
    yl = (y - cy) / fy
    d = np.stack([xl, yl, np.ones_like(xl)], -1) @ pose[:3, :3].T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts = pose[:3, 3] + z[None, :, None] * d[:, None, :]      # [P, Z, 3]
    ijk = np.floor((pts - lo) / np.float32(fs.cell_size)).astype(np.int64)
    in_r = np.all((ijk >= 0) & (ijk < dims), axis=-1)
    ijk = np.clip(ijk, 0, dims - 1)
    lin = (ijk[..., 0] * dims[1] + ijk[..., 1]) * dims[2] + ijk[..., 2]
    return (occ0[lin] != 0) & in_r


def _first_half(out, batch):
    """The fault ``half_batch``: the first half of the rays only."""
    n = batch["gt"]["rgb"].shape[0]
    out = {k: (v[:n // 2] if torch.is_tensor(v) and v.ndim and
               v.shape[0] == n else v) for k, v in out.items()}
    gt = {k: v[:n // 2] for k, v in batch["gt"].items()}
    return out, dict(batch, gt=gt)


def make_train_step(cfg: Config, optimizer, use_local: bool = False):
    """``(loss_fn, train_step)`` for ``cfg``.

    * ``loss_fn(tp, bundle, batch, step, draws)`` -> ``(loss, parts)``.
      bundle: ``{"scene", "prior"}`` and, with ``use_local``, ``"local"``:
      ``{"feats", "cams", "src", "size", "center"}``; batch: ``{"inputs":
      {"uv" [1, R, 2], "pose" [1, 4, 4], "intrinsics" [1, 4, 4]}, "gt":
      {"rgb", "mask"}, "view" [1]}``; draws: the sampler's
      (``model.sampler.training_draws``).
    * ``train_step(bundle, state, batch, draws)``: one step in place on
      ``state`` (``{"params", "opt_state", "step"}``); returns its parts and
      the gradients the optimizer got, before the clip.
    """
    mcfg, lcfg = cfg.model, cfg.loss
    fast = cfg.train.fast_iters

    def loss_fn(tp, bundle, batch, step, draws):
        scene = bundle["scene"]
        params = {"frozen": bundle["prior"], "train": tp}
        out = render_rays(params, scene, batch["inputs"], mcfg, train=True,
                          iters=fast, draws=draws)
        if FAULTS["half_batch"]:
            out, batch = _first_half(out, batch)
        out["tv_loss"] = tv_loss(params, scene)
        out["pseudo_pts_loss"] = pseudo_sdf_loss(params, scene, out, mcfg)
        if use_local:
            ctx = bundle["local"]
            d_surf, surf_mask = find_surface_depth(out["sdf"], out["z_sel"],
                                                   out["valid_pt"])
            surface = out["cam_loc"] + out["ray_dirs"] * d_surf[:, None]
            v = batch["view"]
            src = ctx["src"][v][0]
            out["local_loss"] = local_feature_loss(
                surface, surf_mask & out["ray_mask"], ctx["feats"][v][0],
                ctx["feats"][src], ctx["cams"][v][0], ctx["cams"][src],
                ctx["size"], ctx["center"])
        loss, parts = total_loss(out, batch["gt"], lcfg, step=step)
        gt_rgb = batch["gt"]["rgb"].reshape(-1, 3)
        parts["psnr"] = psnr_fn(out["rgb_values"], gt_rgb)
        parts["ray_overflow"] = out["ray_budget_overflow"].to(torch.float32)
        parts["probe_overflow"] = out["probe_budget_overflow"].to(
            torch.float32)
        return loss, parts

    def train_step(bundle, state, batch, draws):
        leaves = flatten(state["params"])
        loss, parts = loss_fn(state["params"], bundle, batch, state["step"],
                              draws)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        optimizer.step(state["params"], grads, state["opt_state"])
        state["step"] += 1
        return {k: v.detach() for k, v in parts.items()}, grads

    return loss_fn, train_step
