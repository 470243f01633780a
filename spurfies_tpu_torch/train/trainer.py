"""Per-scene optimization loop and full-image renderer (port of
``spurfies_tpu/train/trainer.py``; reference VolOpt, ``train.py:21-564``).

  * ``make_train_step`` builds ``loss_fn``, ``sample_batch`` and
    ``train_step``: one step samples a view and its pixels on the card,
    renders them (``render_rays(train=True)``), adds the TV and pseudo-SDF
    terms (not for the entangled model) and, with a local bundle, the
    Vis-MVSNet feature loss, takes the gradient of every trained tensor
    and applies the guarded two-group Adam (``train.optim``).  Nothing in
    a step waits on the card, so the host runs ahead of it.
  * ``Trainer`` owns the scene, the parameters and the optimizer state,
    calibrates the auto ray/probe budgets on the host, and runs windows of
    steps, reading their metrics back once per window.
  * ``make_render_fn`` renders a full image for evaluation.

With ``train.data_parallel`` > 1 (``parallel``), every rank of the group
holds the parameters and the whole batch, renders its share of the rays and
counts its share of each loss term; one all-reduce of the flattened
gradients before the optimizer gives every rank the whole batch's gradient,
so the ranks take the same step, the unsharded one up to the order of sums.

The JAX package's ``lax.scan`` window has no counterpart: the steps of a
window are a Python loop of eagerly launched kernels.
"""

import dataclasses
import math
import warnings

import numpy as np
import torch

from spurfies_tpu_torch.config import Config
from spurfies_tpu_torch.core.cameras import get_camera_params
from spurfies_tpu_torch.core.metrics import psnr as psnr_fn
from spurfies_tpu_torch.device import resolve_device
from spurfies_tpu_torch.data.mvs_local import SRC_MAP
from spurfies_tpu_torch.model.local_loss import (
    find_surface_depth,
    local_feature_loss,
)
from spurfies_tpu_torch.model.losses import rgb_loss, total_loss
from spurfies_tpu_torch.model.networks import init_model_params
from spurfies_tpu_torch.model.neural_points import build_scene
from spurfies_tpu_torch.model.renderer import (
    cloud_anchor_loss,
    cloud_anchor_sel,
    coarse_ray_occupancy,
    fd_eikonal_loss,
    pseudo_sdf_loss,
    render_rays,
    tv_loss,
)
from spurfies_tpu_torch.ops.pair_mlp import _prep_layers
from spurfies_tpu_torch.ops.voxel_grid import fine_spec
from spurfies_tpu_torch.parallel.mesh import make_group
from spurfies_tpu_torch.train.optim import Optimizer, OptState, flatten

_KEEP = ("rgb_values", "depth_values", "normal_map", "acc", "ray_mask")


def make_render_fn(cfg: Config, device="cuda", compute_dtype=torch.bfloat16,
                   group=None):
    """Return ``render_image(tp, scene, frozen, uv, pose, intrinsics)``.

    It renders ``uv [n, 2]`` of one view in ``train.render_chunk``-ray
    slices (the chunk adapts down to the image, in multiples of 128), with
    ``train.eval_iters`` sampler iterations (0: the sampler's
    ``max_total_iters``).  It returns numpy ``rgb_values [n, 3]``,
    ``depth_values [n, 1]``, ``normal_map [n, 3]``, ``acc [n, 1]`` and
    ``ray_mask [n]``.  With ``train.render_skip_empty``
    a whole-image occupancy pass picks the rays that can hit the cloud;
    only those are rendered, the rest get the exact miss defaults.

    ``compute_dtype`` is the frozen prior's matmul dtype (bf16, as the JAX
    package's ``FUSED_MLP_DTYPE``); the colour MLPs run in bf16.  The
    entangled model (``frozen`` empty) runs its MLPs in f32.  Eval draws no
    random numbers.

    ``group`` (a :class:`parallel.mesh.RankGroup`; every rank calls):
    the chunks are the unsharded render's, rank r renders chunks r,
    r + world, ..., and one all-gather gives every rank the whole image.
    The JAX package splits each chunk's rays over its mesh instead
    (``trainer.py:307-345``); a chunk's probe budget then acts on each
    share, and on an H100 18 % of a validation render's rays moved (depth
    beyond 2e-3) where a probe round overflowed.  Whole chunks keep
    every ray's render the unsharded one.
    """
    mcfg = cfg.model
    dev = resolve_device(device)
    chunk = cfg.train.render_chunk
    iters = cfg.train.eval_iters or mcfg.ray_sampler.max_total_iters
    align = 128

    def _inputs(uv_chunk, pose, intrinsics):
        return {
            "uv": torch.as_tensor(uv_chunk, dtype=torch.float32,
                                  device=dev)[None],
            "pose": pose[None],
            "intrinsics": intrinsics[None],
        }

    def _empty(n):
        """Outputs of rays that all miss (the renderer's miss defaults;
        white_bkgd composites the background onto zero-acc rays)."""
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
    def render_image(tp, scene, frozen, uv, pose, intrinsics):
        pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
        intrinsics = torch.as_tensor(intrinsics, dtype=torch.float32,
                                     device=dev)
        params = {"frozen": _prior(frozen, compute_dtype), "train": tp}
        uv = np.asarray(uv, dtype=np.float32)
        n = uv.shape[0]
        eff = min(chunk, -(-n // align) * align)
        pad = (-n) % eff
        uv_p = np.pad(uv, ((0, pad), (0, 0)))

        def run_chunk(uv_chunk):
            out = render_rays(params, scene, _inputs(uv_chunk, pose,
                                                     intrinsics),
                              mcfg, train=False, iters=iters)
            return {k: out[k] for k in _KEEP}

        def rendered(chunks):
            """Every chunk's outputs in order, as numpy: this rank renders
            every ``world``-th chunk from its rank (all of them outside a
            group) into one buffer, gathered from the ranks."""
            world, rank = (1, 0) if group is None else (group.world,
                                                        group.rank)
            per = -(-len(chunks) // world)
            like = _empty(1)                   # the outputs' dtypes, widths
            cols = [like[k][0].size for k in _KEEP]
            mine = torch.zeros((per * eff, sum(cols)), device=dev)
            for i, c in enumerate(chunks[rank::world]):
                o = run_chunk(c)
                mine[i * eff:(i + 1) * eff] = torch.cat(
                    [o[k].reshape(eff, -1).to(torch.float32) for k in _KEEP],
                    1)
            every = mine[None] if group is None else group.all_gather_rows(
                mine)
            rows = every.reshape(world, per, eff, -1).transpose(0, 1).reshape(
                world * per * eff, -1)[:len(chunks) * eff].cpu().numpy()
            full, at = {}, 0
            for k, c in zip(_KEEP, cols):
                full[k] = rows[:, at:at + c].reshape(
                    (-1,) + like[k].shape[1:]).astype(like[k].dtype)
                at += c
            return full

        if cfg.train.render_skip_empty and scene.occ_fine is not None:
            # one whole-image occupancy pass and one [n]-bool readback
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
            # every chunk is launched before the one readback below
            full = rendered([uv_p[sel_p[i:i + eff]]
                             for i in range(0, len(sel_p), eff)])
            for k in out:
                out[k][sel] = full[k][:len(sel)]
            return out

        full = rendered([uv_p[i:i + eff] for i in range(0, n + pad, eff)])
        return {k: v[:n] for k, v in full.items()}

    return render_image


def _prior(frozen, compute_dtype):
    """The prepared frozen prior, or None for the entangled model (its
    frozen tree is empty)."""
    return _prep_layers(frozen, compute_dtype) if frozen else None


def _calibrate_ray_budget(scene, views, cfg: Config):
    """The auto budgets from the scene's fine-bitmap occupancy over the
    train views (host numpy; ``spurfies_tpu/train/trainer.py:38-88``).

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


def _rays_occupied_np(occ0, spec, scfg, uv, pose, K):
    """Per ray ``[P]`` bool: does any of the n_samples_eval uniform z
    samples land in an occupied fine cell?  (The host twin of
    ``model.renderer.coarse_ray_occupancy``.)"""
    return _samples_occupied_np(occ0, spec, scfg, uv, pose, K).any(axis=1)


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


@dataclasses.dataclass
class TrainState:
    """Trainable parameters (latents + nets + beta), the optimizer state
    and the step count (an int32 tensor on the card), updated in place."""
    params: dict
    opt_state: OptState
    step: torch.Tensor


# metrics summed over a window (rare single-step events); every other
# metric reports its window's last step (trainer.py:277-294)
_SUM_KEYS = ("ray_overflow", "probe_overflow")


def make_train_step(cfg: Config, optimizer: Optimizer, device="cuda",
                    use_local: bool = False, group=None):
    """``(loss_fn, sample_batch, train_step)`` for ``cfg`` on ``device``
    (``spurfies_tpu/train/trainer.py:147-275``).

    * ``loss_fn(tp, bundle, batch, step, generator=None, draws=None)`` ->
      ``(loss, parts)``.  bundle: ``{"scene", "prior", "views"}`` with the
      prior prepared by ``ops.pair_mlp._prep_layers`` (None for the
      entangled model), and ``"local"`` (:meth:`Trainer.bundle`'s local
      context) when ``use_local``.  draws: optional
      tensors for the random numbers of the step -- the sampler's
      (``model.sampler.error_bound_z_vals``), ``"cloud_sel"`` and
      ``"fd_sel"``/``"fd_u"``; absent ones come from ``generator``.
    * ``sample_batch(views, generator, v=None, pix=None)``: a view and
      ``num_pixels`` distinct pixels, drawn on the card unless given
      (``v`` a ``[1]`` long tensor, ``pix`` ``[num_pixels]``).
    * ``train_step(bundle, state, generator, draws=None, batch=None)``: one
      step in place on ``state``; returns its metrics as 0-d tensors on
      the card.  ``batch`` defaults to ``sample_batch``'s draw.

    ``use_local``: add the local feature loss (``trainer.py:209-227``) at
    the first backward-facing SDF crossing of each ray, against the
    batch's view and its two sources.

    ``group`` (a :class:`parallel.mesh.RankGroup`): the ray-sharded step
    (``trainer.py:147-190``).  ``sample_batch`` draws the whole batch on
    every rank, from generators seeded alike, and ``draws`` are the whole
    batch's.  Each rank renders its share of the rays
    (``renderer._render_share``); its loss parts are its shares of the
    whole batch's: the plain means (rgb, mask) count its own rays over the
    batch's count, the masked means (eikonal, pseudo-SDF, local, fd
    eikonal) divide by the count summed over the ranks, and the terms that
    do not depend on the rays (TV, cloud anchor) count on rank 0 only; the
    cloud anchor's draw is made on every rank, so that their generators
    stay alike.  ``train_step`` sums the gradients over the ranks in one
    all-reduce before the optimizer, so the guarded Adam's clip and finite
    test see the whole batch's gradient and every rank takes the same step.
    Its metrics are the rank's shares, with ``mse`` for ``psnr`` and
    ``ray_overflow`` (the whole batch's, the same on every rank) on rank 0
    only; :meth:`Trainer.run` sums them over the ranks at its readback.
    """
    mcfg, lcfg = cfg.model, cfg.loss
    n_pix = cfg.train.num_pixels
    fast = cfg.train.fast_iters
    dev = resolve_device(device) if group is None else group.device
    count_fn = None if group is None else group.sum
    lead = group is None or group.lead

    def loss_fn(tp, bundle, batch, step, generator=None, draws=None):
        scene = bundle["scene"]
        draws = draws or {}
        params = {"frozen": bundle["prior"], "train": tp}
        out = render_rays(params, scene, batch["inputs"], mcfg, train=True,
                          iters=fast, generator=generator, draws=draws,
                          group=group)
        if not mcfg.entangled:  # the legacy model: rgb, eikonal, mask only
            if lead:
                out["tv_loss"] = tv_loss(params, scene)
            out["pseudo_pts_loss"] = pseudo_sdf_loss(params, scene, out,
                                                     mcfg, count_fn)
            if lcfg.cloud_anchor_weight > 0:
                sel = draws.get("cloud_sel")
                if sel is None:
                    sel = cloud_anchor_sel(scene, generator=generator)
                if lead:
                    out["cloud_anchor_loss"] = cloud_anchor_loss(
                        params, scene, mcfg, sel=sel)
            if lcfg.fd_eikonal_weight > 0:
                out["fd_eikonal_loss"] = fd_eikonal_loss(
                    params, scene, out, mcfg, n_sub=lcfg.fd_eikonal_points,
                    generator=generator, sel=draws.get("fd_sel"),
                    u=draws.get("fd_u"), count_fn=count_fn)
        if use_local:
            ctx = bundle["local"]
            d_surf, surf_mask = find_surface_depth(out["sdf"], out["z_sel"],
                                                   out["valid_pt"])
            surface = out["cam_loc"] + out["ray_dirs"] * d_surf[:, None]
            # the view as a [1] index: nothing is read back
            v = batch["view"]
            src = ctx["src"][v][0]
            out["local_loss"] = local_feature_loss(
                surface, surf_mask & out["ray_mask"], ctx["feats"][v][0],
                ctx["feats"][src], ctx["cams"][v][0], ctx["cams"][src],
                ctx["size"], ctx["center"], count_fn=count_fn)
        loss, parts = total_loss(out, batch["gt"], lcfg, step=step,
                                 count_fn=count_fn)
        gt_rgb = batch["gt"]["rgb"].reshape(-1, 3)
        if group is None:
            parts["psnr"] = psnr_fn(out["rgb_values"], gt_rgb)
        else:
            parts["mse"] = rgb_loss(out["rgb_values"], gt_rgb, "l2",
                                    out["ray_own"])
        parts["ray_overflow"] = out["ray_budget_overflow"].to(torch.float32)
        if not lead:
            parts["ray_overflow"] = torch.zeros_like(parts["ray_overflow"])
        parts["probe_overflow"] = out["probe_budget_overflow"].to(
            torch.float32)
        return loss, parts

    def sample_batch(views, generator, v=None, pix=None):
        n_views = views["rgb"].shape[0]
        total_px = views["uv"].shape[0]
        if v is None:
            v = torch.randint(0, n_views, (1,), generator=generator,
                              device=dev)
        if pix is None:
            pix = torch.randperm(total_px, generator=generator,
                                 device=dev)[:n_pix]
        # a [1] index keeps the view's batch axis and never reads the
        # index back to the host
        return {
            "inputs": {"uv": views["uv"][pix][None],
                       "pose": views["pose"][v],
                       "intrinsics": views["intrinsics"][v]},
            "gt": {"rgb": views["rgb"][v, pix], "mask": views["mask"][v, pix]},
            "view": v,
        }

    def train_step(bundle, state: TrainState, generator, draws=None,
                   batch=None):
        if batch is None:
            batch = sample_batch(bundle["views"], generator)
        leaves = flatten(state.params)
        loss, parts = loss_fn(state.params, bundle, batch, state.step,
                              generator, draws)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        if group is not None:
            group.all_reduce_(grads)
        optimizer.step(state.params, grads, state.opt_state)
        state.step += 1
        parts = {k: v.detach() for k, v in parts.items()}
        # consecutive non-finite skips (finite_guarded_clip's counter)
        parts["notfinite"] = state.opt_state.notfinite_count.to(
            torch.float32)
        return parts

    return loss_fn, sample_batch, train_step


def whole_batch_metrics(group, keys, vals):
    """The ranks' metrics ``vals`` (``[len(keys)]``, one step's or a
    window's) summed over ``group`` into the whole batch's, in one
    all-reduce: every part is a rank's share but ``notfinite``, the same on
    every rank, and ``mse`` becomes ``psnr``.  Returns ``(keys, vals)``."""
    summed = group.sum(vals)
    same = torch.tensor([k == "notfinite" for k in keys], device=vals.device)
    vals = torch.where(same, vals, summed)
    if "mse" in keys:
        i = keys.index("mse")
        vals[i] = -10.0 * torch.log(vals[i]) / math.log(10.0)
        keys = keys[:i] + ["psnr"] + keys[i + 1:]
    return keys, vals


class Trainer:
    """Host side of training: builds the scene, parameters and optimizer, runs
    windows of steps, renders eval images, saves and restores checkpoints
    (``spurfies_tpu/train/trainer.py:445-658``).

    Args:
      cfg: the Config; ``ray_budget_frac``/``probe_budget_frac`` < 0 are
        calibrated here and ``self.cfg`` carries the values.
      point_cloud, colors: the raw cloud ``[M, 3]`` and its colours.
      views: ``rgb [V, HW, 3]``, ``mask [V, HW, 1]``, ``uv [HW, 2]``,
        ``pose``/``intrinsics [V, 4, 4]`` (numpy), kept on the card.
      device: where everything runs (the card unless ``"cpu"``).
      compute_dtype: the frozen prior's matmul dtype (bf16, the kernels'
        dtype; f32 only on the CPU).
      local_bundle: a :class:`data.mvs_local.LocalBundle`; with
        ``loss.local_weight > 0`` its features, hd cameras, the source map
        of the train views and the world denormalization go to the device
        (``self.local_ctx``) and every step adds the local feature loss.
      group: the :class:`parallel.mesh.RankGroup` to shard the rays over;
        by default, with ``train.data_parallel`` > 1, the group this
        process joined through ``parallel.launch`` (``trainer.py:484-515``:
        the same two ``ValueError``s when it has too few ranks or
        ``num_pixels`` does not split).  Every rank builds the same state
        on its group's device (``device`` is then ignored), and rank 0's
        initial parameters are broadcast.  A group of one rank runs the
        sharded code with its collectives.
    """

    def __init__(self, cfg: Config, point_cloud, colors, views,
                 local_bundle=None, device="cuda",
                 compute_dtype=torch.bfloat16, group=None):
        dp = cfg.train.data_parallel
        if group is None and dp > 1:
            group = make_group(dp)
        if group is not None and group.world != dp:
            raise ValueError(f"train.data_parallel={dp} but the group has "
                             f"{group.world} ranks")
        if group is not None and cfg.train.num_pixels % group.world:
            raise ValueError(
                f"train.num_pixels={cfg.train.num_pixels} must be a "
                f"multiple of data_parallel={group.world}")
        self.group = group
        self.device = (resolve_device(device) if group is None
                       else group.device)
        self.compute_dtype = compute_dtype
        seed = cfg.train.seed
        gen = torch.Generator().manual_seed(seed)
        self.scene, latents = build_scene(point_cloud, cfg.model, colors,
                                          generator=gen, device=self.device)
        if cfg.model.ray_budget_frac < 0 or cfg.model.probe_budget_frac < 0:
            ray_frac, probe_frac = _calibrate_ray_budget(self.scene, views,
                                                         cfg)
            updates = {}
            if cfg.model.ray_budget_frac < 0:
                updates["ray_budget_frac"] = ray_frac
            if cfg.model.probe_budget_frac < 0:
                updates["probe_budget_frac"] = probe_frac
            cfg = dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model, **updates))
        self.cfg = cfg
        params = init_model_params(cfg.model, gen, device=self.device)
        tp = dict(params["train"], **latents)
        if group is not None:
            group.broadcast_(flatten(tp))
        for leaf in flatten(tp):
            leaf.requires_grad_(True)
        self.load_frozen(params["frozen"])
        self.views = {k: torch.as_tensor(np.asarray(v), device=self.device)
                      for k, v in views.items()}
        self.optimizer = Optimizer(cfg.train)
        self.state = TrainState(
            tp, self.optimizer.init(tp),
            torch.zeros((), dtype=torch.int32, device=self.device))
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed + 1)
        self.local_ctx = None
        if local_bundle is not None and cfg.loss.local_weight > 0:
            dev = self.device
            self.local_ctx = {
                "feats": torch.as_tensor(local_bundle.feats, device=dev),
                "cams": torch.as_tensor(local_bundle.cams_hd, device=dev),
                "src": torch.tensor(
                    [SRC_MAP[i] for i in range(self.views["rgb"].shape[0])],
                    dtype=torch.int64, device=dev),
                "size": torch.tensor(float(local_bundle.size), device=dev),
                "center": torch.as_tensor(local_bundle.center,
                                          dtype=torch.float32, device=dev)}
        self.loss_fn, self.sample_batch, self.train_step = make_train_step(
            cfg, self.optimizer, self.device,
            use_local=self.local_ctx is not None, group=group)
        self._render = make_render_fn(cfg, self.device, compute_dtype, group)

    @property
    def bundle(self):
        b = {"scene": self.scene, "prior": self.prior, "views": self.views}
        if self.local_ctx is not None:
            b["local"] = self.local_ctx
        return b

    def load_frozen(self, frozen_params):
        """Install the frozen prior (reference train.py:124-143): a tree of
        tensors ``{"F_geometry": [...], "T": [...]}`` (empty for the
        entangled model)."""
        self.frozen = {k: [{kk: t.to(self.device) for kk, t in layer.items()}
                           for layer in v]
                       for k, v in frozen_params.items()}
        self.prior = _prior(self.frozen, self.compute_dtype)

    def render_image(self, uv, pose, intrinsics):
        """A full image through ``make_render_fn`` with the current
        trainable parameters."""
        return self._render(self.state.params, self.scene, self.frozen, uv,
                            pose, intrinsics)

    def run(self, n_steps: int, window: int = 100, callback=None):
        """Run ``n_steps`` in windows of ``window``; ``callback(step,
        metrics)`` after each window with each metric's last-step value
        (the overflow counters summed over the window).  Metrics are read
        back once per window; under ray sharding they are summed over the
        ranks there, in one all-reduce (every rank calls ``run``), into
        the whole batch's.  Raises when every step of a window (and at
        least 100 in a row) was skipped as non-finite, on every rank
        alike."""
        done = 0
        while done < n_steps:
            w = min(window, n_steps - done)
            acc = {}
            for _ in range(w):
                parts = self.train_step(self.bundle, self.state,
                                        self.generator)
                for k, v in parts.items():
                    acc[k] = acc[k] + v if k in _SUM_KEYS and k in acc else v
            done += w
            keys = list(acc)
            vals = torch.stack([acc[k].to(torch.float32) for k in keys])
            if self.group is not None:
                keys, vals = whole_batch_metrics(self.group, keys, vals)
            last = dict(zip(keys, vals.cpu().tolist()))
            consec = last["notfinite"]
            if consec >= max(w, 100):
                raise RuntimeError(
                    f"{int(consec)} consecutive non-finite-gradient steps at "
                    f"step {int(self.state.step)}; aborting (every update "
                    "in the last window was skipped)")
            if callback is not None:
                callback(int(self.state.step), last)
        return self.state

    # ---- checkpoints: params + frozen + step + optimizer state ----------
    def save_checkpoint(self, path: str):
        """Write the state to ``path``; under ray sharding rank 0 writes
        and every rank waits for the file."""
        if self.group is None or self.group.lead:
            torch.save({"params": _detached(self.state.params),
                        "frozen": self.frozen,
                        "step": int(self.state.step),
                        "opt_state": self.state.opt_state.state_dict()},
                       path)
        if self.group is not None:
            self.group.barrier()

    def restore_checkpoint(self, path: str):
        """Restore what :meth:`save_checkpoint` wrote (every rank reads the
        same file).  A file without optimizer state restores its
        parameters with a fresh optimizer and a warning; a corrupt file
        raises."""
        ck = torch.load(path, map_location=self.device, weights_only=True)
        tp = ck["params"]
        for leaf in flatten(tp):
            leaf.requires_grad_(True)
        if "opt_state" in ck:
            opt_state = OptState.from_state_dict(ck["opt_state"])
        else:
            warnings.warn("checkpoint has no optimizer state; restoring "
                          "parameters with a fresh optimizer", stacklevel=2)
            opt_state = self.optimizer.init(tp)
        self.load_frozen(ck["frozen"])
        self.state = TrainState(tp, opt_state, torch.tensor(
            ck["step"], dtype=torch.int32, device=self.device))


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_detached(v) for v in tree]
    return tree.detach()
