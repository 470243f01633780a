"""Full-image eval renderer (port of ``make_render_fn`` of
``spurfies_tpu/train/trainer.py``; reference render_step,
``train.py:399-472``).  ``Trainer`` is the training slice's work."""

import numpy as np
import torch

from spurfies_tpu_torch.config import Config
from spurfies_tpu_torch.core.cameras import get_camera_params
from spurfies_tpu_torch.device import resolve_device
from spurfies_tpu_torch.model.renderer import coarse_ray_occupancy, render_rays
from spurfies_tpu_torch.ops.pair_mlp import _prep_layers

_KEEP = ("rgb_values", "depth_values", "normal_map", "acc", "ray_mask")


def make_render_fn(cfg: Config, device="cuda", compute_dtype=torch.bfloat16):
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
    package's ``FUSED_MLP_DTYPE``); the colour MLPs run in bf16.  Eval draws
    no random numbers.
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
        params = {"frozen": _prep_layers(frozen, compute_dtype), "train": tp}
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
            starts = range(0, len(sel_p), eff)
            # every chunk is launched before the one readback below
            outs = [run_chunk(uv_p[sel_p[i:i + eff]]) for i in starts]
            for i, o in zip(starts, outs):
                keep = min(eff, len(sel) - i)
                for k in out:
                    out[k][sel[i:i + keep]] = o[k][:keep].cpu().numpy()
            return out

        outs = [run_chunk(uv_p[i:i + eff]) for i in range(0, n + pad, eff)]
        return {k: torch.cat([o[k] for o in outs]).cpu().numpy()[:n]
                for k in _KEEP}

    return render_image
