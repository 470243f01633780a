"""Novel-view-synthesis evaluation: render eval views, score PSNR/SSIM/LPIPS
(port of ``spurfies_tpu/eval/nvs.py``).

Behavioral spec from reference ``eval_spurfies.py:196-374``: per eval view,
render in chunks, save eval/normal/depth PNGs, then masked PSNR, SSIM on
foreground-composited images, LPIPS-VGG; per-scan and global means.  The
renders run on the trainer's device; the scores are host numpy, as in the
JAX package.

Three differences by design from the JAX function (ROADMAP Queue 3):
  * an ``view_ids`` selection that matches no eval view raises (JAX writes
    NaN means);
  * view ids are compared as strings (JAX's ``int()`` fails on a string
    id);
  * without LPIPS the result says so: ``"lpips": None`` and
    ``"lpips_skipped_reason"`` (JAX leaves the key's list empty).
"""

import os

import numpy as np

from spurfies_tpu_torch.data.png import write_png
from spurfies_tpu_torch.eval.plots import visualize_depth
from spurfies_tpu_torch.eval.ssim import ssim as ssim_fn

LPIPS_SKIPPED = ("no LPIPS weights (ckpt/vgg16.pth and ckpt/lpips_vgg.pth "
                 "are not there)")


def composite_foreground(img: np.ndarray, mask: np.ndarray,
                         bg: float = 1.0) -> np.ndarray:
    """Foreground-composite onto WHITE like the reference
    (``rgb * mask + (1 - mask)``, eval_spurfies.py:236-237)."""
    return np.where(mask > 0.5, img, bg)


def quantize_png(img: np.ndarray) -> np.ndarray:
    """8-bit PNG roundtrip: the reference scores metrics on RELOADED PNGs
    (eval_spurfies.py:229-233), so the prediction is quantized before
    scoring."""
    return np.round(np.clip(img, 0.0, 1.0) * 255.0) / 255.0


def select_views(ids, max_views=None, view_ids=None):
    """Indices of the eval views to score: those whose id (as a string) is
    in ``view_ids`` when given, in protocol order, the first ``max_views``.
    Raises on a ``view_ids`` selection that matches none."""
    sel = list(range(len(ids)))
    if view_ids is not None:
        want = {str(v) for v in view_ids}
        sel = [i for i in sel if str(ids[i]) in want]
        if not sel:
            raise ValueError(f"no eval view has an id in {sorted(want)}; "
                             f"the eval ids are {list(ids)}")
    if max_views is not None:
        sel = sel[: int(max_views)]
    return sel


def _png(img):
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def evaluate_views(render_image, scene_data, out_dir=None, lpips_fn=None,
                   save_images=True, quantize=True, max_views=None,
                   view_ids=None):
    """Render + score every eval view.

    Args:
      render_image: fn(uv, pose, intrinsics) -> dict of numpy
        rgb_values/normal_map/depth_values/acc (``Trainer.render_image``).
      scene_data: data.scene_data.SceneData (eval views used).
      lpips_fn: optional callable(img1 [H,W,3], img2) -> float.
      quantize: score the 8-bit PNG roundtrip of the prediction.
      view_ids: optional iterable of view ids -- score only the eval views
        whose id is in it (compared as strings).

    Returns:
      dict with per-view and mean psnr/ssim, and lpips (a list and
      ``mean_lpips``, or None and ``lpips_skipped_reason``).
    """
    h, w = scene_data.img_res
    uv = scene_data.uv
    vs = scene_data.eval or scene_data.train
    sel = select_views(vs.ids, max_views, view_ids)
    results = {"psnr": [], "ssim": [], "lpips": [],
               "ids": [vs.ids[i] for i in sel]}

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    for i in sel:
        out = render_image(uv, vs.pose[i], vs.intrinsics[i])
        pred = np.asarray(out["rgb_values"]).reshape(h, w, 3)
        if quantize:
            pred = quantize_png(pred)
        gt = np.asarray(vs.rgb[i]).reshape(h, w, 3)
        mask = np.asarray(vs.mask[i]).reshape(h, w, 3)

        mask_bin = mask[..., :1] > 0.5
        se = ((pred - gt) ** 2)[np.repeat(mask_bin, 3, -1)]
        psnr = float(-10.0 * np.log10(se.mean() + 1e-12))

        pred_fg = composite_foreground(pred, mask)
        gt_fg = composite_foreground(gt, mask)
        s = ssim_fn(pred_fg, gt_fg, data_range=1.0)

        results["psnr"].append(psnr)
        results["ssim"].append(s)
        if lpips_fn is not None:
            results["lpips"].append(float(lpips_fn(pred_fg, gt_fg)))

        if out_dir and save_images:
            vid = vs.ids[i]
            write_png(os.path.join(out_dir, f"eval_{vid:03d}.png")
                      if isinstance(vid, int)
                      else os.path.join(out_dir, f"eval_{vid}.png"),
                      _png(pred))
            if "normal_map" in out:
                nm = np.asarray(out["normal_map"]).reshape(h, w, 3)
                write_png(os.path.join(out_dir, f"normal_{i:03d}.png"),
                          _png((nm + 1.0) / 2.0))
            if "depth_values" in out:
                dep = np.asarray(out["depth_values"]).reshape(h, w)
                acc = (np.asarray(out["acc"]).reshape(h, w)
                       if "acc" in out else np.ones_like(dep))
                write_png(os.path.join(out_dir, f"dep_{i:03d}.png"),
                          _png(visualize_depth(dep, acc)))

    results["mean_psnr"] = float(np.mean(results["psnr"]))
    results["mean_ssim"] = float(np.mean(results["ssim"]))
    if lpips_fn is not None:
        results["mean_lpips"] = float(np.mean(results["lpips"]))
    else:
        results["lpips"] = None
        results["lpips_skipped_reason"] = LPIPS_SKIPPED
    return results
