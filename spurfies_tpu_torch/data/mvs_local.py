"""The Vis-MVSNet local-loss bundle of a DTU scene (port of
``spurfies_tpu/data/mvs_local.py``).

Reference ``spurfies/datasets/dtu.py:161-239`` and
``spurfies/feat_utils.py:80-145``:
  * MVS camera text files: word 0 the 'extrinsic' marker, words 1..16 the
    4x4 extrinsic, words 18..26 the 3x3 intrinsic, then depth-range words
    (unused); pair.txt lists the source views of each reference view.
  * The first three images of ``DTU_pixelnerf/dtu_scan{id}/image`` are
    read as BGR (cv2.imread's order) and /256, resized bilinearly to twice
    the depth cameras' resolution (768x1024), halved and shifted to
    [0.5, 1], ImageNet-normalized, and pushed through the frozen
    extractor; only its half-resolution 32-channel head ``f3`` is kept
    (dtu.py:236).
  * ``cams_hd`` = the depth cameras with their intrinsics scaled 2x;
    ``size = 2 scale_mat[0, 0]`` and ``center`` come from scale_mat
    (dtu.py:225-226).
  * The cameras come from ``DTU_pixelnerf/dtu_scan24/cam4feat`` for every
    scan (dtu.py:163-183 hardcodes it).
  * The source-view map of 3-view DTU (dtu.py:311-331), by a train view's
    position.

No cv2: the PNG is read by ``data.png`` and resized by
``scene_data.resize_linear``; the extractor runs on the bundle's device.
"""

import os
from dataclasses import dataclass

import numpy as np
import torch

from spurfies_tpu_torch.data import jpeg
from spurfies_tpu_torch.data.scene_data import (
    decode_image,
    glob_images,
    resize_linear,
)
from spurfies_tpu_torch.device import resolve_device

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

# dtu.py:311-331: each train view's position and its sources
SRC_MAP = {0: [1, 2], 1: [0, 2], 2: [0, 1]}


def parse_mvs_cam(path: str) -> np.ndarray:
    """-> ``[2, 4, 4]``: cam[0] the extrinsic w2c, cam[1][:3, :3] the
    intrinsic."""
    with open(path) as f:
        words = f.read().split()
    cam = np.zeros((2, 4, 4), dtype=np.float32)
    for i in range(4):
        for j in range(4):
            cam[0, i, j] = float(words[4 * i + j + 1])
    for i in range(3):
        for j in range(3):
            cam[1, i, j] = float(words[3 * i + j + 18])
    cam[1, 3, 3] = 1.0
    return cam


def parse_pair(path: str) -> list:
    """pair.txt -> the ordered list of view-id strings."""
    with open(path) as f:
        lines = f.readlines()
    n = int(lines[0])
    return [lines[1 + 2 * i].strip() for i in range(n)]


def scale_intrinsics(cam: np.ndarray, scale: float) -> np.ndarray:
    out = cam.copy()
    out[1, 0, :] *= scale
    out[1, 1, :] *= scale
    return out


def read_bgr(path: str) -> np.ndarray:
    """uint8 ``[H, W, 3]`` in BGR order, as ``cv2.imread(path)`` gives it:
    16-bit samples keep their high byte, gray repeats, alpha goes, and a
    JPEG is turned as its EXIF orientation tag says (a grey lossless JPEG,
    which cv2 reads as ``None``, raises a ``ValueError``)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == jpeg.SIGNATURE:
        img = jpeg.decode_jpeg(data, str(path), as_cv2=True)
    else:
        img = np.asarray(decode_image(data, str(path)))
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., 2::-1])


@dataclass
class LocalBundle:
    """A scene's MVS feature bundle, on one device (NHWC features)."""
    feats: torch.Tensor      # [3, Hf, Wf, 32]
    cams_hd: torch.Tensor    # [3, 2, 4, 4]
    size: float
    center: torch.Tensor     # [3]

    def for_view(self, enum_id: int):
        src = SRC_MAP[enum_id]
        return {"feat": self.feats[enum_id], "feats_src": self.feats[src],
                "cam": self.cams_hd[enum_id],
                "src_cams": self.cams_hd[src], "size": self.size,
                "center": self.center}


def feature_images(paths, feat_img_scale: int = 2) -> np.ndarray:
    """The extractor's input batch ``[N, 3, H, W]`` float32 from image
    files: BGR / 256, resized to (384, 512) x ``feat_img_scale``, then
    ``(img / 2 + 0.5 - mean) / std`` (dtu.py:195-196, 222)."""
    target = (384 * feat_img_scale, 512 * feat_img_scale)
    imgs = []
    for p in paths:
        img = resize_linear(read_bgr(p).astype(np.float32) / 256.0, target)
        imgs.append((img / 2 + 0.5 - IMAGENET_MEAN) / IMAGENET_STD)
    return np.ascontiguousarray(np.stack(imgs).transpose(0, 3, 1, 2))


def build_local_bundle(data_dir_root: str, scan_id: int, featext,
                       scale_mat: np.ndarray, feat_img_scale: int = 2,
                       device="cuda") -> LocalBundle:
    """Cameras and images read, features extracted on ``device`` by
    ``featext`` (a :class:`model.featext.FeatExt` there), bundled there."""
    dev = resolve_device(device)
    cam_dir = os.path.join(data_dir_root, "dtu", "DTU_pixelnerf",
                           "dtu_scan24", "cam4feat")
    ids = parse_pair(os.path.join(cam_dir, "pair.txt"))[:3]
    cams_hd = np.stack([
        scale_intrinsics(parse_mvs_cam(os.path.join(
            cam_dir, f"cam_{i.zfill(8)}_flow3.txt")), feat_img_scale)
        for i in ids])
    img_dir = os.path.join(data_dir_root, "dtu", "DTU_pixelnerf",
                           f"dtu_scan{scan_id}", "image")
    batch = torch.from_numpy(feature_images(glob_images(img_dir)[:3],
                                            feat_img_scale)).to(dev)
    with torch.no_grad():
        _, _, f3 = featext(batch)
    return LocalBundle(
        feats=f3.permute(0, 2, 3, 1).contiguous(),    # [3, 384, 512, 32]
        cams_hd=torch.from_numpy(cams_hd).to(dev),
        size=float(scale_mat[0, 0]) * 2.0,
        center=torch.as_tensor(np.asarray(scale_mat[:3, 3], np.float32),
                               device=dev))
