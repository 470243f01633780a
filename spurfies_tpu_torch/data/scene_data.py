"""Common per-scene data bundle (port of ``spurfies_tpu/data/scene_data.py``).

The reference's three torch Datasets (dtu.py / mip_nerf.py / own_data.py)
share one protocol: per-view (uv, intrinsics 4x4, pose c2w 4x4) + flattened
rgb/mask ``[H*W, 3]`` (SURVEY §2 L5).  The trainer wants all train views
stacked, so loaders produce a SceneData with stacked train/eval stacks.

Images are read without imageio, Pillow or cv2: PNG through ``data.png``,
JPEG through ``data.jpeg`` (the host decoder), the cubic and bilinear
resizes through ``F.interpolate`` and the nearest one by cv2's own index
rule.
"""

import glob
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from spurfies_tpu_torch.data import jpeg, png


def make_uv(h: int, w: int) -> np.ndarray:
    """Pixel grid ``[h*w, 2]`` in (x, y) order, matching reference
    ``np.mgrid`` + flip (own_data.py:130-132)."""
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([xx, yy], axis=-1).reshape(-1, 2).astype(np.float32)


@dataclass
class ViewSet:
    """Stacked views: rgb/mask [V, HW, 3], pose/intrinsics [V, 4, 4]."""
    rgb: np.ndarray
    mask: np.ndarray
    pose: np.ndarray
    intrinsics: np.ndarray
    ids: list

    def stacked(self, uv: np.ndarray) -> dict:
        return {
            "rgb": self.rgb, "mask": self.mask, "uv": uv,
            "pose": self.pose, "intrinsics": self.intrinsics,
        }


@dataclass
class SceneData:
    scan_id: str
    img_res: tuple                 # (H, W)
    train: ViewSet
    eval: ViewSet | None
    points: np.ndarray             # raw point cloud [M, 3]
    colors: np.ndarray | None      # [M, 3] 0..255
    scale_mat: np.ndarray          # 4x4 world normalization
    local: object = None           # MVS feature bundle (DTU local loss)

    @property
    def uv(self) -> np.ndarray:
        return make_uv(*self.img_res)

    @property
    def total_pixels(self) -> int:
        return int(self.img_res[0] * self.img_res[1])

    @property
    def scale_factor(self) -> float:
        return float(self.scale_mat[0, 0])

    def train_views(self) -> dict:
        return self.train.stacked(self.uv)


def decode_image(data: bytes, name: str = "image") -> np.ndarray:
    """The pixels of an image file's bytes as imageio gives them, by the
    file's signature: PNG through ``data.png``, JPEG through ``data.jpeg``
    (bit-equal; the EXIF orientation is ignored).  Pillow reads a 16-bit
    PNG with more than one channel as 8 bits (the high byte), gray+alpha as
    RGBA.  Any other format raises a ``ValueError``."""
    if data[:8] == png.SIGNATURE:
        img = png.decode_png(data)
        if img.dtype == np.uint16 and img.ndim == 3:
            img = (img >> 8).astype(np.uint8)
            if img.shape[2] == 2:
                img = img[..., [0, 0, 0, 1]]
        return img
    if data[:2] == jpeg.SIGNATURE:
        return jpeg.decode_jpeg(data, name)
    raise ValueError(f"{name}: neither a PNG nor a JPEG file")


def read_image(path: str) -> np.ndarray:
    """:func:`decode_image` of the file at ``path``."""
    with open(path, "rb") as f:
        return decode_image(f.read(), str(path))


def resize_cubic(img: np.ndarray, img_res) -> np.ndarray:
    """Bicubic resize of a float32 ``[H, W, C]`` image to ``img_res`` (H, W)
    by ``F.interpolate`` (a = -0.75, pixel centres aligned, the border
    replicated, no antialiasing), as ``cv2.resize(INTER_CUBIC)`` resizes
    float input.  The two compute a source position in f32 each their own
    way, so they agree to a few ulps of the position: within
    ``max(H, W) * 2**-22`` on [0, 1] images."""
    t = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    t = t.permute(2, 0, 1)[None]
    out = F.interpolate(t, size=tuple(img_res), mode="bicubic",
                        align_corners=False)
    return out[0].permute(1, 2, 0).contiguous().numpy()


def resize_linear(img: np.ndarray, img_res) -> np.ndarray:
    """Bilinear resize of a float32 ``[H, W, C]`` image to ``img_res``
    (H, W) by ``F.interpolate`` (pixel centres aligned, the border
    replicated, no antialiasing), as ``cv2.resize(INTER_LINEAR)`` resizes
    float input (held to cv2 in ``tests/test_torch_local_loss.py``)."""
    t = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    t = t.permute(2, 0, 1)[None]
    out = F.interpolate(t, size=tuple(img_res), mode="bilinear",
                        align_corners=False, antialias=False)
    return out[0].permute(1, 2, 0).contiguous().numpy()


def _nearest_index(n_src: int, n_dst: int) -> np.ndarray:
    # cv2's rule: floor(dst * (1 / (n_dst / n_src))) in double precision
    # (F.interpolate's f32 scale picks another pixel at some sizes, e.g.
    # 1200x1600 -> 576x768)
    return np.minimum(np.floor(np.arange(n_dst) * (1.0 / (n_dst / n_src))),
                      n_src - 1).astype(np.int64)


def resize_nearest(img: np.ndarray, img_res) -> np.ndarray:
    """Nearest-neighbour resize of ``[H, W, ...]`` to ``img_res`` (H, W),
    bit for bit ``cv2.resize(INTER_NEAREST)``."""
    rows = _nearest_index(img.shape[0], img_res[0])
    cols = _nearest_index(img.shape[1], img_res[1])
    return img[rows][:, cols]


def load_image(path: str, img_res=None) -> np.ndarray:
    """float32 [H, W, 3] in [0, 1]; optional cubic resize
    (reference rend_util.load_rgb + dtu.py:148-155)."""
    img = np.asarray(read_image(path), dtype=np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    img = img[..., :3]
    if img_res is not None and tuple(img.shape[:2]) != tuple(img_res):
        img = resize_cubic(img, img_res)
    return img


def flatten_image(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] -> [H*W, 3] row-major (matches reference reshape path)."""
    return img.reshape(-1, 3).astype(np.float32)


IMG_EXTS = (".png", ".jpg", ".JPG", ".jpeg", ".PNG", ".JPEG")


def glob_images(d: str) -> list:
    paths = []
    for e in IMG_EXTS:
        paths += glob.glob(os.path.join(d, f"*{e}"))
    return sorted(set(paths))
