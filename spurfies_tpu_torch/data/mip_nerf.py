"""MipNeRF-360 loader (garden / stump, 3 train views; port of
``spurfies_tpu/data/mip_nerf.py``).

Behavioral spec from reference ``spurfies/datasets/mip_nerf.py:25-190``:
NGP-style JSON cameras; hardcoded per-scene img_res (garden 420x648, stump
413x622) and 3 hardcoded train frame names; eval mode reads ``image_eval``
and 7 views; masks all ones; scale_mat = I.  Scene bounds are ±2 (model
ctor, pointneus_disent.py:45-53).
"""

import json
import os

import numpy as np

from spurfies_tpu_torch.data.ply import load_ply
from spurfies_tpu_torch.data.scene_data import (
    SceneData,
    ViewSet,
    flatten_image,
    glob_images,
    load_image,
)

SCENE_RES = {"garden": (420, 648), "stump": (413, 622)}
TRAIN_FRAMES = {
    "garden": ["DSC08116.JPG", "DSC08121.JPG", "DSC08140.JPG"],
    "stump": ["_DSC9307.JPG", "_DSC9313.JPG", "_DSC9328.JPG"],
}


def load_mipnerf(data_dir_root: str, scan_id: str,
                 mode: str = "train") -> SceneData:
    if scan_id not in SCENE_RES:
        raise NotImplementedError(f"mipnerf scene {scan_id}")
    img_res = SCENE_RES[scan_id]

    inst = os.path.join(data_dir_root, "mipnerf", scan_id)
    with open(os.path.join(inst, f"{scan_id}.json")) as f:
        meta = json.load(f)

    h, w = meta["h"], meta["w"]
    sy, sx = img_res[0] / h, img_res[1] / w
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1] = meta["fl_x"] * sx, meta["fl_y"] * sy
    K[0, 2], K[1, 2] = meta["cx"] * sx, meta["cy"] * sy

    names = TRAIN_FRAMES[scan_id]
    frame_by_name = {
        fr["file_path"].split("/")[-1]: fr for fr in meta["frames"]
    }
    poses = np.stack([
        np.asarray(frame_by_name[n]["transform_matrix"], dtype=np.float32)
        for n in names if n in frame_by_name
    ])

    sub = "image" if mode == "train" else "image_eval"
    image_paths = glob_images(os.path.join(inst, sub))

    rgbs, masks = [], []
    for p in image_paths:
        img = load_image(p, img_res)
        rgbs.append(flatten_image(img))
        masks.append(np.ones_like(rgbs[-1]))

    ids = list(range(len(rgbs)))
    vs = ViewSet(
        rgb=np.stack(rgbs), mask=np.stack(masks),
        pose=poses[: len(rgbs)] if mode == "train" else poses,
        intrinsics=np.stack([K] * len(rgbs)),
        ids=ids,
    )

    pts, cols = load_ply(os.path.join(inst, f"{scan_id}.ply"))
    return SceneData(
        scan_id=scan_id, img_res=img_res, train=vs, eval=vs,
        points=pts, colors=cols, scale_mat=np.eye(4, dtype=np.float32),
    )


def model_overrides(scan_id: str) -> dict:
    """Per-scene model-config overrides (±2 bounds for garden/stump,
    reference pointneus_disent.py:45-53)."""
    return {
        "scene_lo": (-2.0, -2.0, -2.0),
        "scene_hi": (2.0, 2.0, 2.0),
    }
