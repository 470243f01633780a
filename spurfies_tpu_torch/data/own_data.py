"""Own-data loader: NGP-style JSON cameras + PLY cloud (port of
``spurfies_tpu/data/own_data.py``).

Behavioral spec from reference ``spurfies/datasets/own_data.py:19-191``:
``<root>/own_data/<scan>/{image/, <scan>.json, <scan>.ply}``; img_res from
the JSON h/w; masks all ones; train/eval ids = [0, 1, 2]; scale_mat = I.
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


def load_own_data(data_dir_root: str, scan_id: str,
                  img_res=None, mode: str = "train") -> SceneData:
    inst = os.path.join(data_dir_root, "own_data", str(scan_id))
    cam_file = os.path.join(inst, f"{scan_id}.json")
    with open(cam_file) as f:
        meta = json.load(f)

    h, w = int(meta["h"]), int(meta["w"])
    img_res = (h, w) if img_res is None else tuple(img_res)
    sy, sx = img_res[0] / h, img_res[1] / w

    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1] = meta["fl_x"] * sx, meta["fl_y"] * sy
    K[0, 2], K[1, 2] = meta["cx"] * sx, meta["cy"] * sy

    image_paths = glob_images(os.path.join(inst, "image"))
    n = len(image_paths)
    poses = np.stack(
        [np.asarray(fr["transform_matrix"], dtype=np.float32)
         for fr in meta["frames"]][:n]
    )

    rgbs, masks = [], []
    for p in image_paths:
        img = load_image(p, img_res)
        rgbs.append(flatten_image(img))
        masks.append(np.ones_like(rgbs[-1]))

    ids = list(range(min(3, n)))
    vs = ViewSet(
        rgb=np.stack([rgbs[i] for i in ids]),
        mask=np.stack([masks[i] for i in ids]),
        pose=poses[ids],
        intrinsics=np.stack([K] * len(ids)),
        ids=ids,
    )

    ply_path = os.path.join(inst, f"{scan_id}.ply")
    pts, cols = load_ply(ply_path)

    return SceneData(
        scan_id=str(scan_id), img_res=img_res, train=vs, eval=vs,
        points=pts, colors=cols, scale_mat=np.eye(4, dtype=np.float32),
    )
