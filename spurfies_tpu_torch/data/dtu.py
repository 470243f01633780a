"""DTU loader (port of ``spurfies_tpu/data/dtu.py``).

Behavioral spec from reference ``spurfies/datasets/dtu.py``:
  * 49 images per scan from ``data/dtu/scan{id}/image``; cameras from
    ``cameras.npz`` via ``P = world_mat @ scale_mat`` decomposition
    (:79-120); intrinsics rescaled to img_res.
  * train ids ``[25, 22, 28, 40, 44, 48, 0, 8, 13][:num_views]`` (:19-28);
    eval ids = range(49) minus train minus the 15-view exclude list (:31-36).
  * eval masks from ``eval_mask/scan{id}/mask/{i:03d}.png``, binarized at
    ==1 then >0.5 after nearest resize (:122-145).
  * point cloud ``data/dtu/scan{id}/{id}.ply`` (DUSt3R output,
    pointneus_disent.py:134-135).

The Vis-MVSNet local-loss bundle (:161-239) has no port yet (ROADMAP.md
Queue 1 item 14); the loader works without it.  Masks are read through
``data.png`` and resized by ``resize_nearest``: bit for bit what Pillow and
``cv2.INTER_NEAREST`` give the JAX package.
"""

import os

import numpy as np

from spurfies_tpu_torch.core.cameras import load_K_Rt_from_P
from spurfies_tpu_torch.data.ply import load_ply
from spurfies_tpu_torch.data.png import read_png
from spurfies_tpu_torch.data.scene_data import (
    SceneData,
    ViewSet,
    flatten_image,
    glob_images,
    load_image,
    resize_nearest,
)

TRAIN_IDS_ALL = [25, 22, 28, 40, 44, 48, 0, 8, 13]
EXCLUDE_IDX = [3, 4, 5, 6, 7, 16, 17, 18, 19, 20, 21, 36, 37, 38, 39]


def get_train_ids(num_views: int = 3):
    if num_views == 49:
        return list(range(49))
    return TRAIN_IDS_ALL[:num_views]


def get_eval_ids():
    skip = set(TRAIN_IDS_ALL) | set(EXCLUDE_IDX)
    return [i for i in range(49) if i not in skip]


def _load_mask(path, img_res):
    m = np.asarray(read_png(path), dtype=np.float32)
    if m.ndim < 3:
        m = np.repeat(m[:, :, None], 3, axis=2)
    m = m[..., :3] / 255.0
    m = (m == 1).astype(np.float32)
    if tuple(m.shape[:2]) != tuple(img_res):
        m = resize_nearest(m, img_res)
        m = (m > 0.5).astype(np.float32)
    return m


def load_dtu(data_dir_root: str, scan_id: int, img_res=(576, 768),
             num_views: int = 3) -> SceneData:
    inst = os.path.join(data_dir_root, "dtu", f"scan{scan_id}")
    image_dir = os.path.join(inst, "image")
    cam_file = os.path.join(inst, "cameras.npz")
    if not os.path.exists(cam_file) and int(scan_id) < 200:
        cam_file = os.path.join(data_dir_root, "dtu", "scan114",
                                "cameras.npz")

    image_paths = glob_images(image_dir)[:49]
    n = len(image_paths)
    cams = np.load(cam_file)

    img0 = load_image(image_paths[0])
    scale_h = img_res[0] / img0.shape[0]
    scale_w = img_res[1] / img0.shape[1]

    intrinsics_all, poses_all = [], []
    for i in range(n):
        P = (cams[f"world_mat_{i}"] @ cams[f"scale_mat_{i}"])[:3, :4]
        K, pose = load_K_Rt_from_P(P)
        K = K.copy()
        K[0, :] *= scale_w
        K[1, :] *= scale_h
        intrinsics_all.append(K.astype(np.float32))
        poses_all.append(pose.astype(np.float32))

    mask_dir = os.path.join(data_dir_root, "dtu", "eval_mask",
                            f"scan{scan_id}", "mask")

    rgbs, masks = [], []
    for i, p in enumerate(image_paths):
        rgbs.append(flatten_image(load_image(p, img_res)))
        mpath = os.path.join(mask_dir, f"{i:03d}.png")
        if os.path.exists(mpath):
            masks.append(flatten_image(_load_mask(mpath, img_res)))
        else:
            masks.append(np.ones_like(rgbs[-1]))

    def viewset(ids):
        return ViewSet(
            rgb=np.stack([rgbs[i] for i in ids]),
            mask=np.stack([masks[i] for i in ids]),
            pose=np.stack([poses_all[i] for i in ids]),
            intrinsics=np.stack([intrinsics_all[i] for i in ids]),
            ids=list(ids),
        )

    train_ids = get_train_ids(num_views)
    eval_ids = [i for i in get_eval_ids() if i < n]

    ply_path = os.path.join(inst, f"{scan_id}.ply")
    pts, cols = (load_ply(ply_path) if os.path.exists(ply_path)
                 else (np.zeros((0, 3), np.float32), None))

    return SceneData(
        scan_id=str(scan_id), img_res=tuple(img_res),
        train=viewset(train_ids),
        eval=viewset(eval_ids) if eval_ids else None,
        points=pts, colors=cols,
        scale_mat=cams["scale_mat_0"].astype(np.float32),
    )
