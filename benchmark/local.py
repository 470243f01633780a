"""The inputs of the local feature loss (the DTU setting), made by the
benchmark and handed alike to the program and to the reference:

  * a Vis-MVSNet feature extractor's weights in the reference checkpoint's
    key layout, random from the seed (the real ``ckpt/vismvsnet.pt`` is not
    in the repository): He-scaled convolutions, BatchNorms with random
    affine parameters and running statistics (the port's
    ``data/synthetic.random_vismvsnet_state``);
  * the extractor's input batch of the three train views: their 8-bit
    pixels in BGR order / 256, resized bilinearly to the depth cameras'
    resolution times ``feat_img_scale``, then ``(img / 2 + 0.5 - mean) /
    std`` with ImageNet's statistics (reference ``dtu.py:195-196, 222``);
  * the views' MVS cameras in the world frame of ``scale_mat``, their
    intrinsics at ``depth_res`` times ``feat_img_scale`` (``cams_hd``), and
    the denormalisation ``size = 2 scale_mat[0, 0]``, ``center =
    scale_mat[:3, 3]``.
"""

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)
SRC_MAP = ((1, 2), (0, 2), (0, 1))     # dtu.py:311-331


def random_vismvsnet_state(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(key, c_out, c_in, k):
        sd[key] = rng.normal(0, np.sqrt(2.0 / (c_in * k * k)),
                             (c_out, c_in, k, k))

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = rng.uniform(0.5, 1.5, c)
        sd[f"{prefix}.bias"] = rng.uniform(-0.2, 0.2, c)
        sd[f"{prefix}.running_mean"] = rng.normal(0, 0.1, c)
        sd[f"{prefix}.running_var"] = rng.uniform(0.5, 2.0, c)

    def block(prefix, c_in, c_out):
        conv(f"{prefix}.conv1.weight", c_out, c_in, 3)
        bn(f"{prefix}.bn1", c_out)
        conv(f"{prefix}.conv2.weight", c_out, c_out, 3)
        bn(f"{prefix}.bn2", c_out)
        if c_in != c_out:
            conv(f"{prefix}.downsample.0.weight", c_out, c_in, 1)
            bn(f"{prefix}.downsample.1", c_out)

    conv("init_conv.0.weight", 16, 3, 5)
    bn("init_conv.1", 16)
    c = 16
    for name, f in (("2d2_0", 32), ("2d4_1", 64), ("2d8_2", 128)):
        block(f"unet.enc_blocks.{name}.0", c, f)
        block(f"unet.enc_blocks.{name}.1", f, f)
        c = f
    for name, f in (("2d16_3", 64), ("2d8_4", 32)):
        sd[f"unet.dec_blocks.{name}.0.weight"] = rng.normal(
            0, np.sqrt(2.0 / (c * 9)), (c, f, 3, 3))
        conv(f"unet.dec_blocks.{name}.1.weight", f, 2 * f, 3)
        block(f"unet.dec_blocks.{name}.2.0", f, f)
        c = f
    for i, c_in in ((1, 128), (2, 64), (3, 32)):
        conv(f"final_conv_{i}.weight", 32, c_in, 3)
    return {"state_dict": {
        f"module.feat_ext.{k}": torch.from_numpy(v.astype(np.float32))
        for k, v in sd.items()}}


def feature_batch(views, img_res, depth_res, scale: int) -> np.ndarray:
    """``[3, 3, H', W']`` f32, ``(H', W') = depth_res * scale``."""
    h, w = img_res
    target = (depth_res[0] * scale, depth_res[1] * scale)
    rgb = np.clip(np.asarray(views["rgb"]), 0.0, 1.0).reshape(-1, h, w, 3)
    u8 = np.round(rgb * 255.0)
    bgr = torch.from_numpy(np.ascontiguousarray(u8[..., ::-1] / 256.0,
                                                dtype=np.float32))
    img = torch.nn.functional.interpolate(
        bgr.permute(0, 3, 1, 2), size=target, mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1).numpy()
    img = (img / 2 + 0.5 - IMAGENET_MEAN) / IMAGENET_STD
    return np.ascontiguousarray(img.transpose(0, 3, 1, 2), dtype=np.float32)


def mvs_cameras(views, scale_mat, img_res, depth_res, scale: int):
    """``cams_hd [3, 2, 4, 4]`` (the w2c extrinsic, then the intrinsic),
    ``size``, ``center [3]``."""
    sm = np.asarray(scale_mat, dtype=np.float64)
    cams = []
    for pose, k in zip(views["pose"], views["intrinsics"]):
        c2w = np.asarray(pose, np.float64).copy()
        c2w[:3, 3] = sm[:3, :3] @ c2w[:3, 3] + sm[:3, 3]
        cam = np.zeros((2, 4, 4), np.float32)
        cam[0] = np.linalg.inv(c2w)
        k3 = np.asarray(k, np.float64)[:3, :3].copy()
        k3[:2] *= depth_res[0] / img_res[0] * scale
        cam[1, :3, :3] = k3
        cam[1, 3, 3] = 1.0
        cams.append(cam)
    return (np.stack(cams), float(sm[0, 0]) * 2.0,
            sm[:3, 3].astype(np.float32))


def local_inputs(local: dict, views, img_res, seed: int) -> dict:
    scale = local.get("feat_img_scale", 2)
    cams, size, center = mvs_cameras(views, local["scale_mat"], img_res,
                                     local["depth_res"], scale)
    return {"state": random_vismvsnet_state(seed),
            "images": feature_batch(views, img_res, local["depth_res"],
                                    scale),
            "cams_hd": cams, "size": size, "center": center,
            "src": [list(SRC_MAP[i]) for i in range(len(cams))]}
