"""Camera geometry: pixel lifting and ray generation (port of the device
functions of ``spurfies_tpu/core/cameras.py``; reference
``spurfies/utils/rend_util.py:60-95,143-156``)."""

import torch


def lift(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
         intrinsics: torch.Tensor) -> torch.Tensor:
    """Unproject pixels ``[B, N]`` to homogeneous camera coords
    ``[B, N, 4]`` (pinhole + skew; intrinsics ``[B, 4, 4]`` or ``[B, 3, 3]``).
    """
    fx = intrinsics[:, 0, 0][:, None]
    fy = intrinsics[:, 1, 1][:, None]
    cx = intrinsics[:, 0, 2][:, None]
    cy = intrinsics[:, 1, 2][:, None]
    sk = intrinsics[:, 0, 1][:, None]

    x_lift = (x - cx + cy * sk / fy - sk * y / fy) / fx * z
    y_lift = (y - cy) / fy * z
    return torch.stack([x_lift, y_lift, z, torch.ones_like(z)], dim=-1)


def get_camera_params(uv: torch.Tensor, pose: torch.Tensor,
                      intrinsics: torch.Tensor):
    """Pixel coords ``[B, N, 2]`` -> (unit world ray directions ``[B, N, 3]``,
    camera centres ``[B, 3]``); pose is camera-to-world ``[B, 4, 4]``."""
    cam_loc = pose[:, :3, 3]
    x_cam = uv[:, :, 0]
    y_cam = uv[:, :, 1]
    z_cam = torch.ones_like(x_cam)

    pts_cam = lift(x_cam, y_cam, z_cam, intrinsics)
    world = torch.einsum("bij,bnj->bni", pose[:, :3, :3],
                         pts_cam[:, :, :3]) + cam_loc[:, None, :]
    ray_dirs = world - cam_loc[:, None, :]
    ray_dirs = ray_dirs / torch.linalg.norm(ray_dirs, dim=-1, keepdim=True)
    return ray_dirs, cam_loc
