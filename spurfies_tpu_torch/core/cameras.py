"""Camera geometry: pixel lifting, ray generation, projection and the
P-matrix decomposition (port of ``spurfies_tpu/core/cameras.py``; reference
``spurfies/utils/rend_util.py:36-57,60-156,200-216``).

The device functions are torch; the P decomposition is host numpy (dataset
loading only).
"""

import numpy as np
import torch

from spurfies_tpu_torch.device import constant


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


def project(world_pts: torch.Tensor, pose: torch.Tensor,
            intrinsics: torch.Tensor):
    """World points ``[B, N, 3]`` -> pixel coords (reference ``get_uv``,
    rend_util.py:97-130); pose/intrinsics ``[B, 4, 4]``.  Returns (x
    ``[B, N]``, y ``[B, N]``, z_cam ``[B, N]``)."""
    fx = intrinsics[:, 0, 0][:, None]
    fy = intrinsics[:, 1, 1][:, None]
    cx = intrinsics[:, 0, 2][:, None]
    cy = intrinsics[:, 1, 2][:, None]
    sk = intrinsics[:, 0, 1][:, None]

    rel = world_pts - pose[:, None, :3, 3]
    pts_cam = torch.einsum("bnj,bji->bni", rel, pose[:, :3, :3])
    x_lift, y_lift, z = pts_cam[..., 0], pts_cam[..., 1], pts_cam[..., 2]
    y = y_lift / z * fy + cy
    x = x_lift / z * fx + cx - cy * sk / fy + sk * y / fy
    return x, y, z


def get_sphere_intersections(cam_loc: torch.Tensor, ray_dirs: torch.Tensor,
                             r: float = 1.0) -> torch.Tensor:
    """Near/far distances ``[n_rays, 2]`` of rays with a sphere of radius
    ``r``, clamped at 0.  The reference exits when a ray misses the sphere
    (rend_util.py:209-211); here a miss gives 0s and the caller decides."""
    ray_cam_dot = torch.sum(ray_dirs * cam_loc, dim=-1, keepdim=True)
    under_sqrt = ray_cam_dot ** 2 - (
        torch.sum(cam_loc ** 2, dim=-1, keepdim=True) - r ** 2)
    sqrt_term = torch.sqrt(torch.clamp(under_sqrt, min=0.0))
    sign = constant((-1.0, 1.0), sqrt_term.dtype, sqrt_term.device)
    return torch.clamp(sqrt_term * sign - ray_cam_dot, min=0.0)


# ---------------------------------------------------------------------------
# Host-side (numpy) camera utilities for dataset loading.
# ---------------------------------------------------------------------------

def load_K_Rt_from_P(P: np.ndarray):
    """Decompose a 3x4 projection matrix into (intrinsics 4x4, pose 4x4 c2w).

    Same contract as the reference (rend_util.py:36-57) but via RQ
    factorization instead of cv2.decomposeProjectionMatrix.
    """
    P = np.asarray(P, dtype=np.float64)[:3, :4]
    M = P[:, :3]

    # RQ decomposition of M = K R via QR of the flipped transpose.
    flip = np.array([[0, 0, 1], [0, 1, 0], [1, 0, 0]], dtype=np.float64)
    Q_, R_ = np.linalg.qr((flip @ M).T)
    K = flip @ R_.T @ flip
    R = flip @ Q_.T

    # Make diagonal of K positive.
    signs = np.sign(np.diag(K))
    signs[signs == 0] = 1.0
    T_fix = np.diag(signs)
    K = K @ T_fix
    R = T_fix @ R
    if np.linalg.det(R) < 0:
        K = -K
        R = -R

    # Camera center: c = -M^-1 p4 (null space of P).
    c = -np.linalg.solve(M, P[:, 3])

    K = K / K[2, 2]
    intrinsics = np.eye(4)
    intrinsics[:3, :3] = K

    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T  # world-from-camera rotation
    pose[:3, 3] = c
    return intrinsics.astype(np.float64), pose
