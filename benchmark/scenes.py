"""The benchmark's scenes: frozen copies of the port's synthetic scene
generators (``spurfies_tpu_torch/data/synthetic.py`` and the greedy
subsample of ``prep/pointcloud.py``), so that a change to the program
cannot change what is measured.

A coloured sphere with analytically rendered ground-truth views
(``make_synthetic_scene``), and a cloud with DUSt3R output statistics
around it (``make_dust3r_like_scene``).  Both return ``(points [M, 3],
colours [M, 3] in 0..255, views)`` with views ``rgb [V, HW, 3]``, ``mask
[V, HW, 1]``, ``uv [HW, 2]``, ``pose [V, 4, 4]``, ``intrinsics [V, 4,
4]`` (numpy f32).
"""

import numpy as np


def greedy_spacing_subsample(points, spacing: float = 0.025, seed: int = 0):
    """Greedy subsample: accept a point if no already-accepted point lies
    within ``spacing``, visiting points in order.  Grid-hash accelerated
    with a cell size of ``spacing``.

    The same decisions as the JAX package's Python fallback (and its
    native kernel): distances in float64, compared with ``spacing**2``;
    the accepted points are kept as Python floats instead of numpy rows,
    which is the same float64 arithmetic without a numpy call per test.
    """
    pts = np.asarray(points)
    n = len(pts)
    cell = spacing
    lo = pts.min(0) - cell
    ijk = np.floor((pts - lo) / cell).astype(np.int64)
    dims = ijk.max(0) + 2
    lin = ((ijk[:, 0] * dims[1] + ijk[:, 1]) * dims[2] + ijk[:, 2]).tolist()
    offsets = [(dx * dims[1] + dy) * dims[2] + dz
               for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
    offsets = [int(o) for o in offsets]
    coords = pts.astype(np.float64).tolist()
    occupied: dict = {}
    keep = np.zeros(n, dtype=bool)
    sp2 = spacing * spacing
    for i in range(n):
        c = lin[i]
        x, y, z = coords[i]
        ok = True
        for off in offsets:
            lst = occupied.get(c + off)
            if lst:
                for (px, py, pz) in lst:
                    dx, dy, dz = px - x, py - y, pz - z
                    if (dx * dx + dy * dy) + dz * dz < sp2:
                        ok = False
                        break
                if not ok:
                    break
        if ok:
            keep[i] = True
            occupied.setdefault(c, []).append((x, y, z))
    return np.nonzero(keep)[0]


def look_at(eye, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)):
    """c2w pose with camera -z... following the reference convention the
    camera looks along +z in camera frame (lift produces z=+1)."""
    eye = np.asarray(eye, dtype=np.float64)
    fwd = np.asarray(target, dtype=np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, dtype=np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0] = right
    pose[:3, 1] = down
    pose[:3, 2] = fwd
    pose[:3, 3] = eye
    return pose


def _sphere_color(normal):
    return 0.5 + 0.5 * normal  # in [0,1]


def make_synthetic_scene(n_points=4000, n_views=3, img_res=(64, 64),
                         radius=0.5, cam_dist=1.5, focal=None, seed=0,
                         view_ids=None, images=True):
    """Build (point_cloud, colors_uint8, views dict) for a colored sphere.

    view_ids: the views of the ``n_views`` around the sphere to render, in
    this order (default all); the others are not computed.  images=False
    gives the cameras only (rgb and mask zero).

    views: rgb [V, HW, 3], mask [V, HW, 1], uv [HW, 2],
           pose [V, 4, 4], intrinsics [V, 4, 4]  (numpy float32).
    """
    rng = np.random.default_rng(seed)
    h, w = img_res
    focal = focal or 1.2 * w

    v = rng.normal(size=(n_points, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    pts = (radius * v).astype(np.float32)
    cols = (_sphere_color(v) * 255.0).astype(np.float32)

    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = focal
    K[0, 2], K[1, 2] = w / 2.0, h / 2.0

    yy, xx = np.mgrid[0:h, 0:w]
    uv = np.stack([xx, yy], axis=-1).reshape(-1, 2).astype(np.float32)

    rgbs, masks, poses = [], [], []
    for i in (range(n_views) if view_ids is None else view_ids):
        ang = 2 * np.pi * i / max(n_views, 1) + 0.3
        eye = cam_dist * np.array(
            [np.cos(ang), 0.35, np.sin(ang)]
        )
        pose = look_at(eye)
        poses.append(pose)
        if not images:
            rgbs.append(np.zeros((h * w, 3), np.float32))
            masks.append(np.zeros((h * w, 1), np.float32))
            continue

        # analytic ray-sphere ground truth
        x_l = (uv[:, 0] - K[0, 2]) / K[0, 0]
        y_l = (uv[:, 1] - K[1, 2]) / K[1, 1]
        dirs_cam = np.stack([x_l, y_l, np.ones_like(x_l)], -1)
        dirs = dirs_cam @ pose[:3, :3].T
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        oc = pose[:3, 3]
        b = np.sum(dirs * oc, -1)
        c = np.sum(oc * oc) - radius ** 2
        disc = b * b - c
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0))
        hit &= t > 0
        p_hit = oc + t[:, None] * dirs
        normal = p_hit / np.maximum(
            np.linalg.norm(p_hit, axis=-1, keepdims=True), 1e-9
        )
        rgb = np.where(hit[:, None], _sphere_color(normal), 0.0)
        rgbs.append(rgb.astype(np.float32))
        masks.append(hit[:, None].astype(np.float32))

    views = {
        "rgb": np.stack(rgbs),
        "mask": np.stack(masks),
        "uv": uv,
        "pose": np.stack(poses),
        "intrinsics": np.stack([K] * len(poses)),
    }
    return pts, cols, views


def make_dust3r_like_scene(n_points=8000, n_views=3, img_res=(192, 256),
                           radius=0.8, cam_dist=2.4, noise_sigma=0.008,
                           spacing=0.025, seed=0):
    """Synthetic scene whose POINT CLOUD matches DUSt3R output statistics
    (VERDICT r2 #8: the clean uniform sphere understates production query
    cost).  DUSt3R clouds (dust3r_inference.py:69-140) differ from the
    ideal sphere in three ways reproduced here:

      * partial coverage — only surface visible from the 3 cameras
        survives (back side missing; rays pass through holes),
      * depth noise — each point is displaced along its observing
        camera's VIEW RAY (stereo depth error), giving a ~noise_sigma
        thick anisotropic shell (3-D neighborhoods, higher voxel
        occupancy),
      * FPS subsample to ~`spacing` (0.025, the reference's setting) —
        near-uniform spacing but view-biased density at the rims.

    Ground-truth views stay analytic (the true sphere), so quality gates
    keep working.  Returns the same (pts, cols, views) tuple.
    """
    rng = np.random.default_rng(seed)
    base = make_synthetic_scene(n_points=4, n_views=n_views,
                                img_res=img_res, radius=radius,
                                cam_dist=cam_dist, seed=seed)
    _, _, views = base
    cam_centers = views["pose"][:, :3, 3]                 # [V, 3]

    # oversample the surface, then visibility-filter + noise + FPS
    v = rng.normal(size=(n_points * 8, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    surf = radius * v

    to_cam = cam_centers[None] - surf[:, None]            # [N, V, 3]
    to_cam /= np.linalg.norm(to_cam, axis=-1, keepdims=True)
    facing = np.einsum("nvi,ni->nv", to_cam, v)           # cos(normal, dir)
    vis = facing > 0.15                                    # grazing cutoff
    seen = vis.any(-1)
    surf, v, to_cam, vis = surf[seen], v[seen], to_cam[seen], vis[seen]

    # displace along a random OBSERVING camera's ray (stereo depth error)
    obs = np.array([rng.choice(np.flatnonzero(m)) for m in vis])
    ray = -to_cam[np.arange(len(surf)), obs]              # cam -> point
    depth_err = rng.normal(0.0, noise_sigma, len(surf))
    pts = surf + ray * depth_err[:, None]

    order = rng.permutation(len(pts))
    pts = pts[order]
    v = v[order]
    keep = greedy_spacing_subsample(pts, spacing)
    pts, v = pts[keep], v[keep]

    cols = (_sphere_color(v) * 255.0).astype(np.float32)
    return pts.astype(np.float32), cols, views
