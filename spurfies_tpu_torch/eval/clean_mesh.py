"""Mesh cleaning for the DTU Chamfer protocol (port of
``spurfies_tpu/eval/clean_mesh.py``).

Behavioral spec from reference ``evals/clean_mesh.py``:
  * mask pass (:135-209): project every vertex into all 49 views; a vertex
    is 'seen' if it lands inside the 11px-dilated foreground mask; keep
    faces whose 3 vertices are each seen in >= 1 view;
  * visibility pass (:258-344, a trimesh+pyembree ray cast there): a
    z-buffer test per view -- on the device here, the JAX package's
    slowest stage (faces x 13 samples x 49 views);
  * frustum pass: drop faces outside every view frustum, then keep
    components with >= 500 faces.

The mask pass dilates with an 11x11 max filter (scipy), equal to the JAX
package's ``cv2.dilate`` with a ones kernel; the mask and frustum passes
are host numpy/scipy as there.
"""

import numpy as np
import torch
from scipy.ndimage import maximum_filter

from spurfies_tpu_torch.device import resolve_device

# fixed barycentric sample grid covering a triangle (vertices, edge
# midpoints, interior): a bounded micro-rasterizer per face
BARY = np.array([
    [1, 0, 0], [0, 1, 0], [0, 0, 1],
    [.5, .5, 0], [.5, 0, .5], [0, .5, .5],
    [1 / 3, 1 / 3, 1 / 3],
    [2 / 3, 1 / 6, 1 / 6], [1 / 6, 2 / 3, 1 / 6], [1 / 6, 1 / 6, 2 / 3],
    [.5, .25, .25], [.25, .5, .25], [.25, .25, .5],
])


def project_vertices(verts, world_mat):
    """[N, 3] x P(3x4 or 4x4) -> pixel (x, y), depth (host numpy)."""
    P = np.asarray(world_mat)[:3, :4]
    h = np.concatenate([verts, np.ones((len(verts), 1))], -1)
    pix = h @ P.T
    z = pix[:, 2]
    return pix[:, 0] / z, pix[:, 1] / z, z


def dilate_mask(mask, px: int = 11):
    """``cv2.dilate(mask.astype(uint8), ones((px, px)))``: a px x px max
    filter centred on each pixel, pixels outside the image ignored."""
    return maximum_filter(np.asarray(mask).astype(np.uint8), size=px,
                          mode="constant", cval=0)


def clean_mesh_by_masks(verts, faces, world_mats, masks,
                        dilate_px: int = 11):
    """Mask-visibility cleaning (reference clean_mesh_faces_by_mask).

    Args:
      world_mats: list of projection matrices (world_mat @ scale_mat as the
        reference composes, clean_mesh.py:156-168).
      masks: list of [H, W] {0,1} foreground masks.
    """
    seen = np.zeros(len(verts), dtype=bool)
    for P, mask in zip(world_mats, masks):
        m = dilate_mask(mask, dilate_px)
        hgt, wid = m.shape
        x, y, z = project_vertices(verts, P)
        xi = np.round(x).astype(int)
        yi = np.round(y).astype(int)
        inb = (z > 0) & (xi >= 0) & (xi < wid) & (yi >= 0) & (yi < hgt)
        hit = np.zeros(len(verts), dtype=bool)
        hit[inb] = m[yi[inb], xi[inb]] > 0
        seen |= hit
    keep_face = seen[faces].all(axis=-1)
    return _reindex(verts, faces[keep_face])


def clean_mesh_by_frustum(verts, faces, world_mats, img_res,
                          min_component_faces: int = 500):
    """Frustum culling + small-component removal
    (reference clean_mesh_faces_outside_frustum semantics)."""
    hgt, wid = img_res
    inside = np.zeros(len(verts), dtype=bool)
    for P in world_mats:
        x, y, z = project_vertices(verts, P)
        inside |= (z > 0) & (x >= 0) & (x < wid) & (y >= 0) & (y < hgt)
    keep_face = inside[faces].all(axis=-1)
    verts, faces = _reindex(verts, faces[keep_face])

    if len(faces) == 0:
        return verts, faces
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n = len(verts)
    rows = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    cols = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    adj = coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    _, labels = connected_components(adj, directed=False)
    fl = labels[faces[:, 0]]
    sizes = np.bincount(fl)
    keep = sizes[fl] >= min_component_faces
    if not keep.any():  # keep largest if everything is small
        keep = fl == sizes.argmax()
    return _reindex(verts, faces[keep])


def _reindex(verts, faces):
    used = np.unique(faces)
    remap = -np.ones(len(verts), dtype=np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[faces]


def clean_mesh_by_visibility(verts, faces, world_mats, img_res,
                             rel_tol: float = 0.03, device="cuda"):
    """Drop faces first-hit by NO view -- the reference's ray-cast pass
    (clean_mesh.py:258-344, trimesh + pyembree) as a z-buffer test on
    ``device``.

    Per view: scatter-min each face's depth at the pixels of its BARY
    samples (``scatter_reduce(amin)``, the same minimum in any order), then
    a face is visible iff one of its samples' depths is within ``rel_tol``
    of the buffer minimum at that pixel; then two rings of faces touching
    a visible vertex (grazing-angle faces lose the depth race by a hair).
    float64 throughout, as the JAX package computes it on the host."""
    if len(faces) == 0:
        return verts, faces
    dev = resolve_device(device)
    hgt, wid = img_res
    f = len(faces)
    faces_t = torch.as_tensor(np.asarray(faces), device=dev)
    tri = torch.as_tensor(np.asarray(verts, np.float64), device=dev)[faces_t]
    bary = torch.as_tensor(BARY, device=dev)
    nb = len(BARY)
    # sum_j bary[b, j] tri[f, j, c], j in order
    pts = (bary[None, :, 0, None] * tri[:, None, 0]
           + bary[None, :, 1, None] * tri[:, None, 1]) \
        + bary[None, :, 2, None] * tri[:, None, 2]
    h = torch.cat([pts.reshape(-1, 3),
                   torch.ones((f * nb, 1), dtype=torch.float64,
                              device=dev)], -1)
    del pts, tri
    visible = torch.zeros(f, dtype=torch.bool, device=dev)
    zbuf = torch.empty(hgt * wid + 1, dtype=torch.float64, device=dev)
    for P in world_mats:
        pix = h @ torch.as_tensor(np.asarray(P)[:3, :4], dtype=torch.float64,
                                  device=dev).T
        z = pix[:, 2]
        xi = torch.round(pix[:, 0] / z).long()
        yi = torch.round(pix[:, 1] / z).long()
        inb = (z > 1e-6) & (xi >= 0) & (xi < wid) & (yi >= 0) & (yi < hgt)
        at = torch.where(inb, yi * wid + xi, 0)
        zbuf.fill_(float("inf"))
        # out-of-image samples go to a spare last element
        zbuf.scatter_reduce_(0, torch.where(inb, at, hgt * wid), z, "amin")
        front = inb & (z <= zbuf[at] * (1.0 + rel_tol))
        visible |= front.reshape(f, nb).any(dim=1)
        del pix, z, xi, yi, inb, at, front
    for _ in range(2):
        vis_verts = torch.zeros(len(verts), dtype=torch.bool, device=dev)
        vis_verts[faces_t[visible].reshape(-1)] = True
        visible = visible | vis_verts[faces_t].any(dim=1)
    return _reindex(verts, faces[visible.cpu().numpy()])


def clean_mesh(verts, faces, world_mats, masks, img_res,
               dilate_px: int = 11, min_component_faces: int = 500,
               visibility: bool = True, device="cuda"):
    """Full pipeline: mask pass -> visibility (ray-cast-equivalent) pass ->
    frustum + component pass (reference main loop, clean_mesh.py:382-414)."""
    verts, faces = clean_mesh_by_masks(verts, faces, world_mats, masks,
                                       dilate_px)
    if visibility and len(faces):
        verts, faces = clean_mesh_by_visibility(verts, faces, world_mats,
                                                img_res, device=device)
    return clean_mesh_by_frustum(verts, faces, world_mats, img_res,
                                 min_component_faces)
