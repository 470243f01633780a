"""The port's evaluation modules against the JAX package's, on the CPU.

Each case feeds both packages the same seeded inputs (numpy):

* ``ssim``, ``marching_tetrahedra`` (with ``largest_component``),
  ``extract_mesh`` (with an analytic numpy ``sdf_fn``, its grid points
  too), ``grid_bounds_dtu``, ``calibrate_iso_level`` and the mesh PLY
  writer and reader: bit-equal;
* ``clean_mesh`` on the fixtures of ``tests/test_eval.py`` (the JAX side
  dilates with cv2): the same faces;
* ``sample_triangles`` bit-equal; ``radius_downsample`` the same keep set as
  the JAX package's native and sklearn paths; ``chamfer_dtu`` within 1e-9
  relative (scipy's cKDTree against sklearn's KDTree);
* ``lpips`` within 1e-5 relative of the JAX package's on random weights;
* ``evaluate_views`` with one render function for both: equal per-view
  PSNR/SSIM lists; and its three differences by design.
"""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import struct

import numpy as np
import pytest
import test_eval
import torch

import spurfies_tpu.native as jnative
from spurfies_tpu.data.scene_data import SceneData as JSceneData
from spurfies_tpu.data.scene_data import ViewSet as JViewSet
from spurfies_tpu.eval import chamfer as jchamfer
from spurfies_tpu.eval import clean_mesh as jclean
from spurfies_tpu.eval import lpips_jax as jlpips
from spurfies_tpu.eval import marching as jmarching
from spurfies_tpu.eval import mesh_extract as jmesh
from spurfies_tpu.eval import nvs as jnvs
from spurfies_tpu.eval import ssim as jssim
from spurfies_tpu_torch.data.scene_data import SceneData, ViewSet
from spurfies_tpu_torch.eval import chamfer, clean_mesh, lpips, marching
from spurfies_tpu_torch.eval import mesh_extract, nvs, ssim

SCALE_MAT = np.array([[2.0, 0, 0, 0.05], [0, 2.0, 0, 0], [0, 0, 2.0, 0],
                      [0, 0, 0, 1.0]])


@pytest.mark.parametrize("shape", [(40, 52), (33, 47, 3)])
def test_ssim_matches_jax(shape):
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, shape)
    b = np.clip(a + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    assert ssim.ssim(a, b) == jssim.ssim(a, b)


def _fields():
    rng = np.random.default_rng(1)
    g = np.linspace(-1, 1, 30)
    X, Y, Z = np.meshgrid(g, g[:23], g[4:], indexing="ij")
    sphere = np.sqrt(X ** 2 + Y ** 2 + Z ** 2) - 0.6
    two = np.minimum(np.sqrt((X - 0.5) ** 2 + Y ** 2 + Z ** 2) - 0.3,
                     np.sqrt((X + 0.5) ** 2 + Y ** 2 + Z ** 2) - 0.2)
    return {
        "random": (rng.normal(size=(9, 7, 11)).astype(np.float32), 0.0),
        "random_level": (rng.normal(size=(6, 13, 5)), 0.3),
        "sphere": (sphere.astype(np.float32), 0.0),
        "sphere_level": (sphere, -0.1),
        "two_spheres": (two.astype(np.float32), 0.02),
        "no_surface": (np.ones((4, 5, 6), np.float32), 0.0),
        "flat": (np.zeros((1, 5, 6), np.float32), 0.5),
    }


@pytest.mark.parametrize("name", list(_fields()))
def test_marching_matches_jax(name):
    """Faces and vertices bit-equal (slabs of a few x-planes), then the
    largest component's."""
    sdf, level = _fields()[name]
    sp, org = (0.07, 0.05, 0.11), (-1.0, 0.25, 3.0)
    got = marching.marching_tetrahedra(sdf, level, sp, org, slab_cubes=300)
    ref = jmarching.marching_tetrahedra(sdf, level, sp, org)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    for a, b in zip(marching.largest_component(*got),
                    jmarching.largest_component(*ref)):
        np.testing.assert_array_equal(a, b)


def _sdf_fn(log):
    def sdf_fn(x):
        x = np.asarray(x)
        log.append(x.copy())
        return (np.sqrt((x.astype(np.float64) ** 2).sum(-1)) - 0.5
                ).astype(np.float32)
    return sdf_fn


@pytest.mark.parametrize("level,scale_mat,keep", [
    (0.0, None, True), (0.04, SCALE_MAT, True), (-0.03, SCALE_MAT, False)])
def test_extract_mesh_matches_jax(level, scale_mat, keep):
    """The grid points handed to ``sdf_fn`` chunk by chunk and the mesh are
    the JAX package's, bit for bit."""
    got_pts, ref_pts = [], []
    lo, hi = [-0.8, -0.7, -0.75], [0.8, 0.75, 0.7]
    got = mesh_extract.extract_mesh(_sdf_fn(got_pts), lo, hi, resolution=29,
                                    chunk=5000, scale_mat=scale_mat,
                                    keep_largest=keep, level=level,
                                    device="cpu")
    ref = jmesh.extract_mesh(_sdf_fn(ref_pts), lo, hi, resolution=29,
                             chunk=5000, scale_mat=scale_mat,
                             keep_largest=keep, level=level)
    assert len(got_pts) == len(ref_pts) > 1
    for a, b in zip(got_pts, ref_pts):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(ref[1]) > 0
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # no crossing of the level: an empty mesh in both
    got = mesh_extract.extract_mesh(lambda x: np.full(len(x), 1000.0), lo,
                                    hi, resolution=9, device="cpu")
    assert got[0].shape == (0, 3) and got[1].shape == (0, 3)


@pytest.mark.parametrize("scan", [24, 82, 21, 34, 38, 37])
def test_grid_bounds_dtu_matches_jax(tmp_path, scan):
    """With the reference's aliases (82 -> 83; 21, 34, 38 -> 24)."""
    rng = np.random.default_rng(scan)
    boxes = {str(s): np.sort(rng.normal(size=(2, 3)) * 100, 0)
             for s in (24, 37, 83)}
    path = tmp_path / "bbs.npz"
    np.savez(path, **boxes)
    got = mesh_extract.grid_bounds_dtu(str(path), scan, SCALE_MAT)
    ref = jmesh.grid_bounds_dtu(str(path), scan, SCALE_MAT)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_calibrate_iso_level_matches_jax():
    rng = np.random.default_rng(3)
    pts = (rng.normal(size=(20000, 3)) * 0.3).astype(np.float32)

    def sdf_fn(x):
        return (np.linalg.norm(np.asarray(x), axis=-1) - 0.5).astype(
            np.float32)
    ref = jmesh.calibrate_iso_level(pts, sdf_fn)
    assert mesh_extract.calibrate_iso_level(pts, sdf_fn) == ref
    assert mesh_extract.calibrate_iso_level(torch.from_numpy(pts),
                                            sdf_fn) == ref
    assert mesh_extract.calibrate_iso_level(
        pts, lambda x: np.full(len(x), 5.0)) == 0.0


def test_mesh_ply_matches_jax(tmp_path):
    """The writer's bytes, and the reader on binary (triangles; a quad)
    and ascii files."""
    verts, faces = jmarching.marching_tetrahedra(*_fields()["sphere"])
    verts = verts.astype(np.float32)
    mesh_extract.save_mesh_ply(str(tmp_path / "a.ply"), verts, faces)
    jmesh.save_mesh_ply(str(tmp_path / "b.ply"), verts, faces)
    assert (tmp_path / "a.ply").read_bytes() == \
        (tmp_path / "b.ply").read_bytes()
    ascii_ply = tmp_path / "c.ply"
    ascii_ply.write_text(
        "ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\n"
        "property float y\nproperty float z\nelement face 1\n"
        "property list uchar int vertex_indices\nend_header\n"
        "0 0 0\n1 0 0.5\n0 1 2\n3 0 1 2\n")
    # a quad face and an element after the faces: record by record
    quad = tmp_path / "d.ply"
    quad.write_bytes(
        b"ply\nformat binary_little_endian 1.0\nelement vertex 4\n"
        b"property float x\nproperty float y\nproperty float z\n"
        b"element face 3\nproperty list uchar int vertex_indices\n"
        b"element extra 1\nproperty float q\nend_header\n"
        + np.arange(12, dtype="<f4").tobytes()
        + struct.pack("<B3i", 3, 0, 1, 2) + struct.pack("<B4i", 4, 1, 2, 3, 0)
        + struct.pack("<B3i", 3, 2, 3, 0) + struct.pack("<f", 7.0))
    for path in ("a.ply", "c.ply", "d.ply"):
        got = mesh_extract.load_mesh_ply(str(tmp_path / path))
        ref = jmesh.load_mesh_ply(str(tmp_path / path))
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _clean_fixture():
    verts, faces, _, mats, res = test_eval.TestVisibilityCleaning._scene()
    rng = np.random.default_rng(4)
    masks = [(rng.random(res) < 0.02).astype(np.float32) for _ in mats]
    masks[0][:] = 0.0
    masks[0][10:30, 20:40] = 1.0
    return verts, faces, mats, masks, res


def test_dilate_mask_is_cv2s():
    import cv2

    for m in _clean_fixture()[3]:
        np.testing.assert_array_equal(
            clean_mesh.dilate_mask(m),
            cv2.dilate(m.astype(np.uint8), np.ones((11, 11), np.uint8)))


@pytest.mark.parametrize("stage", ["masks", "visibility", "frustum", "all"])
def test_clean_mesh_matches_jax(stage):
    """The fixtures of ``tests/test_eval.py:162-220`` (an outer sphere
    hiding an inner one, 8 views) with seeded masks: the same faces and
    vertices from each pass and from the whole pipeline."""
    verts, faces, mats, masks, res = _clean_fixture()
    if stage == "masks":
        got = clean_mesh.clean_mesh_by_masks(verts, faces, mats, masks)
        ref = jclean.clean_mesh_by_masks(verts, faces, mats, masks)
    elif stage == "visibility":
        got = clean_mesh.clean_mesh_by_visibility(verts, faces, mats, res,
                                                  device="cpu")
        ref = jclean.clean_mesh_by_visibility(verts, faces, mats, res)
    elif stage == "frustum":
        got = clean_mesh.clean_mesh_by_frustum(verts, faces, mats, res, 10)
        ref = jclean.clean_mesh_by_frustum(verts, faces, mats, res, 10)
    else:
        got = clean_mesh.clean_mesh(verts, faces, mats, masks, res,
                                    min_component_faces=10, device="cpu")
        ref = jclean.clean_mesh(verts, faces, mats, masks, res,
                                min_component_faces=10)
    assert 0 < len(ref[1]) < len(faces)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def _samples():
    verts, faces, _, _, _ = test_eval.TestVisibilityCleaning._scene()
    return verts * 50.0, faces


def test_sample_triangles_matches_jax():
    verts, faces = _samples()
    np.testing.assert_array_equal(chamfer.sample_triangles(verts, faces),
                                  jchamfer.sample_triangles(verts, faces))


@pytest.mark.parametrize("path", ["native", "sklearn"])
def test_radius_downsample_matches_jax(monkeypatch, path):
    """The C++ dedup keeps the JAX package's set through its native routine
    and through its sklearn fallback; the plain version too."""
    pts = jchamfer.sample_triangles(*_samples())[::3]
    if path == "sklearn":
        monkeypatch.setattr(jnative, "radius_dedup", lambda *a: None)
    ref = jchamfer.radius_downsample(pts, 0.2)
    np.testing.assert_array_equal(chamfer.radius_downsample(pts, 0.2), ref)
    order = np.random.default_rng(0).permutation(len(pts))
    np.testing.assert_array_equal(
        pts[order][chamfer.radius_dedup_ref(pts[order], 0.2)], ref)
    assert 0.1 * len(pts) < len(ref) < len(pts)


@pytest.mark.parametrize("with_masks", [False, True])
def test_chamfer_dtu_matches_jax(with_masks):
    """acc, comp and overall within 1e-9 relative (exact nearest
    neighbours both: cKDTree and sklearn's KDTree), with and without an
    ObsMask and a ground plane."""
    verts, faces = _samples()
    rng = np.random.default_rng(6)
    gt = verts[::2] + rng.normal(size=verts[::2].shape) * 0.3
    obs = plane = None
    if with_masks:
        bb = np.stack([gt.min(0) - 5, gt.max(0) + 5])
        shape = np.ceil((bb[1] - bb[0]) / 2.0).astype(int)
        obs = {"ObsMask": rng.random(shape) < 0.7, "BB": bb,
               "Res": np.array([[2.0]])}
        plane = {"P": np.array([[0.0], [1.0], [0.0], [5.0]])}
    got = chamfer.chamfer_dtu(verts, faces, gt, obs, plane)
    ref = jchamfer.chamfer_dtu(verts, faces, gt, obs, plane)
    for k in ("acc", "comp", "overall"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-9, atol=0)
    assert np.isfinite(got["overall"])


def _vgg_states(seed=0):
    """Random torchvision-VGG16 and LPIPS-linear state dicts."""
    gen = torch.Generator().manual_seed(seed)
    vgg, c = {}, 3
    outs = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
    for i, o in zip(lpips.CONV_IDX, outs):
        vgg[f"features.{i}.weight"] = torch.randn(
            o, c, 3, 3, generator=gen) * np.sqrt(2.0 / (9 * c))
        vgg[f"features.{i}.bias"] = torch.randn(o, generator=gen) * 0.01
        c = o
    lin = {f"lin{i}.model.1.weight": torch.rand(1, ch, 1, 1, generator=gen)
           * 0.1 for i, ch in enumerate(lpips.CHANNELS)}
    return vgg, lin


def test_lpips_matches_jax(tmp_path):
    """Within 1e-5 relative (f32 convolutions summed in other orders);
    ``make_lpips_fn`` reads the two checkpoints, or returns None."""
    vgg, lin = _vgg_states()
    rng = np.random.default_rng(7)
    a = rng.uniform(0, 1, (32, 48, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    ref = float(jlpips.lpips(jlpips.convert_vgg16_features(vgg),
                             jlpips.convert_lpips_linear(lin), a, b))
    got = lpips.lpips(lpips.convert_vgg16_features(vgg, "cpu"),
                      lpips.convert_lpips_linear(lin, "cpu"), a, b)
    assert abs(float(got) - ref) <= 1e-5 * abs(ref)
    vgg_path, lin_path = str(tmp_path / "vgg.pth"), str(tmp_path / "lin.pth")
    assert lpips.make_lpips_fn(vgg_path, lin_path, device="cpu") is None
    torch.save(vgg, vgg_path)
    torch.save(lin, lin_path)
    fn = lpips.make_lpips_fn(vgg_path, lin_path, device="cpu")
    assert fn(a, b) == float(got)


def _scene(ids=(1, 2, 5, 9)):
    rng = np.random.default_rng(8)
    h, w, v = 24, 32, len(ids)
    rgb = rng.uniform(0, 1, (v, h * w, 3)).astype(np.float32)
    mask = np.repeat((rng.random((v, h * w, 1)) < 0.6).astype(np.float32),
                     3, -1)
    pose = np.tile(np.eye(4, dtype=np.float32), (v, 1, 1))
    pose[:, 0, 3] = np.arange(v)
    intr = np.tile(np.eye(4, dtype=np.float32), (v, 1, 1))
    views = dict(rgb=rgb, mask=mask, pose=pose, intrinsics=intr,
                 ids=list(ids))
    points = np.zeros((0, 3), np.float32)
    return (SceneData("24", (h, w), ViewSet(**views), ViewSet(**views),
                      points, None, np.eye(4)),
            JSceneData("24", (h, w), JViewSet(**views), JViewSet(**views),
                       points, None, np.eye(4)))


def _render(uv, pose, intrinsics):
    """A render of view ``pose[0, 3]``: its image plus seeded noise."""
    rng = np.random.default_rng(int(pose[0, 3]))
    n = len(uv)
    return {"rgb_values": rng.uniform(0, 1, (n, 3)).astype(np.float32),
            "normal_map": rng.normal(size=(n, 3)).astype(np.float32),
            "depth_values": rng.uniform(1, 3, (n, 1)).astype(np.float32),
            "acc": rng.uniform(0, 1, (n, 1)).astype(np.float32)}


def test_evaluate_views_matches_jax(tmp_path):
    sd, jsd = _scene()
    got = nvs.evaluate_views(_render, sd, out_dir=str(tmp_path / "t"),
                             max_views=3)
    ref = jnvs.evaluate_views(lambda p, uv, pose, k, key: _render(uv, pose,
                                                                   k),
                              None, jsd, out_dir=str(tmp_path / "j"),
                              max_views=3)
    for k in ("psnr", "ssim", "ids", "mean_psnr", "mean_ssim"):
        assert got[k] == ref[k], k
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j").iterdir())
    got = nvs.evaluate_views(_render, sd, view_ids=[9, "2"],
                             lpips_fn=lambda a, b: 0.5)
    ref = jnvs.evaluate_views(lambda p, uv, pose, k, key: _render(uv, pose,
                                                                   k),
                              None, jsd, view_ids=[9, 2],
                              lpips_fn=lambda a, b: 0.5)
    for k in ("psnr", "ssim", "ids", "lpips", "mean_lpips"):
        assert got[k] == ref[k], k


def test_evaluate_views_raises_on_an_empty_selection():
    """A difference by design: JAX scores no view and writes NaN means."""
    sd, _ = _scene()
    with pytest.raises(ValueError, match="no eval view"):
        nvs.evaluate_views(_render, sd, view_ids=[3, 4])


def test_evaluate_views_compares_ids_as_strings():
    """A difference by design: string view ids select (JAX's ``int()``
    raises on them)."""
    sd, _ = _scene(ids=("a", "b7", "c"))
    got = nvs.evaluate_views(_render, sd, view_ids=["b7", "c"])
    assert got["ids"] == ["b7", "c"] and len(got["psnr"]) == 2


def test_evaluate_views_says_when_lpips_is_skipped():
    """A difference by design: without LPIPS the result holds
    ``lpips: None`` and the reason (JAX leaves an empty list)."""
    sd, _ = _scene()
    got = nvs.evaluate_views(_render, sd, max_views=1)
    assert got["lpips"] is None and "ckpt/vgg16.pth" in \
        got["lpips_skipped_reason"] and "mean_lpips" not in got
