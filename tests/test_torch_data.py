"""The port's data layer against the JAX package's and the libraries it
reads through, on the CPU.

* ``data.png``: the decoder bit-equal to imageio (Pillow) and cv2 on 8- and
  16-bit gray, gray+alpha, RGB and RGBA, on Pillow's adaptive filters and
  on rows of each of the five filter types; the encoder read back by
  imageio bit for bit.
* the resizes: ``resize_cubic`` within ``max(H, W) * 2**-22`` of
  ``cv2.INTER_CUBIC`` on [0, 1] images (each side computes its f32 source
  position its own way; the bound is two ulps of the position, times the
  cubic's slope), ``resize_nearest`` bit-equal to ``cv2.INTER_NEAREST``.
* ``load_dtu``, ``load_own_data`` and ``load_mipnerf`` of both packages on
  fixtures from both packages' exports (and a hand-made mip-NeRF scene in
  PNG and JPEG): every array of ``SceneData`` bit-equal.
* ``load_K_Rt_from_P`` bit-equal to JAX's, ``project`` and
  ``get_sphere_intersections`` within 1e-6 of JAX's.
"""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import json
import os
import struct
import sys
import zlib

import cv2
import imageio.v2 as imageio
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from spurfies_tpu.core import cameras as jcam
from spurfies_tpu.data import dtu as jdtu
from spurfies_tpu.data import mip_nerf as jmip
from spurfies_tpu.data import own_data as jown
from spurfies_tpu.data import ply as jply
from spurfies_tpu.data import scene_data as jsd
from spurfies_tpu.data import synthetic as jsyn
from spurfies_tpu_torch.core import cameras as tcam
from spurfies_tpu_torch.data import dtu as tdtu
from spurfies_tpu_torch.data import mip_nerf as tmip
from spurfies_tpu_torch.data import own_data as town
from spurfies_tpu_torch.data import ply as tply
from spurfies_tpu_torch.data import png
from spurfies_tpu_torch.data import scene_data as tsd
from spurfies_tpu_torch.data import synthetic as tsyn

MODES = {"gray": (), "gray_alpha": (2,), "rgb": (3,), "rgba": (4,)}


def _image(kind, shape, dtype, seed=0):
    """Noise (Pillow picks mostly None / Sub rows) or a smooth field with
    a little noise (Up, Average and Paeth rows)."""
    rng = np.random.default_rng(seed)
    top = np.iinfo(dtype).max
    if kind == "noise":
        return rng.integers(0, top + 1, shape, dtype=dtype)
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    f = 0.5 + 0.25 * np.sin(xx / 7.0) + 0.2 * np.cos(yy / 5.0)
    f = f.reshape(h, w, *([1] * (len(shape) - 2)))
    f = f + 0.05 * np.arange(np.prod(shape[2:], dtype=int)).reshape(shape[2:])
    f = f + rng.normal(0, 0.01, shape)
    return (np.clip(f, 0, 1) * top).astype(dtype)


def _filters(path):
    """The row filter types of a PNG file."""
    data = open(path, "rb").read()
    header, idat = None, b""
    for kind, body in png._chunks(data):
        if kind == b"IHDR":
            header = body
        elif kind == b"IDAT":
            idat += body
    w, h, depth, ctype = struct.unpack(">IIBB", header[:10])
    stride = w * png._CHANNELS[ctype] * depth // 8 + 1
    return set(np.frombuffer(zlib.decompress(idat), np.uint8)[::stride][:h]
               .tolist())


@pytest.mark.parametrize("kind", ["noise", "smooth"])
@pytest.mark.parametrize("mode,dtype", [
    (m, np.uint8) for m in MODES] + [
    (m, np.uint16) for m in ("gray", "rgb", "rgba")],
    ids=lambda v: v if isinstance(v, str) else np.dtype(v).name)
def test_png_decoder_matches_the_libraries(tmp_path, kind, mode, dtype):
    """Files written by Pillow (through imageio) and, for 16-bit colour,
    which imageio cannot write, by cv2 (libpng, channels BGR).  Neither
    writes 16-bit gray+alpha: ``test_png_encoder_read_back_by_imageio``
    decodes it."""
    shape = (37, 53) + MODES[mode]
    img = _image(kind, shape, dtype)
    path = str(tmp_path / "x.png")
    if dtype == np.uint16 and mode in ("rgb", "rgba"):
        cv2.imwrite(path, img[..., [2, 1, 0, 3][:img.shape[2]]])
        ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        ref = ref[..., [2, 1, 0, 3][:ref.shape[2]]]
    else:
        imageio.imwrite(path, img)
        ref = imageio.imread(path)
    np.testing.assert_array_equal(ref, img)
    out = png.read_png(path)
    assert out.dtype == img.dtype and out.shape == img.shape
    np.testing.assert_array_equal(out, img)
    if kind == "smooth" and dtype == np.uint8:
        assert _filters(path) & {3, 4}, "no Average / Paeth row to decode"


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, "mixed"])
def test_png_rows_of_each_filter(tmp_path, ftype):
    """Rows of one filter type (or a random mix), written by the port's
    encoder: imageio reads them back as the image, and so does the port."""
    img = _image("smooth", (41, 67, 3), np.uint8, seed=1)
    ft = (np.random.default_rng(2).integers(0, 5, 41) if ftype == "mixed"
          else ftype)
    path = str(tmp_path / "f.png")
    png.write_png(path, img, ft)
    assert _filters(path) == ({0, 1, 2, 3, 4} if ftype == "mixed"
                              else {ftype})
    np.testing.assert_array_equal(imageio.imread(path), img)
    np.testing.assert_array_equal(png.read_png(path), img)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=["8", "16"])
def test_png_encoder_read_back_by_imageio(tmp_path, mode, dtype):
    """The port's encoder (filter Sub) read back by imageio, bit for bit;
    Pillow reads 16-bit colour as its high byte (and gray+alpha as RGBA),
    which ``scene_data.read_image`` reproduces."""
    img = _image("noise", (29, 31) + MODES[mode], dtype, seed=3)
    path = str(tmp_path / "e.png")
    png.write_png(path, img)
    got = imageio.imread(path)
    if dtype == np.uint16 and img.ndim == 3:
        hi = (img >> 8).astype(np.uint8)
        np.testing.assert_array_equal(
            got, hi[..., [0, 0, 0, 1]] if mode == "gray_alpha" else hi)
    else:
        np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(tsd.read_image(path), got)
    np.testing.assert_array_equal(png.read_png(path), img)


def test_png_rejects_what_it_does_not_read(tmp_path):
    p = str(tmp_path / "p.png")
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(p)
    with pytest.raises(ValueError, match="colour type 3"):
        png.read_png(p)
    data = bytearray(png.encode_png(np.zeros((4, 4, 3), np.uint8)))
    data[30] ^= 1                                  # inside IHDR's body
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(data))


@pytest.mark.parametrize("src,dst", [((120, 160), (57, 77)),
                                     ((48, 64), (96, 128)),
                                     ((1200, 1600), (576, 768))])
def test_load_image_resize_matches_cv2_cubic(tmp_path, src, dst):
    """``load_image``'s cubic resize against the JAX package's
    (``cv2.INTER_CUBIC``) on an 8-bit PNG: within ``max(H, W) * 2**-22``
    (3.8e-5 for a 160-px side, 3.8e-4 for 1600 px)."""
    img = _image("noise", src + (3,), np.uint8, seed=4)
    path = str(tmp_path / "r.png")
    imageio.imwrite(path, img)
    got = tsd.load_image(path, dst)
    ref = jsd.load_image(path, dst)
    assert got.shape == ref.shape == dst + (3,)
    assert got.dtype == ref.dtype == np.float32
    tol = max(src) * 2.0 ** -22
    err = float(np.abs(got - ref).max())
    assert err <= tol, (err, tol)
    np.testing.assert_array_equal(tsd.load_image(path), jsd.load_image(path))


@pytest.mark.parametrize("src,dst", [((1200, 1600), (576, 768)),
                                     ((40, 60), (420, 648)),
                                     ((48, 64), (24, 32)),
                                     ((37, 53), (19, 101))])
def test_mask_resize_matches_cv2_nearest(tmp_path, src, dst):
    """``resize_nearest`` bit-equal to ``cv2.INTER_NEAREST``, and the DTU
    mask path of both packages on an 8-bit RGB mask."""
    m = (np.random.default_rng(5).random(src) > 0.5).astype(np.float32)
    m3 = np.repeat(m[..., None], 3, -1)
    np.testing.assert_array_equal(
        tsd.resize_nearest(m3, dst),
        cv2.resize(m3, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST))
    path = str(tmp_path / "m.png")
    imageio.imwrite(path, (m3 * 255).astype(np.uint8))
    np.testing.assert_array_equal(tdtu._load_mask(path, dst),
                                  jdtu._load_mask(path, dst))


def _assert_scene_equal(a, b):
    assert a.scan_id == b.scan_id and tuple(a.img_res) == tuple(b.img_res)
    for vs_a, vs_b in ((a.train, b.train), (a.eval, b.eval)):
        assert (vs_a is None) == (vs_b is None)
        if vs_a is None:
            continue
        assert vs_a.ids == vs_b.ids
        for k in ("rgb", "mask", "pose", "intrinsics"):
            x, y = getattr(vs_a, k), getattr(vs_b, k)
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)
    for k in ("points", "colors", "scale_mat"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)
    np.testing.assert_array_equal(a.uv, b.uv)


@pytest.fixture(scope="module")
def dtu_exports(tmp_path_factory):
    """The tiny DTU fixture of ``tests/test_cli_chain.py`` written by each
    package's exporter."""
    roots = {}
    for tag, export in (("jax", jsyn.export_synthetic_dtu),
                        ("port", tsyn.export_synthetic_dtu)):
        root = str(tmp_path_factory.mktemp(f"dtu_{tag}"))
        export(root, scan_id=24, n_views=49, img_res=(48, 64),
               n_points=2000)
        roots[tag] = root
    return roots


def test_exports_write_the_same_files(dtu_exports):
    """Both DTU exports lay out the same files with the same pixels,
    cameras and cloud."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    a, b = dtu_exports["jax"], dtu_exports["port"]
    assert files(a) == files(b)
    for rel in files(a):
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".png"):
            np.testing.assert_array_equal(imageio.imread(pa),
                                          imageio.imread(pb))
        elif rel.endswith(".npz"):
            with np.load(pa) as za, np.load(pb) as zb:
                assert za.files == zb.files
                for k in za.files:
                    np.testing.assert_array_equal(za[k], zb[k])
        else:
            assert open(pa, "rb").read() == open(pb, "rb").read(), rel


@pytest.mark.parametrize("source", ["jax", "port"])
@pytest.mark.parametrize("img_res", [(48, 64), (24, 32)])
def test_load_dtu_matches_jax(dtu_exports, source, img_res):
    """Every array of ``SceneData``, at the fixture's size (the images as
    read) and at half size (the cubic resize, within its bound; the masks'
    nearest resize bit-equal)."""
    root = dtu_exports[source]
    a = tdtu.load_dtu(root, 24, img_res, 3)
    b = jdtu.load_dtu(root, 24, img_res, 3)
    if img_res == (48, 64):
        _assert_scene_equal(a, b)
        return
    tol = 64 * 2.0 ** -22
    for vs_a, vs_b in ((a.train, b.train), (a.eval, b.eval)):
        assert float(np.abs(vs_a.rgb - vs_b.rgb).max()) <= tol
        vs_a.rgb = vs_b.rgb
    _assert_scene_equal(a, b)


@pytest.mark.parametrize("source", ["jax", "port"])
def test_load_own_data_matches_jax(tmp_path, source):
    export = {"jax": jsyn.export_synthetic_own_data,
              "port": tsyn.export_synthetic_own_data}[source]
    export(str(tmp_path), scan="sphere", n_points=1500, img_res=(40, 56))
    _assert_scene_equal(town.load_own_data(str(tmp_path), "sphere"),
                        jown.load_own_data(str(tmp_path), "sphere"))


def _mipnerf_scene(root, ext, scan="garden"):
    """A mip-NeRF scene at the loader's own size (no resize): the three
    train frames and a decoy pose, images in ``ext``."""
    inst = os.path.join(root, "mipnerf", scan)
    os.makedirs(os.path.join(inst, "image"))
    rng = np.random.default_rng(6)
    frames = []
    for i, n in enumerate(["DECOY.JPG"] + jmip.TRAIN_FRAMES[scan]):
        pose = np.eye(4)
        pose[2, 3] = -2.0 - i
        frames.append({"file_path": f"images/{n}",
                       "transform_matrix": pose.tolist()})
    h, w = jmip.SCENE_RES[scan]
    meta = {"fl_x": 480.0, "fl_y": 481.0, "cx": 324.0, "cy": 210.0,
            "w": w, "h": h, "frames": frames}
    with open(os.path.join(inst, f"{scan}.json"), "w") as f:
        json.dump(meta, f)
    for i in range(3):
        img = _image("smooth", (h, w, 3), np.uint8, seed=i)
        Image.fromarray(img).save(os.path.join(inst, "image",
                                               f"{i:02d}.{ext}"))
    pts = rng.uniform(-1.5, 1.5, (300, 3)).astype(np.float32)
    jply.save_ply(os.path.join(inst, f"{scan}.ply"), pts,
                  rng.integers(0, 255, (300, 3)).astype(np.uint8))


@pytest.mark.parametrize("ext", ["png", "JPG"])
def test_load_mipnerf_matches_jax(tmp_path, ext):
    """PNG through ``data.png``, JPEG through Pillow (as imageio reads
    it); the scene overrides are the JAX package's."""
    _mipnerf_scene(str(tmp_path), ext)
    _assert_scene_equal(tmip.load_mipnerf(str(tmp_path), "garden"),
                        jmip.load_mipnerf(str(tmp_path), "garden"))
    assert tmip.model_overrides("garden") == jmip.model_overrides("garden")


def test_jpeg_without_pillow_raises(tmp_path, monkeypatch):
    """A JPEG with no Pillow to decode it raises, naming the package; it is
    never skipped."""
    path = str(tmp_path / "a.jpg")
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        tsd.load_image(path)


def test_ply_codec_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (100, 3)).astype(np.uint8)
    tply.save_ply(str(tmp_path / "t.ply"), pts, cols)
    jply.save_ply(str(tmp_path / "j.ply"), pts, cols)
    assert (open(tmp_path / "t.ply", "rb").read()
            == open(tmp_path / "j.ply", "rb").read())
    for a, b in zip(tply.load_ply(str(tmp_path / "j.ply")),
                    jply.load_ply(str(tmp_path / "j.ply"))):
        np.testing.assert_array_equal(a, b)


def test_load_K_Rt_from_P_matches_jax():
    rng = np.random.default_rng(8)
    for _ in range(20):
        K = np.array([[rng.uniform(300, 900), rng.uniform(-2, 2),
                       rng.uniform(200, 400)],
                      [0, rng.uniform(300, 900), rng.uniform(150, 300)],
                      [0, 0, 1]])
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        q *= np.sign(np.linalg.det(q))
        t = rng.normal(size=3)
        P = K @ np.concatenate([q, t[:, None]], 1) * rng.uniform(0.5, 2)
        for a, b in zip(tcam.load_K_Rt_from_P(P), jcam.load_K_Rt_from_P(P)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_project_and_sphere_intersections_match_jax():
    rng = np.random.default_rng(9)
    B, N = 2, 300
    pts = rng.normal(0, 0.5, (B, N, 3)).astype(np.float32)
    pose = np.stack([tsyn.look_at(rng.normal(size=3) * 2 + [0, 0, 3])
                     for _ in range(B)])
    K = np.tile(np.array([[300.0, 0.7, 32.0, 0], [0, 310.0, 24.0, 0],
                          [0, 0, 1, 0], [0, 0, 0, 1]], np.float32), (B, 1, 1))
    got = tcam.project(torch.from_numpy(pts), torch.from_numpy(pose),
                       torch.from_numpy(K))
    ref = jcam.project(jnp.asarray(pts), jnp.asarray(pose), jnp.asarray(K))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(r).max()))
    cam = rng.normal(0, 1.5, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    got = tcam.get_sphere_intersections(torch.from_numpy(cam),
                                        torch.from_numpy(d), r=1.3)
    ref = np.asarray(jcam.get_sphere_intersections(jnp.asarray(cam),
                                                   jnp.asarray(d), r=1.3))
    assert (ref == 0).any() and (ref > 0).any()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
