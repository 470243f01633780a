"""Point-cloud preparation (``spurfies_tpu_torch/prep/pointcloud.py``,
``prep/colmap.py``, ``cli/prep_pointcloud.py``) against the JAX package,
on the CPU.

The post-processing functions give the same arrays and files (the
``.ply`` bytes and the ``.json`` equal); the C++ subsample of
``prepare_scene`` keeps the same points as the plain Python version and as
the JAX package's native routine; the COLMAP readers read
``tests/test_colmap.py``'s fixtures as the JAX package does.  The prep CLI
runs end to end in both packages at ``tests/test_dust3r_net.py``'s
``TINY`` config, on one synthetic upstream-layout checkpoint and three
64x64 PNGs.
"""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import dataclasses
import functools
import json
import os
import struct
import subprocess

import numpy as np
import pytest
import torch

from spurfies_tpu import native as jnative
from spurfies_tpu.cli import prep_pointcloud as jcli
from spurfies_tpu.prep import colmap as jcolmap
from spurfies_tpu.prep import dust3r_net as jd
from spurfies_tpu.prep import pointcloud as jpc
from spurfies_tpu_torch.cli import prep_pointcloud as tcli
from spurfies_tpu_torch.data.ply import load_ply
from spurfies_tpu_torch.data.png import write_png
from spurfies_tpu_torch.data.synthetic import make_synthetic_scene
from spurfies_tpu_torch.prep import colmap as tcolmap
from spurfies_tpu_torch.prep import dust3r_net as td
from spurfies_tpu_torch.prep import pointcloud as tpc

TINY = td.Dust3rConfig(img_size=(64, 64), patch=16, enc_dim=64,
                       enc_depth=2, enc_heads=4, dec_dim=32, dec_depth=2,
                       dec_heads=2)


# ---- the post-processing ---------------------------------------------------

def test_filter_by_confidence_is_jax(rng):
    pts = rng.uniform(0, 1, (300, 3))
    cols = rng.integers(0, 255, (300, 3)).astype(np.uint8)
    conf = rng.uniform(0, 20, 300)
    for c in (cols, None):
        a = tpc.filter_by_confidence(pts, c, conf, 10.0)
        b = jpc.filter_by_confidence(pts, c, conf, 10.0)
        np.testing.assert_array_equal(a[0], b[0])
        assert (a[1] is None) == (b[1] is None)
        if c is not None:
            np.testing.assert_array_equal(a[1], b[1])


def test_normalize_unit_cube_is_jax(rng):
    pts = rng.uniform(-3, 7, (500, 3))
    poses = np.tile(np.eye(4), (3, 1, 1))
    poses[:, :3, 3] = rng.uniform(-3, 7, (3, 3))
    for a, b in zip(tpc.normalize_unit_cube(pts, poses),
                    jpc.normalize_unit_cube(pts, poses)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cams", [True, False])
def test_export_scene_is_jax(tmp_path, rng, cams):
    """The same ``.ply`` bytes and, with cameras, the same ``.json``."""
    pts = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    cols = rng.integers(0, 255, (50, 3)).astype(np.uint8)
    poses = np.tile(np.eye(4), (3, 1, 1))
    poses[:, :3, 3] = rng.normal(size=(3, 3))
    K = np.eye(3)
    K[0, 0] = K[1, 1] = 100.0
    args = (pts, cols, poses, K, (64, 48)) if cams else (pts, None)
    tpc.export_scene(str(tmp_path / "t"), "duck", *args)
    jpc.export_scene(str(tmp_path / "j"), "duck", *args)
    names = ["duck.ply"] + (["duck.json"] if cams else [])
    assert sorted(os.listdir(tmp_path / "t")) == sorted(names)
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()


def test_prepare_scene_is_jax(rng):
    """Filter, subsample and normalize: the same keep set, points, poses,
    scale and centre."""
    pts = rng.uniform(-2, 2, (4000, 3)).astype(np.float32)
    cols = rng.integers(0, 255, (4000, 3)).astype(np.uint8)
    conf = rng.uniform(0, 20, 4000)
    poses = np.tile(np.eye(4), (3, 1, 1))
    poses[:, :3, 3] = rng.normal(size=(3, 3))
    for normalize in (False, True):
        a = tpc.prepare_scene(pts, cols, conf, 10.0, spacing=0.1,
                              normalize=normalize, poses=poses)
        b = jpc.prepare_scene(pts, cols, conf, 10.0, spacing=0.1,
                              normalize=normalize, poses=poses)
        assert 0 < len(a[0]) < 2000
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_cpp_subsample_keeps_the_python_and_native_sets(rng):
    """The C++ routine on ~20k points (clustered, so that many points are
    dropped): the keep set of the plain Python version and of the JAX
    package's native routine."""
    centers = rng.uniform(-1, 1, (200, 3))
    pts = (centers[rng.integers(0, 200, 20000)]
           + rng.normal(0, 0.03, (20000, 3))).astype(np.float32)
    keep = tpc.radius_dedup(pts, 0.025)
    assert 2000 < len(keep) < 19000
    np.testing.assert_array_equal(keep,
                                  tpc.greedy_spacing_subsample(pts, 0.025))
    native = jnative.spacing_subsample(pts, 0.025)
    assert native is not None, "the JAX package's native library is built"
    np.testing.assert_array_equal(keep, native)


def test_fuse_view_confidence_is_jax(rng):
    edges = [(0, 1), (0, 2), (1, 2)]
    ci = rng.uniform(1, 20, (3, 50)).astype(np.float32)
    cj = rng.uniform(1, 20, (3, 50)).astype(np.float32)
    a = tcli.fuse_view_confidence(edges, ci, cj, 3)
    np.testing.assert_array_equal(a, jcli.fuse_view_confidence(edges, ci,
                                                               cj, 3))
    np.testing.assert_array_equal(a[0], np.maximum(ci[0], ci[1]))
    np.testing.assert_array_equal(a[2], np.maximum(cj[1], cj[2]))


# ---- COLMAP ----------------------------------------------------------------

def _write_txt_model(d):
    """``tests/test_colmap.py``'s text fixture."""
    with open(os.path.join(d, "cameras.txt"), "w") as f:
        f.write("# comment\n")
        f.write("1 PINHOLE 640 480 500.0 510.0 320.0 240.0\n")
    with open(os.path.join(d, "images.txt"), "w") as f:
        f.write("# comment\n")
        f.write("1 1 0 0 0 0 0 -2 1 a.png\n")
        f.write("1.0 2.0 -1\n")
        f.write("2 0.7071068 0 0.7071068 0 1 0 0 1 b.png\n")
        f.write("\n")


def _write_bin_model(d, seed=0):
    """``tests/test_colmap.py``'s binary fixture, with two images and two
    cameras (SIMPLE_PINHOLE and OPENCV) and 2D points to skip."""
    rng = np.random.default_rng(seed)
    with open(os.path.join(d, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<iiQQ", 1, 0, 320, 240))
        f.write(struct.pack("<3d", 300.0, 160.0, 120.0))
        f.write(struct.pack("<iiQQ", 2, 4, 640, 480))
        f.write(struct.pack("<8d", 500.0, 510.0, 320.0, 240.0,
                            0.01, -0.02, 0.0, 0.0))
    with open(os.path.join(d, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", 2))
        for i, (name, cid) in enumerate((("b.png", 2), ("a.png", 1))):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            f.write(struct.pack("<I", i + 1))
            f.write(struct.pack("<4d", *q))
            f.write(struct.pack("<3d", *rng.normal(size=3)))
            f.write(struct.pack("<I", cid))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 2))
            f.write(struct.pack("<ddq", 1.0, 2.0, -1) * 2)


@pytest.mark.parametrize("kind", ["txt", "bin"])
def test_colmap_readers_and_json_are_jax(tmp_path, kind):
    (_write_txt_model if kind == "txt" else _write_bin_model)(str(tmp_path))
    cams_t, imgs_t = tcolmap.read_model(str(tmp_path))
    cams_j, imgs_j = jcolmap.read_model(str(tmp_path))
    assert cams_t == cams_j
    assert len(imgs_t) == len(imgs_j) == 2
    for (n1, c1, m1), (n2, c2, m2) in zip(imgs_t, imgs_j):
        assert (n1, c1) == (n2, c2)
        np.testing.assert_array_equal(m1, m2)
    meta_t = tcolmap.colmap_to_json(str(tmp_path), str(tmp_path / "t.json"))
    meta_j = jcolmap.colmap_to_json(str(tmp_path), str(tmp_path / "j.json"))
    assert meta_t == meta_j
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    assert meta_t["frames"][0]["file_path"] == "image/a.png"


def test_colmap_binaries_missing_raise():
    with pytest.raises(FileNotFoundError, match="not found on PATH"):
        tcolmap.run_colmap_pipeline("imgs", "work",
                                    colmap_bin="definitely-not-colmap")
    with pytest.raises(FileNotFoundError, match="not found on PATH"):
        tcolmap.extract_frames("v.mp4", "imgs",
                               ffmpeg_bin="definitely-not-ffmpeg")


def test_colmap_pipeline_commands(tmp_path, monkeypatch):
    """With ``subprocess.run`` recorded, the pipeline runs JAX's three
    COLMAP commands and the frame extraction its ffmpeg command."""
    calls = []

    def run(cmd, check):
        calls.append(cmd)
        if "mapper" in cmd:
            out = cmd[cmd.index("--output_path") + 1]
            os.makedirs(os.path.join(out, "0"))

    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr("shutil.which", lambda name: "/bin/" + name)
    model = tcolmap.run_colmap_pipeline(str(tmp_path / "imgs"),
                                        str(tmp_path / "work"))
    assert model == str(tmp_path / "work" / "sparse" / "0")
    db = str(tmp_path / "work" / "database.db")
    assert calls == [
        ["colmap", "feature_extractor", "--database_path", db,
         "--image_path", str(tmp_path / "imgs"),
         "--ImageReader.camera_model", "OPENCV",
         "--ImageReader.single_camera", "1"],
        ["colmap", "exhaustive_matcher", "--database_path", db],
        ["colmap", "mapper", "--database_path", db, "--image_path",
         str(tmp_path / "imgs"), "--output_path",
         str(tmp_path / "work" / "sparse")]]
    calls.clear()
    tcolmap.extract_frames("v.mp4", str(tmp_path / "frames"), fps=3.0)
    assert calls == [["ffmpeg", "-i", "v.mp4", "-qscale:v", "1", "-qmin",
                      "1", "-vf", "fps=3.0",
                      os.path.join(str(tmp_path / "frames"), "%04d.jpg")]]


# ---- the prep CLI end to end -----------------------------------------------

@pytest.fixture
def tiny_prep(tmp_path, monkeypatch):
    """Three 64x64 PNGs, one synthetic checkpoint, and both CLIs cut to
    ``TINY`` (images loaded at 64x64: no resize)."""
    _, _, views = make_synthetic_scene(n_points=500, n_views=3,
                                       img_res=(64, 64))
    os.makedirs(tmp_path / "imgs")
    for i in range(3):
        img = np.clip(views["rgb"][i].reshape(64, 64, 3), 0, 1)
        write_png(str(tmp_path / "imgs" / f"{i:03d}.png"),
                  (img * 255).astype(np.uint8))
    torch.save(td.random_dust3r_state(TINY, seed=0),
               str(tmp_path / "dust3r.pth"))
    tiny_j = jd.Dust3rConfig(**dataclasses.asdict(TINY))
    monkeypatch.setattr(jd, "Dust3rConfig", lambda img_size: tiny_j)
    monkeypatch.setattr(tcli, "Dust3rConfig", lambda img_size: TINY)
    for cli in (jcli, tcli):
        monkeypatch.setattr(cli, "run_inference", functools.partial(
            cli.run_inference, img_size=(64, 64)))
    return tmp_path, ["--scan", "s", "--images", str(tmp_path / "imgs"),
                      "--ckpt", str(tmp_path / "dust3r.pth"),
                      "--align-iters", "20", "--conf", "2.0"]


def test_prep_cli_is_jax(tiny_prep):
    """``main`` in both packages: the same number of exported points, the
    points within 1e-4 of the cloud's scale (the alignment's bound), the
    same cameras."""
    tmp, args = tiny_prep
    jcli.main(args + ["--out-root", str(tmp / "j")])
    out = tcli.main(args + ["--out-root", str(tmp / "t"), "--device",
                            "cpu"])
    pj, _ = load_ply(str(tmp / "j" / "own_data" / "s" / "s.ply"))
    pt, _ = load_ply(str(tmp / "t" / "own_data" / "s" / "s.ply"))
    assert 100 < len(pt) < 3 * 64 * 64
    assert len(pt) == len(pj)
    assert np.abs(pt - pj).max() <= 1e-4 * np.abs(pj).max()
    np.testing.assert_array_equal(out["points"].astype(np.float32), pt)
    with open(tmp / "j" / "own_data" / "s" / "s.json") as f:
        meta_j = json.load(f)
    with open(tmp / "t" / "own_data" / "s" / "s.json") as f:
        meta_t = json.load(f)
    assert {k: v for k, v in meta_t.items() if k != "frames"} == \
        {k: v for k, v in meta_j.items() if k != "frames"}
    for a, b in zip(meta_t["frames"], meta_j["frames"]):
        assert a["file_path"] == b["file_path"]
        np.testing.assert_allclose(a["transform_matrix"],
                                   b["transform_matrix"], atol=1e-4)


def test_prep_cli_needs_its_checkpoint_and_a_card(tiny_prep):
    """No checkpoint raises before any work; ``--device cuda`` (the
    default) without a card raises rather than running on the CPU."""
    tmp, args = tiny_prep
    with pytest.raises(FileNotFoundError, match="checkpoint"):
        tcli.main(["--scan", "s", "--images", str(tmp / "imgs"), "--ckpt",
                   str(tmp / "missing.pth")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(args + ["--out-root", str(tmp / "t")])
