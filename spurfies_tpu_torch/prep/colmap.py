"""COLMAP model -> NGP-style transforms.json converter (port of
``spurfies_tpu/prep/colmap.py``, host-only: the same code).

Role of reference ``scripts/colmap2nerf.py`` (the stock Instant-NGP script,
SURVEY §2): turn a COLMAP sparse reconstruction into the ``<scan>.json``
camera format the own-data pipeline consumes.  A from-scratch minimal
reader of COLMAP's text and binary exports; the ``colmap`` and ``ffmpeg``
binaries stay external (:func:`run_colmap_pipeline` and
:func:`extract_frames` raise ``FileNotFoundError`` without them).
"""

import json
import os

import numpy as np


def read_cameras_txt(path: str) -> dict:
    """camera_id -> dict(model, w, h, fl_x, fl_y, cx, cy)."""
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id, model = int(parts[0]), parts[1]
            w, h = int(parts[2]), int(parts[3])
            p = [float(v) for v in parts[4:]]
            if model == "SIMPLE_PINHOLE":
                fl_x = fl_y = p[0]
                cx, cy = p[1], p[2]
            elif model == "PINHOLE":
                fl_x, fl_y, cx, cy = p[0], p[1], p[2], p[3]
            elif model in ("SIMPLE_RADIAL", "RADIAL"):
                fl_x = fl_y = p[0]
                cx, cy = p[1], p[2]
            elif model in ("OPENCV", "FULL_OPENCV"):
                fl_x, fl_y, cx, cy = p[0], p[1], p[2], p[3]
            else:
                raise NotImplementedError(f"camera model {model}")
            cams[cam_id] = {
                "model": model, "w": w, "h": h,
                "fl_x": fl_x, "fl_y": fl_y, "cx": cx, "cy": cy,
            }
    return cams


def qvec_to_rot(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def read_images_txt(path: str) -> list:
    """[(name, camera_id, c2w 4x4)] — COLMAP stores w2c (qvec, tvec)."""
    out = []
    with open(path) as f:
        lines = [l.strip() for l in f
                 if l.strip() and not l.startswith("#")]
    for i in range(0, len(lines), 2):  # every other line is 2D points
        parts = lines[i].split()
        q = np.array([float(v) for v in parts[1:5]])
        t = np.array([float(v) for v in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        R = qvec_to_rot(q)
        c2w = np.eye(4)
        c2w[:3, :3] = R.T
        c2w[:3, 3] = -R.T @ t
        out.append((name, cam_id, c2w))
    return out


def colmap_to_json(sparse_dir: str, out_path: str,
                   image_prefix: str = "image"):
    """Convert a COLMAP sparse model (.bin or .txt) to transforms json."""
    cams, images = read_model(sparse_dir)
    images.sort(key=lambda x: x[0])

    cam = cams[images[0][1]]
    meta = {
        "fl_x": cam["fl_x"], "fl_y": cam["fl_y"],
        "cx": cam["cx"], "cy": cam["cy"],
        "w": cam["w"], "h": cam["h"],
        "frames": [
            {
                "file_path": f"{image_prefix}/{name}",
                "transform_matrix": c2w.tolist(),
            }
            for name, _, c2w in images
        ],
    }
    with open(out_path, "w") as f:
        json.dump(meta, f, indent=2)
    return meta


# ---------------------------------------------------------------------------
# Binary model readers (real COLMAP runs export .bin by default; the text
# format above needs an extra `colmap model_converter` step).  Format spec:
# COLMAP src/colmap/scene/reconstruction_io.cc.
# ---------------------------------------------------------------------------

_BIN_CAMERA_PARAMS = {
    # model_id -> (name, num_params)
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4), 3: ("RADIAL", 5),
    4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8), 6: ("FULL_OPENCV", 12),
}


def read_cameras_bin(path: str) -> dict:
    """camera_id -> dict(model, w, h, fl_x, fl_y, cx, cy) from cameras.bin."""
    import struct

    cams = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            cam_id, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            name, n_params = _BIN_CAMERA_PARAMS[model_id]
            p = struct.unpack(f"<{n_params}d", f.read(8 * n_params))
            if name == "SIMPLE_PINHOLE":
                fl_x = fl_y = p[0]; cx, cy = p[1], p[2]
            elif name in ("PINHOLE", "OPENCV", "FULL_OPENCV",
                          "OPENCV_FISHEYE"):
                fl_x, fl_y, cx, cy = p[0], p[1], p[2], p[3]
            else:  # SIMPLE_RADIAL / RADIAL
                fl_x = fl_y = p[0]; cx, cy = p[1], p[2]
            cams[cam_id] = {
                "model": name, "w": int(w), "h": int(h),
                "fl_x": fl_x, "fl_y": fl_y, "cx": cx, "cy": cy,
            }
    return cams


def read_images_bin(path: str) -> list:
    """[(name, camera_id, c2w 4x4)] from images.bin."""
    import struct

    out = []
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            _img_id = struct.unpack("<I", f.read(4))[0]
            q = np.array(struct.unpack("<4d", f.read(32)))
            t = np.array(struct.unpack("<3d", f.read(24)))
            cam_id = struct.unpack("<I", f.read(4))[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            n_pts = struct.unpack("<Q", f.read(8))[0]
            f.read(24 * n_pts)   # skip 2D points (x, y double + id int64)
            R = qvec_to_rot(q)
            c2w = np.eye(4)
            c2w[:3, :3] = R.T
            c2w[:3, 3] = -R.T @ t
            out.append((name.decode(), cam_id, c2w))
    return out


def read_model(sparse_dir: str):
    """(cams, images) from a COLMAP sparse dir — .bin preferred, .txt
    fallback."""
    cb = os.path.join(sparse_dir, "cameras.bin")
    if os.path.exists(cb):
        return (read_cameras_bin(cb),
                read_images_bin(os.path.join(sparse_dir, "images.bin")))
    return (read_cameras_txt(os.path.join(sparse_dir, "cameras.txt")),
            read_images_txt(os.path.join(sparse_dir, "images.txt")))


def run_colmap_pipeline(images_dir: str, work_dir: str,
                        camera_model: str = "OPENCV",
                        matcher: str = "exhaustive_matcher",
                        colmap_bin: str = "colmap") -> str:
    """Drive COLMAP end-to-end like reference scripts/colmap2nerf.py:
    feature_extractor -> matcher -> mapper; returns the sparse model dir.

    Requires the ``colmap`` binary on PATH (external tool, like the
    reference); raises FileNotFoundError with guidance when absent.
    """
    import shutil
    import subprocess

    if shutil.which(colmap_bin) is None:
        raise FileNotFoundError(
            f"'{colmap_bin}' not found on PATH — install COLMAP or run it "
            "elsewhere and point colmap_to_json at the sparse model dir"
        )

    db = os.path.join(work_dir, "database.db")
    sparse = os.path.join(work_dir, "sparse")
    os.makedirs(sparse, exist_ok=True)

    def run(*args):
        subprocess.run([colmap_bin, *args], check=True)

    run("feature_extractor", "--database_path", db,
        "--image_path", images_dir,
        "--ImageReader.camera_model", camera_model,
        "--ImageReader.single_camera", "1")
    run(matcher, "--database_path", db)
    run("mapper", "--database_path", db, "--image_path", images_dir,
        "--output_path", sparse)

    model = os.path.join(sparse, "0")
    if not os.path.isdir(model):
        raise RuntimeError(f"COLMAP mapper produced no model under {sparse}")
    return model


def extract_frames(video_path: str, images_dir: str, fps: float = 2.0,
                   ffmpeg_bin: str = "ffmpeg"):
    """ffmpeg frame extraction (reference colmap2nerf.py --video_in)."""
    import shutil
    import subprocess

    if shutil.which(ffmpeg_bin) is None:
        raise FileNotFoundError(f"'{ffmpeg_bin}' not found on PATH")
    os.makedirs(images_dir, exist_ok=True)
    subprocess.run(
        [ffmpeg_bin, "-i", video_path, "-qscale:v", "1", "-qmin", "1",
         "-vf", f"fps={fps}", os.path.join(images_dir, "%04d.jpg")],
        check=True,
    )
