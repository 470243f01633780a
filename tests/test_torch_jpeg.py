"""The port's JPEG reader (``data.jpeg``, ``csrc/host_jpeg.cpp`` built here
with the host compiler) against imageio and cv2, on the CPU.

* ``scene_data.read_image`` bit-equal to ``imageio.v2.imread`` on every
  committed fixture and on files that Pillow writes here: 4:4:4, 4:2:2 and
  4:2:0, grey, quality 50 and 95, with and without restart markers, the
  optimized Huffman tables, RGB kept as RGB (Adobe transform 0), sizes from
  1x1 to 333x501, sequential and progressive; and on files that cv2 writes:
  progressive, 4:4:0 and 4:1:1 (where ``read_bgr`` is bit-equal to
  ``cv2.imread`` too).
* the kinds libjpeg-turbo reads besides (``read_bgr`` against ``cv2.imread``
  too, a ``ValueError`` where it reads ``None``): arithmetic coding,
  sequential and progressive, with and without restart markers and DAC
  segments (files that ``tests/jpeg_tools/transcode.c`` writes with the
  system libjpeg); lossless JPEG at every predictor and point transform,
  grey and RGB, with restarts (``tests/jpeg_tools/lossless.c`` on Pillow's
  libjpeg-turbo 3.x) and subsampled or in one scan per component
  (``_lossless_by_hand``); Pillow's progressive files cut after each scan,
  which libjpeg smooths (block smoothing); sequential files without DHT
  segments (Motion-JPEG frames: the standard tables); Huffman tables that
  no scan selects.
* progressive scripts that libjpeg only warns about, and damaged data
  (a file cut inside a scan with EOI appended, renumbered restart
  markers, a sequential scan with other scan parameters) decode as it
  decodes them; damaged arithmetic and lossless data and cuts inside a
  progressive scan decode as its C code does
  (``tests/jpeg_tools/decode_c.c`` under ``JSIMD_FORCENONE=1``).
* ``load_image(p, img_res)`` within ``resize_cubic``'s stated bound
  (``max(H, W) * 2**-22`` on [0, 1] images) of the JAX package's.
* ``mvs_local.read_bgr`` bit-equal to ``cv2.imread``, which turns a file by
  its EXIF orientation tag (imageio does not: ``read_image`` ignores it).
* what imageio refuses raises ``ValueError``: CMYK, truncated files, bad
  progressive scans, a corrupt Huffman table that a scan selects,
  lossless arithmetic coding, 12-bit samples, lossless YCbCr, an
  arithmetic-coded file that Pillow hands libjpeg across a 65536-byte
  block.
* ``tests/fixtures/jpeg/hashes.json`` (the SHA-256 of imageio's and cv2's
  arrays of each fixture, which ``chip_smoke.py`` holds the card machine's
  decodes to, where neither library is installed) against imageio and cv2.

The fixtures are made by :func:`make_fixtures` (``python
tests/test_torch_jpeg.py`` writes them again): three views of one
``export_synthetic_own_data`` scene (``SCENE``) at 4:2:0, quality 90, each
just over 1 MP; one 4:4:4 file with a restart marker every 5 MCUs; one
4:2:0 file with EXIF orientation 6; a progressive 4:2:0 copy of view 0;
views 1 and 2 as cv2 writes them at 4:4:0 and 4:1:1; view 0 arithmetic
coded, sequential and progressive; a crop of view 0 as RGB lossless with
restarts and as grey lossless; the progressive copy cut after its fifth
scan; view 0 at 360x480 and 4:2:2 without its DHT segments.
"""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import atexit
import functools
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from spurfies_tpu.data import scene_data as jsd
from spurfies_tpu_torch.data import jpeg
from spurfies_tpu_torch.data import scene_data as tsd
from spurfies_tpu_torch.data.mvs_local import read_bgr

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "jpeg"
TOOLS = Path(__file__).resolve().parent / "jpeg_tools"
# the own-data scene the three views are of (export_synthetic_own_data)
SCENE = {"scan": "jpeg_views", "n_views": 3, "img_res": [888, 1184],
         "seed": 5}
VIEWS = [f"view_{i}.jpg" for i in range(SCENE["n_views"])]
RESTART = "restart_444.jpg"
EXIF = "exif_6.jpg"
PROGRESSIVE = "progressive_420.jpg"
CV2_440 = "cv2_440.jpg"
CV2_411 = "cv2_411.jpg"
ARITH_SEQ = "arith_sof9.jpg"
ARITH_PROG = "arith_sof10.jpg"
LOSSLESS_RGB = "lossless_rgb.jpg"
LOSSLESS_GREY = "lossless_grey.jpg"
PROGRESSIVE_CUT = "progressive_cut.jpg"
NO_DHT = "no_dht_422.jpg"
KINDS = [ARITH_SEQ, ARITH_PROG, LOSSLESS_RGB, LOSSLESS_GREY, PROGRESSIVE_CUT,
         NO_DHT]
NAMES = VIEWS + [RESTART, EXIF, PROGRESSIVE, CV2_440, CV2_411] + KINDS


def digest(img: np.ndarray) -> dict:
    """Shape, dtype and SHA-256 of an array's bytes (C order)."""
    img = np.ascontiguousarray(img)
    return {"shape": list(img.shape), "dtype": str(img.dtype),
            "sha256": hashlib.sha256(img.tobytes()).hexdigest()}


def _smooth(h, w, channels=3, seed=0, noise=12.0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    f = np.stack([128 + 100 * np.sin(xx / 17.0 + k) * np.cos(yy / 23.0 - k)
                  for k in range(channels)], -1)
    f = f + rng.normal(0, noise, f.shape)
    img = np.clip(f, 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def _pillow_libjpeg() -> Path:
    """The libjpeg-turbo 3.x that Pillow bundles: imageio's decoder."""
    import PIL

    libs = sorted((Path(PIL.__file__).resolve().parent.parent
                   / "pillow.libs").glob("libjpeg*.so*"))
    assert libs, "Pillow bundles no libjpeg"
    return libs[0]


@functools.lru_cache(maxsize=None)
def _tool(name: str) -> str:
    """``tests/jpeg_tools/<name>.c`` built by ``cc`` into a temporary
    directory: ``transcode`` against the system libjpeg (arithmetic coding),
    ``lossless`` and ``decode_c`` against Pillow's libjpeg-turbo."""
    tmp = tempfile.mkdtemp(prefix="jpeg_tools_")
    atexit.register(shutil.rmtree, tmp, True)
    exe = os.path.join(tmp, name)
    cmd = ["cc", "-O2", str(TOOLS / f"{name}.c"), "-o", exe]
    if name == "transcode":
        cmd.append("-ljpeg")
    else:
        lib = _pillow_libjpeg()
        cmd += [str(lib), f"-Wl,-rpath,{lib.parent}"]
    subprocess.run(cmd, check=True, capture_output=True)
    return exe


def _transcode(data: bytes, *args) -> bytes:
    """``data`` rewritten by ``transcode`` (``arith``, ``prog``, ``script
    S``, ``rst N``, ``dac L U K``): the same coefficients."""
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.jpg"), os.path.join(tmp, "out.jpg")
        Path(src).write_bytes(data)
        subprocess.run([_tool("transcode"), src, dst, *map(str, args)],
                       check=True, capture_output=True)
        return Path(dst).read_bytes()


def _lossless(img: np.ndarray, psv: int, pt: int, *args) -> bytes:
    """``img`` (uint8, grey or RGB) as libjpeg-turbo writes it lossless:
    predictor ``psv``, point transform ``pt`` (``rst ROWS``)."""
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    head = f"P{5 if img.ndim == 2 else 6}\n{w} {h}\n255\n".encode()
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.pnm"), os.path.join(tmp, "out.jpg")
        Path(src).write_bytes(head + img.tobytes())
        subprocess.run([_tool("lossless"), src, dst, str(psv), str(pt),
                        *map(str, args)], check=True, capture_output=True)
        return Path(dst).read_bytes()


def _decode_c(data: bytes):
    """libjpeg-turbo's C code on ``data`` (``decode_c`` under
    ``JSIMD_FORCENONE=1``): the pixels as imageio shapes them, or ``None``
    where libjpeg fails."""
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.jpg")
        Path(src).write_bytes(data)
        run = subprocess.run([_tool("decode_c"), src], capture_output=True,
                             env=dict(os.environ, JSIMD_FORCENONE="1"))
    if run.returncode:
        return None
    return np.frombuffer(run.stdout, np.uint8)


def _segments(data: bytes):
    """``(marker, start, end)`` of each segment before EOI; a scan's end is
    the marker after its entropy-coded data."""
    out, pos = [], 2
    while data[pos + 1] != 0xD9:
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] != 0
                       and not 0xD0 <= data[end + 1] <= 0xD7):
                end += 1
        out.append((data[pos + 1], pos, end))
        pos = end
    return out


def _without(data: bytes, marker: int) -> bytes:
    """``data`` without its segments of one marker (DHT: a Motion-JPEG
    frame; DAC: arithmetic coding at the default conditioning)."""
    return data[:2] + b"".join(data[s:e] for m, s, e in _segments(data)
                               if m != marker) + b"\xff\xd9"


def make_fixtures(out=FIXTURES):
    """Write the fixtures and ``hashes.json`` into ``out``."""
    from spurfies_tpu_torch.data.synthetic import export_synthetic_own_data

    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        export_synthetic_own_data(tmp, scan=SCENE["scan"],
                                  n_views=SCENE["n_views"],
                                  img_res=tuple(SCENE["img_res"]),
                                  seed=SCENE["seed"])
        image_dir = Path(tmp) / "own_data" / SCENE["scan"] / "image"
        for i, name in enumerate(VIEWS):
            img = imageio.imread(image_dir / f"{i:03d}.png")
            Image.fromarray(img).save(out / name, "JPEG", quality=90,
                                      subsampling=2)
            if i == 0:
                Image.fromarray(img).save(out / PROGRESSIVE, "JPEG",
                                          quality=90, subsampling=2,
                                          progressive=True)
                view0 = img
            else:
                extra = CV2_440 if i == 1 else CV2_411
                (out / extra).write_bytes(_cv2_encoded(img, extra[4:7]))
    Image.fromarray(_smooth(333, 501, seed=1)).save(
        out / RESTART, "JPEG", quality=90, subsampling=0,
        restart_marker_blocks=5)
    coded = (out / VIEWS[0]).read_bytes()
    (out / ARITH_SEQ).write_bytes(_transcode(coded, "arith"))
    (out / ARITH_PROG).write_bytes(_transcode(coded, "arith", "prog"))
    crop = imageio.imread(out / VIEWS[0])[300:492, 400:656]
    (out / LOSSLESS_RGB).write_bytes(_lossless(crop, 4, 0, "rst", 8))
    (out / LOSSLESS_GREY).write_bytes(_lossless(crop[:120, :160, 1], 7, 1))
    prog = (out / PROGRESSIVE).read_bytes()
    (out / PROGRESSIVE_CUT).write_bytes(prog[:_scans(prog)[5][0]]
                                        + b"\xff\xd9")
    frame = io.BytesIO()
    Image.fromarray(view0).resize((480, 360)).save(frame, "JPEG",
                                                   quality=90, subsampling=1)
    (out / NO_DHT).write_bytes(_without(frame.getvalue(), 0xC4))
    exif = Image.Exif()
    exif[0x0112] = 6
    small = Image.open(out / VIEWS[0]).resize((160, 120))
    small.save(out / EXIF, "JPEG", quality=90, subsampling=2,
               exif=exif.tobytes())
    def cv2_digest(path):
        img = cv2.imread(str(path))
        return None if img is None else digest(img)

    record = {"scene": SCENE, "files": {
        n: {"imageio": digest(imageio.imread(out / n)),
            "cv2": cv2_digest(out / n)} for n in NAMES}}
    (out / "hashes.json").write_text(json.dumps(record, indent=1) + "\n")


# 1xN, Nx1 and 2xN too: the widths where jdsample.c stops being fancy
SIZES = [(1, 1), (1, 2), (2, 1), (1, 37), (37, 1), (2, 37), (3, 5), (8, 8),
         (9, 17), (16, 16), (17, 33), (31, 2), (64, 80), (333, 501)]


def _variants():
    out = []
    for h, w in SIZES:
        for prog in ({}, {"progressive": True}):
            for sub in (0, 1, 2):
                out.append(((h, w), 3, {"subsampling": sub, "quality": 90,
                                        **prog}))
            out.append(((h, w), 1, {"quality": 90, **prog}))
    for sub in (0, 1, 2):
        for q in (50, 95):
            for opt in (False, True):
                out.append(((45, 61), 3, {"subsampling": sub, "quality": q,
                                          "optimize": opt}))
                out.append(((45, 61), 3, {"subsampling": sub, "quality": q,
                                          "optimize": opt,
                                          "progressive": True}))
    for hw in ((45, 61), (333, 501)):
        out.append((hw, 3, {"subsampling": 2, "restart_marker_rows": 1}))
        out.append((hw, 3, {"subsampling": 0, "restart_marker_blocks": 3}))
        out.append((hw, 1, {"restart_marker_blocks": 7, "quality": 50}))
        out.append((hw, 3, {"keep_rgb": True, "quality": 95}))
        for sub in (0, 2):
            out.append((hw, 3, {"subsampling": sub, "progressive": True,
                                "restart_marker_blocks": 3}))
        out.append((hw, 1, {"progressive": True, "restart_marker_blocks": 7,
                            "quality": 50}))
    return out


def _cv2_encoded(rgb, layout, quality=90):
    """``rgb`` as cv2 writes it: ``layout`` "440", "411" or "prog" (a
    progressive 4:2:0 file)."""
    if layout == "prog":
        flags = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    else:
        flags = [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                 getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{layout}")]
    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(rgb[..., ::-1]),
                           [cv2.IMWRITE_JPEG_QUALITY, quality] + flags)
    assert ok
    return enc.tobytes()


def _cv2_variants():
    return [(hw, layout) for hw in SIZES for layout in ("prog", "440", "411")]


def _encoded(hw, channels, kw, seed=0):
    buf = io.BytesIO()
    Image.fromarray(_smooth(*hw, channels=channels, seed=seed)).save(
        buf, "JPEG", **kw)
    return buf.getvalue()


def _fixture_paths():
    return [FIXTURES / n for n in NAMES]


@pytest.mark.parametrize("path", _fixture_paths(), ids=lambda p: p.name)
def test_fixture_matches_imageio(path):
    got = tsd.read_image(str(path))
    ref = imageio.imread(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_views_are_the_scene_at_one_megapixel():
    """The three views: 4:2:0 (Y at 2x2, chroma at 1x1), each at least
    1 MP, the size the hash file states."""
    files = json.loads((FIXTURES / "hashes.json").read_text())["files"]
    for name in VIEWS:
        with Image.open(FIXTURES / name) as im:
            assert im.layers == 3 and im.layer[0][1:3] == (2, 2)
            assert im.layer[1][1:3] == (1, 1)
            w, h = im.size
        assert h * w >= 1_000_000
        assert files[name]["imageio"]["shape"] == [h, w, 3]
    total = sum(p.stat().st_size for p in FIXTURES.iterdir())
    assert total <= 640 * 1024
    for name in (PROGRESSIVE, CV2_440, CV2_411):
        assert (FIXTURES / name).stat().st_size <= 150 * 1024
    for name in KINDS:
        assert (FIXTURES / name).stat().st_size <= 64 * 1024


@pytest.mark.parametrize("hw,channels,kw", _variants(),
                         ids=lambda v: str(v).replace(" ", ""))
def test_pillow_variant_matches_imageio(hw, channels, kw):
    data = _encoded(hw, channels, kw)
    got = tsd.decode_image(data)
    ref = imageio.imread(io.BytesIO(data))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("hw,layout", _cv2_variants(),
                         ids=lambda v: str(v).replace(" ", ""))
def test_cv2_variant_matches_imageio_and_cv2(tmp_path, hw, layout):
    """What cv2 writes: progressive, 4:4:0 (Y at 1x2) and 4:1:1 (Y at
    4x1); ``read_bgr`` against ``cv2.imread`` too."""
    data = _cv2_encoded(_smooth(*hw), layout)
    path = tmp_path / "v.jpg"
    path.write_bytes(data)
    ref = imageio.imread(io.BytesIO(data))
    got = tsd.decode_image(data)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(read_bgr(str(path)), cv2.imread(str(path)))


@pytest.mark.parametrize("img_res", [(192, 256), (420, 648), (1000, 1300)])
def test_load_image_matches_jax(img_res):
    """The view resized by ``resize_cubic`` against the JAX package's
    ``cv2.resize(INTER_CUBIC)``: within ``max(H, W) * 2**-22``."""
    path = str(FIXTURES / VIEWS[1])
    got, ref = tsd.load_image(path, img_res), jsd.load_image(path, img_res)
    assert got.shape == ref.shape == (*img_res, 3)
    h, w = imageio.imread(path).shape[:2]
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=max(h, w) * 2.0 ** -22)
    np.testing.assert_array_equal(tsd.load_image(path),
                                  jsd.load_image(path))


def _assert_read_bgr_is_cv2(path):
    """``read_bgr`` bit-equal to ``cv2.imread``, or a ``ValueError`` that
    names the file where cv2 reads ``None``."""
    ref = cv2.imread(str(path))
    if ref is None:
        with pytest.raises(ValueError, match=Path(path).name):
            read_bgr(str(path))
        return ref
    np.testing.assert_array_equal(read_bgr(str(path)), ref)
    return ref


@pytest.mark.parametrize("name", [EXIF, VIEWS[2], PROGRESSIVE, CV2_440,
                                  CV2_411] + KINDS)
def test_read_bgr_matches_cv2(name):
    """cv2 turns the EXIF-6 file a quarter turn clockwise; imageio and
    ``read_image`` keep it as stored. cv2 reads no grey lossless file
    (libjpeg converts no colour in lossless mode): ``read_bgr`` raises."""
    path = str(FIXTURES / name)
    ref = _assert_read_bgr_is_cv2(path)
    assert (ref is None) == (name == LOSSLESS_GREY)
    stored = imageio.imread(path)
    if name == EXIF:
        assert ref.shape[:2] == stored.shape[1::-1]
    np.testing.assert_array_equal(tsd.read_image(path), stored)


@pytest.mark.parametrize("tag", range(1, 9))
def test_every_orientation_matches_cv2(tmp_path, tag):
    exif = Image.Exif()
    exif[0x0112] = tag
    path = tmp_path / f"o{tag}.jpg"
    Image.fromarray(_smooth(21, 34)).save(path, "JPEG", exif=exif.tobytes())
    assert jpeg.orientation(path.read_bytes()) == tag
    np.testing.assert_array_equal(read_bgr(str(path)), cv2.imread(str(path)))


def _progressive():
    return _encoded((40, 56), 3, {"progressive": True})


def _scans(data):
    """``(start, end)`` of each scan of a JPEG file: its SOS marker, and the
    marker after its entropy-coded data.  Pillow's progressive script for
    three components (``jpeg_simple_progression``): 0 DC first (Al 1),
    1 Y 1-5 (Al 2), 2 Cr 1-63, 3 Cb 1-63 (Al 1), 4 Y 6-63 (Al 2), 5 Y
    1-63 (Ah 2, Al 1), 6 DC refine, 7 Cr, 8 Cb, 9 Y 1-63 (Ah 1, Al 0)."""
    return [(s, e) for m, s, e in _segments(data) if m == 0xDA]


def _scan_params_at(data, i):
    """The offset of scan ``i``'s Ss byte (then Se, then Ah << 4 | Al)."""
    start = _scans(data)[i][0]
    return start + 5 + 2 * data[start + 4]


def _patched(i, offset, value):
    """Pillow's progressive file with byte ``offset`` of scan ``i``'s
    (Ss, Se, Ah/Al) set to ``value``."""
    data = bytearray(_progressive())
    data[_scan_params_at(data, i) + offset] = value
    return bytes(data)


def _two_component_ac():
    """The DC scan's header rewritten as an AC scan (Ss 1, Se 63) of the
    first two components."""
    data = _progressive()
    start = _scans(data)[0][0]
    old = 2 + int.from_bytes(data[start + 2:start + 4], "big")
    sos = (b"\xff\xda\x00\x0a\x02" + data[start + 5:start + 9]
           + b"\x01\x3f\x00")
    return data[:start] + sos + data[start + old:]


def _incomplete_script():
    """Pillow's progressive file cut after its fifth scan, with EOI
    appended: Y's coefficients 1..63 stop at Al 2."""
    data = _progressive()
    return data[:_scans(data)[5][0]] + b"\xff\xd9"


def _arithmetic():
    """A baseline file whose SOF0 says SOF9: its Huffman data read as
    arithmetic-coded (damaged) data."""
    data = bytearray(_encoded((16, 16), 3, {}))
    data[bytes(data).index(b"\xff\xc0") + 1] = 0xC9
    return bytes(data)


def _patched_byte(data, marker, offset, value):
    """``data`` with byte ``offset`` of the first ``marker`` segment (0: its
    marker code) set to ``value``."""
    data = bytearray(data)
    data[bytes(data).index(bytes([0xFF, marker])) + 1 + offset] = value
    return bytes(data)


def _lossless_rgb():
    return _lossless(_smooth(45, 61), 4, 0)


def _cmyk():
    buf = io.BytesIO()
    Image.fromarray(_smooth(40, 56)).convert("CMYK").save(buf, "JPEG")
    return buf.getvalue()


def _truncated(frac):
    data = _encoded((64, 80), 3, {"quality": 90})
    return data[:int(len(data) * frac)]


def _with_dht(tc, counts, symbols, selected=False):
    """A valid file with one crafted DHT segment (table class ``tc``, id 0,
    ``counts[l - 1]`` codes of length ``l``) put first, where the file's own
    table 0 of that class replaces it before any scan, or with
    ``selected`` just before the scan, which selects it."""
    counts = list(counts) + [0] * (16 - len(counts))
    body = bytes([tc << 4, *counts, *symbols])
    seg = b"\xff\xc4" + (2 + len(body)).to_bytes(2, "big") + body
    data = _encoded((16, 16), 3, {})
    at = data.index(b"\xff\xda") if selected else 2
    return data[:at] + seg + data[at:]


# crafted tables libjpeg refuses (jpeg_make_d_derived_tbl): over-full
# counts, an all-ones code, a DC symbol above 15
BAD_DHT = {"dht_overfull_1": (0, [3], [0, 1, 2]),
           "dht_overfull_200": (1, [0, 200], [0] * 200),
           "dht_all_ones": (1, [0, 4], [0] * 4),
           "dht_dc_symbol_16": (0, [1], [16])}


def _table_2_without_dht():
    """A baseline file whose scan selects tables 2, none defined: the
    standard tables cover ids 0 and 1 only (jstdhuff.c)."""
    data = bytearray(_without(_encoded((16, 16), 3, {}), 0xC4))
    start = [s for m, s, e in _segments(bytes(data)) if m == 0xDA][0]
    for k in range(data[start + 4]):
        data[start + 6 + 2 * k] = 0x22
    return bytes(data)


def _lossless_restart_not_rows():
    """A lossless file whose restart interval (61 MCUs a row) is 60 MCUs:
    libjpeg restarts lossless scans at whole MCU rows only."""
    data = _lossless(_smooth(45, 61), 1, 0, "rst", 1)
    at = data.index(b"\xff\xdd")
    return data[:at + 4] + (60).to_bytes(2, "big") + data[at + 6:]


def _arithmetic_across_a_block():
    """An arithmetic-coded file of 69 KB: Pillow hands libjpeg 65536 bytes
    at a time, and its arithmetic decoder cannot wait for more (imageio
    refuses the file; cv2 reads it)."""
    return _transcode(_encoded((333, 501), 3, {"quality": 90}), "arith",
                      "rst", 3)


@pytest.mark.parametrize("make,what", [
    (_cmyk, "CMYK"),
    (lambda: _truncated(0.5), "truncated"),
    (lambda: _truncated(0.98), "truncated"),
    (lambda: b"\xff\xd8\xff", "truncated"),
    (lambda: _encoded((8, 8), 3, {})[:-2], "truncated"),
    *[(functools.partial(_with_dht, *v, selected=True), "bad Huffman table")
      for v in BAD_DHT.values()],
    (lambda: _patched(1, 0, 6), "bad progressive scan .*Ss > Se"),
    (lambda: _patched(2, 1, 64), "bad progressive scan .*Se > 63"),
    (_two_component_ac,
     "bad progressive scan .*an AC scan of more than one component"),
    (lambda: _patched(6, 2, 0x20),
     "bad progressive scan .*a refinement scan with Al != Ah - 1"),
    (lambda: _progressive()[:len(_progressive()) // 2], "truncated"),
    (lambda: _patched_byte(_lossless_rgb(), 0xC3, 0, 0xCB),
     "lossless arithmetic-coded JPEG \\(SOF11\\)"),
    (lambda: _patched_byte(_encoded((16, 16), 3, {}), 0xC0, 3, 12),
     "12-bit samples"),
    (lambda: _without(_progressive(), 0xC4), "a Huffman table is missing"),
    (_table_2_without_dht, "a Huffman table is missing"),
    (lambda: _patched_byte(_lossless_rgb(), 0xEE, 14, 1),
     "lossless JPEG in YCbCr"),
    (_lossless_restart_not_rows, "lossless restart interval"),
    (_arithmetic_across_a_block, "arithmetic-coded data across a 65536-byte"),
    (lambda: _patched_byte(_encoded((16, 16), 3, {}), 0xC0, 0, 0xC5),
     "hierarchical JPEG"),
    (lambda: _patched_byte(_patched_byte(_encoded((16, 16), 3, {}), 0xC0,
                                         4, 0x4E), 0xC0, 6, 0x4E),
     "more than the 178,956,970 pixels imageio reads")],
    ids=["cmyk", "half", "tail", "header", "no_eoi",
         *(f"{k}_selected" for k in BAD_DHT), "ss_above_se", "se_64",
         "two_component_ac", "refine_ah", "progressive_half", "sof11",
         "twelve_bit", "progressive_no_dht", "table_2_no_dht",
         "lossless_ycbcr", "lossless_restart_not_rows",
         "arithmetic_across_a_block", "sof5", "decompression_bomb"])
def test_unsupported_input_raises(tmp_path, make, what):
    """What imageio refuses, ``read_image`` refuses, naming the file and
    the feature; and CMYK, which imageio reads as 4 channels (a refusal by
    design)."""
    path = tmp_path / "bad.jpg"
    data = make()
    path.write_bytes(data)
    if what != "CMYK":
        with pytest.raises(Exception):
            imageio.imread(io.BytesIO(data))
    with pytest.raises(ValueError, match=f"bad.jpg: .*{what}"):
        tsd.read_image(str(path))


def _dc_refine_twice():
    """The DC refinement scan sent twice: libjpeg warns
    (JWRN_BOGUS_PROGRESSION: Ah 1 where Al is 0 already) and ORs the same
    bits in again."""
    data = _progressive()
    start, end = _scans(data)[6]
    return data[:end] + data[start:end] + data[end:]


def _ac_before_dc():
    """Y's first AC scan (and the DHT before it) moved before the DC scan:
    an AC scan without a prior DC scan, which libjpeg only warns about."""
    data = _progressive()
    (dc0, dc1), (_, ac1) = _scans(data)[:2]
    return data[:dc0] + data[dc1:ac1] + data[dc0:dc1] + data[ac1:]


@pytest.mark.parametrize("kind", ["baseline", "progressive", "restarts",
                                  "lossless"])
@pytest.mark.parametrize("frac", [0.3, 0.6, 0.8, 0.99])
def test_cut_file_is_read_by_cv2_only(tmp_path, kind, frac):
    """A file cut before its EOI (a broken download): imageio refuses it
    (Pillow reports it truncated), cv2 reads it through a stdio source that
    makes up the EOI, unless the cut leaves no whole scan header, and
    ``read_bgr`` reads or refuses it as cv2 does."""
    if kind == "lossless":
        data = _lossless(_smooth(64, 80), 4, 0)
    else:
        data = _encoded((64, 80), 3, {
            "baseline": {}, "progressive": {"progressive": True},
            "restarts": {"restart_marker_blocks": 2}}[kind])
    data = data[:int(len(data) * frac)]
    with pytest.raises(Exception):
        imageio.imread(io.BytesIO(data))
    with pytest.raises(ValueError, match="truncated"):
        tsd.decode_image(data)
    path = tmp_path / "cut.jpg"
    path.write_bytes(data)
    _assert_read_bgr_is_cv2(path)


@pytest.mark.parametrize("make", [_dc_refine_twice, _ac_before_dc],
                         ids=["dc_refine_twice", "ac_before_dc"])
def test_bogus_progression_decodes_as_libjpeg(make):
    data = make()
    np.testing.assert_array_equal(tsd.decode_image(data),
                                  imageio.imread(io.BytesIO(data)))


def _not_sequential():
    """A baseline file whose SOS has Ss, Se and Ah/Al all zero: libjpeg
    warns (JWRN_NOT_SEQUENTIAL) and decodes it as sequential."""
    data = bytearray(_encoded((45, 61), 3, {"subsampling": 2}))
    at = _scan_params_at(bytes(data), 0)
    data[at:at + 3] = b"\x00\x00\x00"
    return bytes(data)


def _cut_with_eoi(kw, frac=0.6):
    """A file cut inside its last scan, EOI appended: libjpeg reads zeros
    past the data and leaves the segment's later MCUs as they are."""
    data = _encoded((64, 80), 3, kw)
    start, end = _scans(data)[-1]
    return data[:start + int((end - start) * frac)] + b"\xff\xd9"


def _restart_renumbered(ahead):
    """The third restart marker of a file renumbered ``ahead`` of the one
    expected: read and resumed (3), left unread (1: one of the next two),
    or skipped as a prior one (7), as jpeg_resync_to_restart does."""
    data = bytearray(_encoded((64, 80), 3, {"quality": 90,
                                            "restart_marker_blocks": 2}))
    at = [i for i in range(_scans(bytes(data))[0][0], len(data) - 1)
          if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7][2]
    data[at + 1] = 0xD0 + ((data[at + 1] - 0xD0 + ahead) & 7)
    return bytes(data)


@pytest.mark.parametrize("make", [
    _not_sequential,
    lambda: _cut_with_eoi({"quality": 90}),
    lambda: _cut_with_eoi({"quality": 90, "restart_marker_blocks": 4}),
    lambda: _cut_with_eoi({"progressive": True}),
    lambda: _restart_renumbered(1), lambda: _restart_renumbered(3),
    lambda: _restart_renumbered(7)],
    ids=["not_sequential", "cut_baseline", "cut_restarts", "cut_progressive",
         "rst_next", "rst_far", "rst_prior"])
def test_damaged_data_decodes_as_libjpeg(make):
    data = make()
    np.testing.assert_array_equal(tsd.decode_image(data),
                                  imageio.imread(io.BytesIO(data)))


def test_incomplete_script_is_what_libjpeg_smooths():
    """The cut file's Y coefficients 1..63 stop at Al 2: libjpeg smooths
    its blocks (jdcoefct.c decompress_smooth_data), and so does the
    port, bit-equal."""
    data = _incomplete_script()
    ref = imageio.imread(io.BytesIO(data))
    assert ref.shape == (40, 56, 3)
    np.testing.assert_array_equal(tsd.decode_image(data), ref)


def _assert_as_imageio(data):
    ref = imageio.imread(io.BytesIO(data))
    got = tsd.decode_image(data)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def _assert_as_c_code(data):
    """Damaged data: bit-equal to libjpeg-turbo's C code (its SIMD IDCT
    parts from it once coefficients pass 16 bits), or refused where it
    fails."""
    ref = _decode_c(data)
    try:
        got = tsd.decode_image(data)
    except ValueError:
        assert ref is None
        return
    assert ref is not None
    np.testing.assert_array_equal(got.ravel(), ref)


@pytest.mark.parametrize("name", list(BAD_DHT))
def test_unselected_bad_huffman_table_is_ignored(name):
    """A crafted table that the file's own table of the same class and id
    replaces before any scan: libjpeg never builds it, and imageio reads
    the file bit-equal to the clean one."""
    data = _with_dht(*BAD_DHT[name])
    _assert_as_imageio(data)
    np.testing.assert_array_equal(
        tsd.decode_image(data), imageio.imread(io.BytesIO(
            _encoded((16, 16), 3, {}))))


@pytest.mark.parametrize("ch,kw", [
    (1, {"quality": 90}), (3, {"quality": 90}),
    (3, {"quality": 90, "subsampling": 1}),
    (3, {"quality": 50, "subsampling": 0, "restart_marker_blocks": 3}),
    (3, {"quality": 90, "sof1": True})],
    ids=["grey", "420", "422", "444_restarts", "sof1"])
def test_no_dht_reads_the_standard_tables(tmp_path, ch, kw):
    """A sequential file without DHT segments (a Motion-JPEG frame): the
    tables of Annex K.3, as libjpeg-turbo fills them in; bit-equal to
    imageio (and to the file with its tables) and ``read_bgr`` to cv2."""
    kw = dict(kw)
    sof1 = kw.pop("sof1", False)
    data = _encoded((45, 61), ch, kw)
    if sof1:
        data = _patched_byte(data, 0xC0, 0, 0xC1)
    bare = _without(data, 0xC4)
    assert b"\xff\xc4" not in bare
    _assert_as_imageio(bare)
    np.testing.assert_array_equal(tsd.decode_image(bare),
                                  tsd.decode_image(data))
    path = tmp_path / "frame.jpg"
    path.write_bytes(bare)
    _assert_read_bgr_is_cv2(path)


ARITH_SIZES = [(1, 1), (8, 8), (9, 17), (45, 61), (64, 80)]
ARITH_BASES = [(3, {"quality": 90}), (3, {"quality": 75, "subsampling": 0}),
               (3, {"quality": 90, "subsampling": 1}), (1, {"quality": 90})]
ARITH_ARGS = [("arith",), ("arith", "prog"), ("arith", "rst", 3),
              ("arith", "prog", "rst", 2), ("arith", "dac", 2, 5, 20),
              ("arith", "dac", 0, 0, 0), ("arith", "prog", "dac", 1, 4, 2)]


@pytest.mark.parametrize("hw", ARITH_SIZES, ids=str)
@pytest.mark.parametrize("ch,kw", ARITH_BASES,
                         ids=["420", "444", "422", "grey"])
@pytest.mark.parametrize("args", ARITH_ARGS,
                         ids=lambda a: "_".join(map(str, a)))
def test_arithmetic_matches_imageio_and_cv2(tmp_path, hw, ch, kw, args):
    """Arithmetic coding (SOF9, and SOF10 with ``prog``) as the system
    libjpeg writes it from Pillow's file: the same coefficients, so
    imageio reads both alike; restart markers; DAC conditioning (L, U,
    Kx) other than the defaults."""
    base = _encoded(hw, ch, kw)
    data = _transcode(base, *args)
    assert bytes([0xFF, 0xCA if "prog" in args else 0xC9]) in data
    _assert_as_imageio(data)
    np.testing.assert_array_equal(tsd.decode_image(data),
                                  imageio.imread(io.BytesIO(base)))
    path = tmp_path / "a.jpg"
    path.write_bytes(data)
    _assert_read_bgr_is_cv2(path)


@pytest.mark.parametrize("prog", [False, True], ids=["sof9", "sof10"])
def test_arithmetic_without_dac(prog):
    """libjpeg writes a DAC segment before every arithmetic scan; without
    them the decoder takes the defaults (L 0, U 1, Kx 5): the same
    pixels."""
    data = _transcode(_encoded((45, 61), 3, {"quality": 90}), "arith",
                      *(["prog"] if prog else []))
    bare = _without(data, 0xCC)
    assert b"\xff\xcc" in data and b"\xff\xcc" not in bare
    _assert_as_imageio(bare)
    np.testing.assert_array_equal(tsd.decode_image(bare),
                                  tsd.decode_image(data))


def test_arithmetic_across_a_pillow_block_is_read_by_cv2(tmp_path):
    """imageio refuses the 69 KB arithmetic file (Pillow hands libjpeg
    65536 bytes at a time); cv2 reads it through a stdio source, and so
    does ``read_bgr``."""
    data = _arithmetic_across_a_block()
    assert len(data) > 65536
    path = tmp_path / "a.jpg"
    path.write_bytes(data)
    ref = _assert_read_bgr_is_cv2(path)
    assert ref is not None and ref.shape == (333, 501, 3)


def _cut_scans(data, fracs):
    """``data`` cut inside each scan at ``fracs`` of its length, EOI
    appended."""
    return [data[:s + int((e - s) * f)] + b"\xff\xd9"
            for m, s, e in _segments(data) if m == 0xDA for f in fracs]


@pytest.mark.parametrize("args", [("arith",), ("arith", "prog"),
                                  ("arith", "rst", 2),
                                  ("arith", "prog", "rst", 3)],
                         ids=lambda a: "_".join(map(str, a)))
def test_damaged_arithmetic_data_decodes_as_libjpeg(args):
    """Arithmetic data cut inside each scan (zeros after the marker, a
    bad code stopping the segment), and bytes of the data changed at
    random: as libjpeg-turbo's C code decodes them."""
    data = _transcode(_encoded((45, 61), 3, {"quality": 90}), *args)
    rng = np.random.default_rng(len(data))
    cases = _cut_scans(data, (0.3, 0.7))
    scans = [(s, e) for m, s, e in _segments(data) if m == 0xDA]
    for _ in range(12):
        s, e = scans[rng.integers(len(scans))]
        bad = bytearray(data)
        lo = s + 2 + int.from_bytes(data[s + 2:s + 4], "big")
        for _ in range(2):
            bad[int(rng.integers(lo, e))] = int(rng.integers(256))
        cases.append(bytes(bad))
    for case in cases:
        _assert_as_c_code(case)


def test_arithmetic_damaged_sof9_matches_imageio():
    """A baseline file's Huffman data read as arithmetic-coded (its SOF0
    says SOF9)."""
    _assert_as_imageio(_arithmetic())


@pytest.mark.parametrize("psv", range(1, 8))
@pytest.mark.parametrize("pt", [0, 1])
@pytest.mark.parametrize("grey", [False, True], ids=["rgb", "grey"])
@pytest.mark.parametrize("rst", [0, 2], ids=["", "rst"])
def test_lossless_matches_imageio_and_cv2(tmp_path, psv, pt, grey, rst):
    """Lossless JPEG as libjpeg-turbo 3.x writes it (RGB with an Adobe
    marker, or grey): every predictor, point transforms 0 and 1, restart
    intervals of 2 rows; imageio returns the samples (shifted right by Pt
    and back); cv2 reads no grey lossless file, and ``read_bgr`` raises
    there."""
    img = _smooth(45, 61)
    if grey:
        img = img[..., 1]
    data = _lossless(img, psv, pt, *(["rst", rst] if rst else []))
    assert b"\xff\xc3" in data
    _assert_as_imageio(data)
    np.testing.assert_array_equal(tsd.decode_image(data),
                                  (img >> pt) << pt)
    path = tmp_path / "l.jpg"
    path.write_bytes(data)
    ref = _assert_read_bgr_is_cv2(path)
    assert (ref is None) == grey


@pytest.mark.parametrize("precision", [2, 5, 7])
def test_lossless_below_8_bits_is_read_by_cv2_only(tmp_path, precision):
    """libjpeg-turbo reads 2- to 7-bit lossless samples through its 8-bit
    interface: cv2 returns them as they are (an RGB file; a grey one it
    refuses), imageio's Pillow reads 8-bit files only."""
    img = _smooth(45, 61) >> (8 - precision)
    data = _lossless_by_hand([img[..., i] for i in range(3)],
                             [(1, 1)] * 3, (45, 61), 4, 0, restart_rows=3,
                             precision=precision)
    with pytest.raises(Exception):
        imageio.imread(io.BytesIO(data))
    with pytest.raises(ValueError, match=f"{precision}-bit samples"):
        tsd.decode_image(data)
    path = tmp_path / "l.jpg"
    path.write_bytes(data)
    ref = _assert_read_bgr_is_cv2(path)
    np.testing.assert_array_equal(ref[..., ::-1], img)


@pytest.mark.parametrize("hw", [(1, 1), (1, 9), (9, 1), (333, 501)], ids=str)
def test_lossless_sizes_match_imageio(hw):
    for psv in (1, 4, 7):
        _assert_as_imageio(_lossless(_smooth(*hw), psv, 0, "rst", 1))


STD_DC_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]


def _lossless_by_hand(planes, samp, size, psv, pt, restart_rows=0,
                      separate=False, precision=8):
    """A lossless file libjpeg-turbo's encoder does not write: an image of
    ``size`` (H, W) with components at sampling factors ``samp`` (planes at
    their own sizes), one interleaved scan or one scan per component,
    restarts every ``restart_rows`` MCU rows, samples of ``precision``
    bits. The differences come from the plain predictors (the first row
    and column, and each restart's first row, predicted as the standard
    says); the table is Annex K.3's first DC table, sent in a DHT."""
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(STD_DC_BITS[length - 1]):
            codes[k] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    ids = [82, 71, 66][:len(planes)] if len(planes) == 3 else [1]
    hmax = max(h for h, v in samp)
    vmax = max(v for h, v in samp)
    hh, ww = size

    def seg(m, body):
        return bytes([0xFF, m]) + (len(body) + 2).to_bytes(2, "big") + body

    out = bytearray(b"\xff\xd8")
    if len(planes) == 3:
        out += seg(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00")
    out += seg(0xC3, bytes([precision]) + hh.to_bytes(2, "big")
               + ww.to_bytes(2, "big") + bytes([len(planes)])
               + b"".join(bytes([i, h << 4 | v, 0])
                          for i, (h, v) in zip(ids, samp)))
    out += seg(0xC4, bytes([0] + STD_DC_BITS + list(range(12))))
    mcux, mcuy = -(-ww // hmax), -(-hh // vmax)
    for sc in ([[i] for i in range(len(planes))] if separate
               else [list(range(len(planes)))]):
        single = len(sc) == 1
        per_row = planes[sc[0]].shape[1] if single else mcux
        out += seg(0xDD, (restart_rows * per_row).to_bytes(2, "big"))
        out += seg(0xDA, bytes([len(sc)])
                   + b"".join(bytes([ids[i], 0]) for i in sc)
                   + bytes([psv, 0, pt]))
        res = {}
        for i in sc:
            x = planes[i].astype(np.int64) >> pt
            v = samp[i][1]
            r = np.zeros_like(x)
            for y in range(x.shape[0]):
                mrow = y if single else y // v
                first = y == 0 or (restart_rows and mrow % restart_rows == 0
                                   and (single or y % v == 0))
                for c in range(x.shape[1]):
                    if first:
                        pred = (1 << (precision - pt - 1)) if c == 0 \
                            else x[y, c - 1]
                    elif c == 0:
                        pred = x[y - 1, 0]
                    else:
                        ra, rb, rc = x[y, c - 1], x[y - 1, c], x[y - 1, c - 1]
                        pred = [0, ra, rb, rc, ra + rb - rc,
                                ra + ((rb - rc) >> 1), rb + ((ra - rc) >> 1),
                                (ra + rb) >> 1][psv]
                    r[y, c] = (x[y, c] - pred) & 0xFFFF
            res[i] = r
        bits = []

        def put(value, n):
            bits.extend((value >> j) & 1 for j in range(n - 1, -1, -1))

        def diff(i, y, c):
            r = res[i]
            d = int(r[y, c]) if y < r.shape[0] and c < r.shape[1] else 0
            d = d - 65536 if d >= 32768 else d
            s = abs(d).bit_length()
            put(*codes[s])
            if s:
                put(d if d > 0 else d + (1 << s) - 1, s)

        def flush():
            bits.extend([1] * (-len(bits) % 8))
            for j in range(0, len(bits), 8):
                byte = int("".join(map(str, bits[j:j + 8])), 2)
                out.append(byte)
                if byte == 0xFF:
                    out.append(0)
            bits.clear()

        rows = planes[sc[0]].shape[0] if single else mcuy
        for my in range(rows):
            if restart_rows and my and my % restart_rows == 0:
                flush()
                out.extend([0xFF, 0xD0 + (my // restart_rows - 1) % 8])
            for mx in range(per_row):
                if single:
                    diff(sc[0], my, mx)
                    continue
                for i in sc:
                    h, v = samp[i]
                    for yy in range(v):
                        for xx in range(h):
                            diff(i, my * v + yy, mx * h + xx)
        flush()
    return bytes(out + b"\xff\xd9")


@pytest.mark.parametrize("samp", [[(2, 2), (1, 1), (1, 1)],
                                  [(2, 1), (1, 1), (1, 1)],
                                  [(1, 2), (1, 1), (1, 1)],
                                  [(4, 1), (1, 1), (1, 1)],
                                  [(2, 2), (2, 1), (1, 2)]],
                         ids=["420", "422", "440", "411", "mixed"])
@pytest.mark.parametrize("separate", [False, True],
                         ids=["interleaved", "per_component"])
def test_subsampled_lossless_matches_imageio_and_cv2(tmp_path, samp,
                                                     separate):
    """Lossless files at sampling factors other than 1x1 (libjpeg upsamples
    them by replication: no fancy upsampling at a DCT size of 1), in one
    interleaved scan or one scan per component, with restarts."""
    hh, ww = 33, 50
    hmax = max(h for h, v in samp)
    vmax = max(v for h, v in samp)
    img = _smooth(hh, ww)
    planes = [np.ascontiguousarray(img[::vmax // v, ::hmax // h, i])
              for i, (h, v) in enumerate(samp)]
    data = _lossless_by_hand(planes, samp, (hh, ww), 4, 1, restart_rows=2,
                             separate=separate)
    _assert_as_imageio(data)
    path = tmp_path / "l.jpg"
    path.write_bytes(data)
    _assert_read_bgr_is_cv2(path)


@pytest.mark.parametrize("frac", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("rst", [0, 1], ids=["", "rst"])
def test_damaged_lossless_data_decodes_as_libjpeg(frac, rst):
    """A lossless scan cut at ``frac`` of its length, EOI appended: the
    rows past the cut are zero differences from restarted predictors."""
    data = _lossless(_smooth(45, 61), 4, 0, *(["rst", rst] if rst else []))
    (case,) = _cut_scans(data, (frac,))
    _assert_as_imageio(case)
    _assert_as_c_code(case)


SMOOTH_FILES = {
    "pillow_420": lambda: _encoded((45, 61), 3, {"progressive": True}),
    "pillow_444": lambda: _encoded((64, 80), 3, {"progressive": True,
                                                 "subsampling": 0,
                                                 "quality": 75}),
    "pillow_grey": lambda: _encoded((33, 65), 1, {"progressive": True}),
    "narrow": lambda: _encoded((17, 9), 3, {"progressive": True}),
    "cv2_prog": lambda: _cv2_encoded(_smooth(45, 61), "prog"),
    "arith_prog": lambda: _transcode(_encoded((45, 61), 3, {"quality": 90}),
                                     "arith", "prog"),
    "script": lambda: _transcode(
        _encoded((45, 61), 3, {"quality": 90}), "script",
        "3 0 1 2 0 0 0 1; 1 0 1 9 0 3; 1 1 1 63 0 0; 1 2 1 63 0 0; "
        "1 0 10 63 0 0; 1 0 1 9 3 2; 3 0 1 2 0 0 1 0"),
}


@pytest.mark.parametrize("name", list(SMOOTH_FILES))
def test_progressive_cut_after_each_scan_matches_imageio(name):
    """A progressive file cut after each of its scans, EOI appended (a cut
    download): where the first nine AC coefficients are unfinished libjpeg
    smooths the blocks from a 5x5 neighbourhood of DC values, and where
    no AC has come it estimates the DC too."""
    data = SMOOTH_FILES[name]()
    starts = [s for m, s, e in _segments(data) if m == 0xDA]
    assert len(starts) > 1
    for start in starts[1:]:
        _assert_as_imageio(data[:start] + b"\xff\xd9")


@pytest.mark.parametrize("name", list(SMOOTH_FILES))
def test_progressive_cut_inside_a_scan_decodes_as_libjpeg(name):
    """Cut inside each scan: past the last good iMCU row of the last scan
    libjpeg smooths with the previous scan's coefficient bits."""
    for case in _cut_scans(SMOOTH_FILES[name](), (0.4,)):
        _assert_as_c_code(case)


def test_hashes_match_imageio_and_cv2():
    """The committed hash file is what imageio and cv2 give here, and the
    port's reads give the same hashes."""
    record = json.loads((FIXTURES / "hashes.json").read_text())
    assert record["scene"] == SCENE
    assert sorted(record["files"]) == sorted(NAMES)
    for name, want in record["files"].items():
        path = FIXTURES / name
        assert digest(imageio.imread(path)) == want["imageio"]
        assert digest(tsd.read_image(str(path))) == want["imageio"]
        if want["cv2"] is None:  # cv2 reads nothing: read_bgr raises
            assert cv2.imread(str(path)) is None
            with pytest.raises(ValueError, match=name):
                read_bgr(str(path))
            continue
        assert digest(cv2.imread(str(path))) == want["cv2"]
        assert digest(read_bgr(str(path))) == want["cv2"]


def test_decoder_is_bit_equal_on_a_12_megapixel_photo():
    """A phone-sized 4:2:0 frame (3000x4000)."""
    data = _encoded((3000, 4000), 3, {"quality": 90, "subsampling": 2},
                    seed=4)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data),
                                  imageio.imread(io.BytesIO(data)))


def test_decoder_is_bit_equal_on_a_12_megapixel_progressive_photo():
    """The same frame as a progressive 4:2:0 file."""
    data = _encoded((3000, 4000), 3, {"quality": 90, "subsampling": 2,
                                      "progressive": True}, seed=4)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data),
                                  imageio.imread(io.BytesIO(data)))


if __name__ == "__main__":
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else FIXTURES
    make_fixtures(out)
    print(f"wrote {sorted(os.listdir(out))}")
