"""The port's JPEG reader (``data.jpeg``, ``csrc/host_jpeg.cpp`` built here
with the host compiler) against imageio and cv2, on the CPU.

* ``scene_data.read_image`` bit-equal to ``imageio.v2.imread`` on every
  committed fixture and on files that Pillow writes here: 4:4:4, 4:2:2 and
  4:2:0, grey, quality 50 and 95, with and without restart markers, the
  optimized Huffman tables, RGB kept as RGB (Adobe transform 0), sizes from
  1x1 to 333x501, sequential and progressive; and on files that cv2 writes:
  progressive, 4:4:0 and 4:1:1 (where ``read_bgr`` is bit-equal to
  ``cv2.imread`` too).
* progressive scripts that libjpeg only warns about, and damaged data
  (a file cut inside a scan with EOI appended, renumbered restart
  markers, a sequential scan with other scan parameters), decode as it
  decodes them.
* ``load_image(p, img_res)`` within ``resize_cubic``'s stated bound
  (``max(H, W) * 2**-22`` on [0, 1] images) of the JAX package's.
* ``mvs_local.read_bgr`` bit-equal to ``cv2.imread``, which turns a file by
  its EXIF orientation tag (imageio does not: ``read_image`` ignores it).
* CMYK, arithmetic-coded, truncated files, bad progressive scans and an
  incomplete progressive script raise ``ValueError``.
* ``tests/fixtures/jpeg/hashes.json`` (the SHA-256 of imageio's and cv2's
  arrays of each fixture, which ``chip_smoke.py`` holds the card machine's
  decodes to, where neither library is installed) against imageio and cv2.

The fixtures are made by :func:`make_fixtures` (``python
tests/test_torch_jpeg.py`` writes them again): three views of one
``export_synthetic_own_data`` scene (``SCENE``) at 4:2:0, quality 90, each
just over 1 MP; one 4:4:4 file with a restart marker every 5 MCUs; one
4:2:0 file with EXIF orientation 6; a progressive 4:2:0 copy of view 0;
views 1 and 2 as cv2 writes them at 4:4:0 and 4:1:1.
"""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import hashlib
import io
import json
import os
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
# the own-data scene the three views are of (export_synthetic_own_data)
SCENE = {"scan": "jpeg_views", "n_views": 3, "img_res": [888, 1184],
         "seed": 5}
VIEWS = [f"view_{i}.jpg" for i in range(SCENE["n_views"])]
RESTART = "restart_444.jpg"
EXIF = "exif_6.jpg"
PROGRESSIVE = "progressive_420.jpg"
CV2_440 = "cv2_440.jpg"
CV2_411 = "cv2_411.jpg"
NAMES = VIEWS + [RESTART, EXIF, PROGRESSIVE, CV2_440, CV2_411]


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
            else:
                extra = CV2_440 if i == 1 else CV2_411
                (out / extra).write_bytes(_cv2_encoded(img, extra[4:7]))
    Image.fromarray(_smooth(333, 501, seed=1)).save(
        out / RESTART, "JPEG", quality=90, subsampling=0,
        restart_marker_blocks=5)
    exif = Image.Exif()
    exif[0x0112] = 6
    small = Image.open(out / VIEWS[0]).resize((160, 120))
    small.save(out / EXIF, "JPEG", quality=90, subsampling=2,
               exif=exif.tobytes())
    record = {"scene": SCENE, "files": {
        n: {"imageio": digest(imageio.imread(out / n)),
            "cv2": digest(cv2.imread(str(out / n)))} for n in NAMES}}
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
    assert total <= 512 * 1024
    for name in (PROGRESSIVE, CV2_440, CV2_411):
        assert (FIXTURES / name).stat().st_size <= 150 * 1024


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


@pytest.mark.parametrize("name", [EXIF, VIEWS[2], PROGRESSIVE, CV2_440,
                                  CV2_411])
def test_read_bgr_matches_cv2(name):
    """cv2 turns the EXIF-6 file a quarter turn clockwise; imageio and
    ``read_image`` keep it as stored."""
    path = str(FIXTURES / name)
    ref = cv2.imread(path)
    np.testing.assert_array_equal(read_bgr(path), ref)
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
    out, pos = [], 2
    while data[pos + 1] != 0xD9:
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] != 0
                       and not 0xD0 <= data[end + 1] <= 0xD7):
                end += 1
            out.append((pos, end))
        pos = end
    return out


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
    """A baseline file whose SOF0 says SOF9 (arithmetic coding)."""
    data = bytearray(_encoded((16, 16), 3, {}))
    data[bytes(data).index(b"\xff\xc0") + 1] = 0xC9
    return bytes(data)


def _cmyk():
    buf = io.BytesIO()
    Image.fromarray(_smooth(40, 56)).convert("CMYK").save(buf, "JPEG")
    return buf.getvalue()


def _truncated(frac):
    data = _encoded((64, 80), 3, {"quality": 90})
    return data[:int(len(data) * frac)]


def _with_dht(tc, counts, symbols):
    """A valid file with one crafted DHT segment put first: table class
    ``tc``, ``counts[l - 1]`` codes of length ``l``."""
    counts = list(counts) + [0] * (16 - len(counts))
    body = bytes([tc << 4, *counts, *symbols])
    seg = b"\xff\xc4" + (2 + len(body)).to_bytes(2, "big") + body
    data = _encoded((16, 16), 3, {})
    return data[:2] + seg + data[2:]


@pytest.mark.parametrize("make,what", [
    (_cmyk, "CMYK"),
    (lambda: _truncated(0.5), "truncated"),
    (lambda: _truncated(0.98), "truncated"),
    (lambda: b"\xff\xd8\xff", "truncated"),
    (lambda: _encoded((8, 8), 3, {})[:-2], "truncated"),
    (lambda: _with_dht(0, [3], [0, 1, 2]), "bad Huffman table"),
    (lambda: _with_dht(1, [0, 200], [0] * 200), "bad Huffman table"),
    (lambda: _with_dht(1, [0, 4], [0] * 4), "bad Huffman table"),
    (lambda: _with_dht(0, [1], [16]), "bad Huffman table"),
    (lambda: _patched(1, 0, 6), "bad progressive scan .*Ss > Se"),
    (lambda: _patched(2, 1, 64), "bad progressive scan .*Se > 63"),
    (_two_component_ac,
     "bad progressive scan .*an AC scan of more than one component"),
    (lambda: _patched(6, 2, 0x20),
     "bad progressive scan .*a refinement scan with Al != Ah - 1"),
    (lambda: _progressive()[:len(_progressive()) // 2], "truncated"),
    (_incomplete_script, "incomplete progressive script"),
    (_arithmetic, "arithmetic")],
    ids=["cmyk", "half", "tail", "header", "no_eoi",
         "dht_overfull_1", "dht_overfull_200", "dht_all_ones",
         "dht_dc_symbol_16", "ss_above_se", "se_64", "two_component_ac",
         "refine_ah", "progressive_half", "incomplete_script", "sof9"])
def test_unsupported_input_raises(tmp_path, make, what):
    path = tmp_path / "bad.jpg"
    path.write_bytes(make())
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
    """imageio reads the cut file (libjpeg smooths its blocks), so the
    port's refusal is a refusal of smoothing, not of the file."""
    data = _incomplete_script()
    assert imageio.imread(io.BytesIO(data)).shape == (40, 56, 3)


def test_hashes_match_imageio_and_cv2():
    """The committed hash file is what imageio and cv2 give here, and the
    port's reads give the same hashes."""
    record = json.loads((FIXTURES / "hashes.json").read_text())
    assert record["scene"] == SCENE
    assert sorted(record["files"]) == sorted(NAMES)
    for name, want in record["files"].items():
        path = FIXTURES / name
        assert digest(imageio.imread(path)) == want["imageio"]
        assert digest(cv2.imread(str(path))) == want["cv2"]
        assert digest(tsd.read_image(str(path))) == want["imageio"]
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
