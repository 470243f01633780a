"""PNG codec on ``zlib`` and numpy (what the JAX package reads through
imageio and Pillow).

``read_png`` / ``decode_png`` take 8- and 16-bit gray, gray+alpha, RGB and
RGBA, non-interlaced, with any of the five row filters (libpng and Pillow
pick one per row, Paeth included).  ``write_png`` / ``encode_png`` write the
same types with a given filter on every row (Sub by default) or one per
row.

The Average and Paeth filters are recurrences along a row: byte ``x`` needs
the reconstructed byte ``x - bpp`` of the same row, and ``x`` and ``x - bpp``
of the row above.  A pixel's left, upper and upper-left neighbours all lie
on the anti-diagonal before its own, so the image is reconstructed one
anti-diagonal at a time (``H + W - 1`` numpy steps, each over every row that
the diagonal crosses) in a diagonal-major copy where each diagonal is one
contiguous slice.  Images whose rows use only None, Sub and Up are
reconstructed a row at a time (Sub is a cumulative sum mod 256).
"""

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels: gray, RGB, gray+alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


def read_png(path) -> np.ndarray:
    """The image of a PNG file: ``[H, W]`` for gray, else ``[H, W, C]``;
    uint8 or uint16 by the file's bit depth."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG file ends before its IEND chunk")


def decode_png(data: bytes) -> np.ndarray:
    """:func:`read_png` on the bytes of a file."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    w, h, depth, ctype, comp, filt_method, interlace = header
    if ctype not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"unsupported PNG colour type {ctype} at bit depth "
                         f"{depth} (8- or 16-bit gray, gray+alpha, RGB, "
                         "RGBA only)")
    if comp != 0 or filt_method != 0 or interlace != 0:
        raise ValueError("unsupported PNG: interlaced or unknown method")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (w * bpp + 1):
        raise ValueError("PNG image data is truncated")
    rows = raw[:h * (w * bpp + 1)].reshape(h, w * bpp + 1)
    ftype = rows[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"unknown PNG row filter {int(ftype.max())}")
    filt = rows[:, 1:].reshape(h, w, bpp)
    if np.isin(ftype, (3, 4)).any():
        out = _unfilter_diagonals(filt, ftype)
    else:
        out = _unfilter_rows(filt, ftype)
    if depth == 16:
        out = out.view(">u2").astype(np.uint16)
    out = out.reshape(h, w, ch)
    return out[..., 0] if ch == 1 else out


def _unfilter_rows(filt, ftype):
    """Rows filtered with None, Sub or Up, one row at a time."""
    out = np.empty_like(filt)
    prev = np.zeros_like(filt[0])
    for y, t in enumerate(ftype.tolist()):
        if t == 0:
            out[y] = filt[y]
        elif t == 1:            # Sub: a running sum along the row, mod 256
            np.cumsum(filt[y], axis=0, dtype=np.uint8, out=out[y])
        else:                   # Up
            np.add(filt[y], prev, out=out[y])
        prev = out[y]
    return out


def _unfilter_diagonals(filt, ftype):
    """Any mix of the five filters, one anti-diagonal ``d = y + x`` at a
    time.  ``rec[d + 2, y + 1]`` holds the reconstructed pixel ``(y, d -
    y)``; the row and the two diagonals of zeros in front stand for the
    pixels outside the image, which the filters read as 0."""
    h, w, bpp = filt.shape
    n_diag = h + w - 1
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    diag = np.zeros((n_diag, h, bpp), np.int16)
    diag[ys + xs, ys] = filt
    rec = np.zeros((n_diag + 2, h + 1, bpp), np.int16)
    t = ftype.astype(np.int16)[:, None]
    is_sub, is_up, is_avg, is_paeth = (t == 1), (t == 2), (t == 3), (t == 4)
    for d in range(n_diag):
        lo, hi = max(0, d - w + 1), min(h, d + 1)
        a = rec[d + 1, lo + 1:hi + 1]       # left
        b = rec[d + 1, lo:hi]               # up
        c = rec[d, lo:hi]                   # up-left
        pred = np.where(is_sub[lo:hi], a, 0)
        pred = np.where(is_up[lo:hi], b, pred)
        pred = np.where(is_avg[lo:hi], (a + b) >> 1, pred)
        pred = np.where(is_paeth[lo:hi], _paeth(a, b, c), pred)
        rec[d + 2, lo + 1:hi + 1] = (diag[d, lo:hi] + pred) & 255
    return rec[ys + xs + 2, ys + 1].astype(np.uint8)


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(img, filter_type=1) -> bytes:
    """PNG bytes of ``img``: uint8 or uint16, ``[H, W]`` or ``[H, W, C]``
    with C in 1..4 (gray, gray+alpha, RGB, RGBA).  ``filter_type``: the row
    filter (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth) of every row, or a
    sequence of one per row."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG pixels must be uint8 or uint16, not "
                         f"{img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"PNG image shape {img.shape}: want [H, W] or "
                         "[H, W, C] with C in 1..4")
    h, w, ch = img.shape
    ftype = np.broadcast_to(np.asarray(filter_type, np.uint8), (h,))
    if ftype.max(initial=0) > 4:
        raise ValueError("PNG row filters are 0..4")
    depth = 8 * img.dtype.itemsize
    px = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    x = px.view(np.uint8).reshape(h, w, -1).astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]                 # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]                       # up
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]              # up-left
    preds = (np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, c))
    t = ftype[:, None, None]
    pred = np.select([t == k for k in range(5)], preds)
    filt = ((x - pred) & 255).astype(np.uint8)
    rows = np.concatenate([ftype[:, None], filt.reshape(h, -1)], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[ch], 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path, img, filter_type=1):
    """Write :func:`encode_png`'s bytes to ``path``."""
    with open(path, "wb") as f:
        f.write(encode_png(img, filter_type))
