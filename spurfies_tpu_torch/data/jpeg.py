"""JPEG reader on the port's host decoder (what the JAX package reads
through imageio, i.e. libjpeg-turbo under Pillow, and through cv2).

``read_jpeg`` / ``decode_jpeg`` return the pixels bit-equal to
``imageio.v2.imread``'s: ``[H, W]`` uint8 for grey, ``[H, W, 3]`` for
colour.  The decoder (``csrc/host_jpeg.cpp``, built by the host compiler at
first use through ``ops.cuda_build``) takes every JPEG file that imageio
reads: baseline, extended sequential, progressive and lossless Huffman
JPEG and sequential and progressive arithmetic-coded JPEG, with 8-bit
samples, grey or three components at any integral sampling ratio (4:4:4,
4:2:2, 4:2:0, 4:4:0, 4:1:1, ...), restart markers and any image size.  It
smooths the blocks of a progressive file whose script stops before the
first nine AC coefficients are whole (a cut download) as libjpeg-turbo
does, gives a sequential file without DHT segments (a Motion-JPEG frame)
the standard tables, builds and checks a Huffman table only when a scan
selects it, and reads damaged data as libjpeg does (zeros past the end
of a segment, its restart resync).  Anything else raises a
``ValueError`` that names the file and the feature: lossless arithmetic
and hierarchical JPEG, samples of other than 8 bits, CMYK/YCCK,
fractional sampling ratios, scans that libjpeg rejects, lossless files in
YCbCr, truncated data, an image above the reader's size limit (Pillow's
decompression-bomb limit, cv2's ``CV_IO_MAX_IMAGE_PIXELS``), and an
arithmetic-coded file whose decoder would
read a byte at a multiple of 65536 (Pillow hands libjpeg the file in
blocks of that size, and libjpeg's arithmetic decoder cannot wait for the
next one: imageio refuses such files, ``as_cv2`` reads them).  A library
that does not build raises too: there is no other decoder.

The pixels of ``read_jpeg`` ignore the EXIF orientation tag, as
imageio's do; ``decode_jpeg(..., as_cv2=True)`` reads them as
``cv2.imread`` does (turned as the tag asks, a file cut before its EOI
read as far as it goes, refused for a grey lossless file, which libjpeg
will not convert to colour), and
``orientation`` reads the tag (1 when absent).
"""

import ctypes

import numpy as np

from spurfies_tpu_torch.ops import cuda_build

SIGNATURE = b"\xff\xd8"
# the largest image each reader takes: imageio's Pillow refuses one above
# twice Image.MAX_IMAGE_PIXELS (DecompressionBombError), cv2.imread one
# above CV_IO_MAX_IMAGE_PIXELS
PILLOW_MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)
CV2_MAX_PIXELS = 1 << 30
_MADE_UP_EOI = b"\xff\xd9" * 32768
_ERR = 256
_SIG = {
    "host_jpeg_info": [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_char_p, ctypes.c_int],
    "host_jpeg_decode": [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                         ctypes.c_int64, ctypes.c_int, ctypes.c_char_p,
                         ctypes.c_int],
}


def _info(lib, data: bytes, name: str) -> np.ndarray:
    info = np.zeros(4, dtype=np.int32)
    err = ctypes.create_string_buffer(_ERR)
    if lib.host_jpeg_info(data, len(data), info.ctypes.data, err, _ERR):
        raise ValueError(f"{name}: {err.value.decode()}")
    return info


def decode_jpeg(data: bytes, name: str = "JPEG data",
                as_cv2: bool = False) -> np.ndarray:
    """The pixels of a JPEG file's bytes: ``[H, W]`` or ``[H, W, 3]``
    uint8, as stored (as imageio reads them), or with ``as_cv2`` as
    ``cv2.imread`` reads them in colour: turned as the EXIF orientation tag
    asks (``apply_orientation``), a cut file read up to its end, and
    refused where libjpeg refuses the colour (a grey lossless file).
    ``name`` goes into the error messages."""
    lib = cuda_build.load("host_jpeg", _SIG)
    data = bytes(data)
    if as_cv2:
        # cv2 reads through libjpeg's stdio source, which hands out an EOI
        # marker each time it is asked for bytes past the end (jdatasrc.c):
        # a cut file reads as one whose data stop there, and a segment
        # running past the end reads those bytes (64 KiB cover any segment)
        data += _MADE_UP_EOI
    h, w, c, tag = _info(lib, data, name)
    limit = CV2_MAX_PIXELS if as_cv2 else PILLOW_MAX_PIXELS
    if int(h) * int(w) > limit:
        raise ValueError(f"{name}: {w}x{h} is more than the {limit:,} pixels "
                         f"{'cv2' if as_cv2 else 'imageio'} reads")
    out = np.empty((h, w, c) if c > 1 else (h, w), dtype=np.uint8)
    err = ctypes.create_string_buffer(_ERR)
    if lib.host_jpeg_decode(data, len(data), out.ctypes.data, out.size,
                            int(as_cv2), err, _ERR):
        raise ValueError(f"{name}: {err.value.decode()}")
    return apply_orientation(out, int(tag)) if as_cv2 else out


def read_jpeg(path) -> np.ndarray:
    """:func:`decode_jpeg` of a file."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), str(path))


def orientation(data: bytes, name: str = "JPEG data") -> int:
    """The EXIF orientation tag (1..8) of a JPEG file's bytes, 1 when the
    file has none."""
    return int(_info(cuda_build.load("host_jpeg", _SIG), bytes(data),
                     name)[3])


def apply_orientation(img: np.ndarray, tag: int) -> np.ndarray:
    """``img`` ([H, W, ...]) turned as EXIF ``tag`` asks and as
    ``cv2.imread`` turns it: 2 mirror, 3 rotate 180, 4 flip, 5 transpose,
    6 rotate 90 clockwise, 7 transverse, 8 rotate 90 counter-clockwise."""
    if tag in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    if tag in (2, 3, 6, 7):
        img = img[:, ::-1]
    if tag in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)
