"""JPEG reader on the port's host decoder (what the JAX package reads
through imageio, i.e. libjpeg-turbo under Pillow, and through cv2).

``read_jpeg`` / ``decode_jpeg`` return the pixels bit-equal to
``imageio.v2.imread``'s: ``[H, W]`` uint8 for grey, ``[H, W, 3]`` for
colour.  The decoder (``csrc/host_jpeg.cpp``, built by the host compiler at
first use through ``ops.cuda_build``) takes baseline, extended sequential
and progressive Huffman JPEG with 8-bit samples, grey or three components
at any integral sampling ratio (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, ...),
restart markers and any image size, and reads damaged data as libjpeg
does (zeros past the end of a segment, its restart resync).  Anything
else raises a ``ValueError`` that names the file and the feature:
arithmetic coding, lossless and hierarchical JPEG, 12-bit samples,
CMYK/YCCK, fractional sampling ratios, progressive scans that libjpeg
rejects, a progressive script that stops before the first nine AC
coefficients are whole (libjpeg smooths such blocks), truncated data.  A
library that does not build raises too: there is no other decoder.

The pixels of ``read_jpeg`` ignore the EXIF orientation tag, as
imageio's do; ``decode_jpeg(..., oriented=True)`` turns them the way
``cv2.imread`` does, and ``orientation`` reads the tag (1 when absent).
"""

import ctypes

import numpy as np

from spurfies_tpu_torch.ops import cuda_build

SIGNATURE = b"\xff\xd8"
_ERR = 256
_SIG = {
    "host_jpeg_info": [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_char_p, ctypes.c_int],
    "host_jpeg_decode": [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                         ctypes.c_int64, ctypes.c_char_p, ctypes.c_int],
}


def _info(lib, data: bytes, name: str) -> np.ndarray:
    info = np.zeros(4, dtype=np.int32)
    err = ctypes.create_string_buffer(_ERR)
    if lib.host_jpeg_info(data, len(data), info.ctypes.data, err, _ERR):
        raise ValueError(f"{name}: {err.value.decode()}")
    return info


def decode_jpeg(data: bytes, name: str = "JPEG data",
                oriented: bool = False) -> np.ndarray:
    """The pixels of a JPEG file's bytes: ``[H, W]`` or ``[H, W, 3]``
    uint8, as stored, or with ``oriented`` turned as the EXIF orientation
    tag asks (``apply_orientation``).  ``name`` goes into the error
    messages."""
    lib = cuda_build.load("host_jpeg", _SIG)
    data = bytes(data)
    h, w, c, tag = _info(lib, data, name)
    out = np.empty((h, w, c) if c > 1 else (h, w), dtype=np.uint8)
    err = ctypes.create_string_buffer(_ERR)
    if lib.host_jpeg_decode(data, len(data), out.ctypes.data, out.size,
                            err, _ERR):
        raise ValueError(f"{name}: {err.value.decode()}")
    return apply_orientation(out, int(tag)) if oriented else out


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
