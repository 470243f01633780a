"""Pixel grid (copy of ``make_uv`` of ``spurfies_tpu/data/scene_data.py``)."""

import numpy as np


def make_uv(h: int, w: int) -> np.ndarray:
    """Pixel grid ``[h*w, 2]`` in (x, y) order, matching reference
    ``np.mgrid`` + flip (own_data.py:130-132)."""
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([xx, yy], axis=-1).reshape(-1, 2).astype(np.float32)
