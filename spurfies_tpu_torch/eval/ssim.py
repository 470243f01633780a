"""SSIM matching skimage.measure.structural_similarity defaults (copy of
``spurfies_tpu/eval/ssim.py``, host numpy/scipy).

The reference scores NVS renders with skimage SSIM
(eval_spurfies.py:258-272); skimage is absent here, so this reimplements the
same estimator: 7x7 uniform windows, K1=0.01, K2=0.03, sample covariance
normalization (N/(N-1)), channel-averaged.
"""

import numpy as np
from scipy.ndimage import uniform_filter


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0,
         win_size: int = 7) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.ndim == 3:
        return float(np.mean([
            ssim(a[..., c], b[..., c], data_range, win_size)
            for c in range(a.shape[-1])
        ]))

    K1, K2 = 0.01, 0.03
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    n = win_size ** a.ndim
    cov_norm = n / (n - 1)

    ux = uniform_filter(a, size=win_size)
    uy = uniform_filter(b, size=win_size)
    uxx = uniform_filter(a * a, size=win_size)
    uyy = uniform_filter(b * b, size=win_size)
    uxy = uniform_filter(a * b, size=win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    s = ((2 * ux * uy + C1) * (2 * vxy + C2)) / (
        (ux ** 2 + uy ** 2 + C1) * (vx + vy + C2)
    )
    pad = (win_size - 1) // 2
    return float(s[pad:-pad, pad:-pad].mean())
