"""SDF -> density transforms (VolSDF Laplace CDF; port of
``spurfies_tpu/core/density.py``).

``density(s) = alpha * (0.5 + 0.5 * sign(s) * expm1(-|s| / beta))`` with
``alpha = 1/beta`` and ``beta = |beta_param| + beta_min``.
"""

import torch


def get_beta(beta_param: torch.Tensor, beta_min: float = 1e-4) -> torch.Tensor:
    return torch.abs(beta_param) + beta_min


def laplace_density(sdf: torch.Tensor, beta) -> torch.Tensor:
    """Laplace CDF density; ``beta`` broadcasts against ``sdf`` (the
    error-bounded sampler passes a per-ray beta)."""
    alpha = 1.0 / beta
    return alpha * (0.5 + 0.5 * torch.sign(sdf)
                    * torch.expm1(-torch.abs(sdf) / beta))
