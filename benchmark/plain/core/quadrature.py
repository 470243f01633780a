"""Volume-rendering quadrature (port of ``spurfies_tpu/core/quadrature.py``).

``free_energy = deltas * density``; transmittance is the exp of the negative
cumsum of the one-step-shifted free energy; ``weights = alpha * T``.
"""

import torch


def render_weights(deltas: torch.Tensor, density: torch.Tensor) -> torch.Tensor:
    """Per-sample rendering weights ``[R, S]`` = alpha * transmittance.

    Invalid samples must have delta 0 so that they are no-ops.
    """
    free_energy = deltas * density
    shifted = torch.cat(
        [torch.zeros_like(free_energy[..., :1]), free_energy[..., :-1]], dim=-1)
    alpha = 1.0 - torch.exp(-free_energy)
    transmittance = torch.exp(-torch.cumsum(shifted, dim=-1))
    return alpha * transmittance
