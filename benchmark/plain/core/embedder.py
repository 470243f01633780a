"""NeRF-style sinusoidal positional encoding (port of
``spurfies_tpu/core/embedder.py``).

include_input, log-sampled frequency bands ``2**0 .. 2**(multires-1)``,
concatenation order ``[x, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...]``.
"""

import torch


def encoding_dim(multires: int, input_dims: int = 3) -> int:
    """Output dim: input + sin/cos per frequency band."""
    return input_dims + 2 * multires * input_dims


def positional_encoding(x: torch.Tensor, multires: int) -> torch.Tensor:
    """Encode ``x[..., D] -> [..., D + 2*multires*D]``."""
    if multires <= 0:
        return x
    parts = [x]
    for i in range(multires):
        xf = x * (2.0 ** i)
        parts.append(torch.sin(xf))
        parts.append(torch.cos(xf))
    return torch.cat(parts, dim=-1)
