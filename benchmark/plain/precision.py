"""The rounding of the reference's matrix-product operands.

The reference multiplies in f32 (TF32 off).  Two other modes round every
operand of those products, each MLP layer's output and the colour head's
sigmoid, the points where the program rounds to its bf16 compute dtype, and
accumulate in f32:

* ``"fp8"``, the benchmark's control, the step below the bf16 that the
  configurations state: fp8 e4m3 with one scale per tensor (its largest
  magnitude to 448, the format's largest), as an fp8 matmul does;
* ``"bf16"``, a witness at the configurations' own precision: bf16.

``set_mode`` switches it for the whole process.
"""

import torch

MODES = ("f32", "bf16", "fp8")
_MODE = {"on": "f32"}
E4M3_MAX = 448.0


def set_mode(mode: str = "f32"):
    if mode not in MODES:
        raise ValueError(f"precision mode {mode!r} is not one of {MODES}")
    _MODE["on"] = mode


def q(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, rounded as the mode says."""
    x = x.float()
    mode = _MODE["on"]
    if mode == "bf16":
        return x.to(torch.bfloat16).float()
    if mode == "fp8":
        scale = torch.clamp(x.detach().abs().amax(), min=1e-30) / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    return x


def mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` of f32 operands, each rounded by :func:`q`."""
    return q(a) @ q(w)
