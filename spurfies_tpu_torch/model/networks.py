"""MLP parameters for the neural-point field (port of
``spurfies_tpu/model/networks.py``).

Architecture (reference ``spurfies/model/pointneus_disent.py:70-110``):
  * F_geometry: 5x Linear(35->256->..->256), LeakyReLU(0.01) after the first
    4, none after the last.  FROZEN (pretrained local prior).
  * T: Linear(256->1).  FROZEN.
  * F_color: 4x Linear(103->256->..->256), LeakyReLU after the first 3.
  * R: Linear(277->256)->LReLU->Linear(256->256)->LReLU->Linear(256->3)
    -> sigmoid.

Parameters are plain dictionaries of tensors with the JAX package's
``[in, out]`` weight layout, so both packages hold the same arrays.  Init
follows ``torch.nn.Linear``'s defaults: U(-1/sqrt(fan_in), 1/sqrt(fan_in))
for W and b, drawn from an explicit ``torch.Generator``.
"""

import math

import torch

from spurfies_tpu_torch.config import ModelConfig
from spurfies_tpu_torch.core.embedder import encoding_dim
from spurfies_tpu_torch.device import constant, resolve_device

LEAKY_SLOPE = 0.01  # torch nn.LeakyReLU default


def linear_init(fan_in: int, fan_out: int, generator: torch.Generator,
                device="cuda"):
    """``{"w": [fan_in, fan_out], "b": [fan_out]}`` drawn on the CPU from
    ``generator`` (a CPU generator), then moved to ``device``."""
    dev = resolve_device(device)
    bound = 1.0 / math.sqrt(fan_in)
    w = torch.empty(fan_in, fan_out).uniform_(-bound, bound,
                                              generator=generator)
    b = torch.empty(fan_out).uniform_(-bound, bound, generator=generator)
    return {"w": w.to(dev), "b": b.to(dev)}


def mlp_init(dims, generator: torch.Generator, device="cuda"):
    dev = resolve_device(device)
    return [linear_init(dims[i], dims[i + 1], generator, dev)
            for i in range(len(dims) - 1)]


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.leaky_relu(x, 0.01)``: the slope is a scalar of x's dtype
    (in bf16, 0.010009765625), as in JAX; ``F.leaky_relu`` would multiply
    by the f32 0.01 before rounding."""
    slope = constant(LEAKY_SLOPE, x.dtype, x.device)
    return torch.where(x >= 0, x, slope * x)


def matmul_in(x: torch.Tensor, w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``x @ w`` with operands rounded to ``compute_dtype`` and the sum
    accumulated in f32 (the JAX ``preferred_element_type=f32`` product).

    bf16 x bf16 products are exact in f32, so an f32 matmul of the rounded
    operands is that product on the CPU and on the card alike (with TF32
    off, PyTorch's default for matmuls)."""
    if compute_dtype is None or compute_dtype == torch.float32:
        return x.float() @ w.float()
    return x.to(compute_dtype).float() @ w.to(compute_dtype).float()


def mlp_apply(layers, x: torch.Tensor, final_act=None,
              hidden_act="leaky_relu", compute_dtype=None) -> torch.Tensor:
    """Apply an MLP; activation after every layer except the last.

    compute_dtype: as in the JAX package, the product's OUTPUT is rounded to
    this dtype, and the bias add and activations run in it; params stay
    f32, and the result is cast back to ``x.dtype``.
    """
    in_dtype = x.dtype
    for i, layer in enumerate(layers):
        w, b = layer["w"], layer["b"]
        if compute_dtype is not None and compute_dtype != torch.float32:
            x = matmul_in(x, w, compute_dtype).to(compute_dtype)
            x = x + b.to(compute_dtype)
        else:
            x = x.float() @ w + b
        if i < len(layers) - 1:
            if hidden_act == "leaky_relu":
                x = leaky_relu(x)
            elif hidden_act == "relu":
                x = torch.relu(x)
    if final_act == "sigmoid":
        x = torch.sigmoid(x)
    elif final_act == "leaky_relu":
        x = leaky_relu(x)
    return x.to(in_dtype)


def init_model_params(cfg: ModelConfig, generator: torch.Generator,
                      device="cuda"):
    """``{"frozen": {F_geometry, T}, "train": {F_color, R, beta}}`` with the
    dims of ``spurfies_tpu/model/networks.py:101-114``; per-scene latents
    are added by ``neural_points.build_scene``.

    Entangled (the legacy ablation, reference pointneus.py:51-69;
    ``networks.py:90-99``): one trunk F([posenc4(x_pi), latent64]) feeding
    T (the SDF) and R (the colour), all trainable, so frozen is empty."""
    device = resolve_device(device)
    fdim = cfg.feature_vector_size
    if cfg.entangled:
        return {"frozen": {}, "train": {
            "F": mlp_init([fdim + encoding_dim(4, 3), 256, 256, 256, 256],
                          generator, device),
            "T": mlp_init([256, 1], generator, device),
            "R": mlp_init([256 + encoding_dim(6, 3), 256, 256, 3], generator,
                          device),
            "beta": torch.tensor(cfg.density.beta_init, dtype=torch.float32,
                                 device=device)}}
    geo_in = fdim // 2 + 3
    color_in = fdim + encoding_dim(cfg.pos_multires, 3)
    r_in = 256 + encoding_dim(cfg.view_multires, 3)
    frozen = {
        "F_geometry": mlp_init([geo_in, 256, 256, 256, 256, 256], generator,
                               device),
        "T": mlp_init([256, 1], generator, device),
    }
    train = {
        "F_color": mlp_init([color_in, 256, 256, 256, 256], generator, device),
        "R": mlp_init([r_in, 256, 256, 3], generator, device),
        "beta": torch.tensor(cfg.density.beta_init, dtype=torch.float32,
                             device=device),
    }
    return {"frozen": frozen, "train": train}
