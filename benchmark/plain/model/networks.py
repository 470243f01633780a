"""MLPs of the neural-point field (reference
``spurfies/model/pointneus_disent.py:70-110``):
  * F_geometry: 5x Linear(35->256->..->256), LeakyReLU(0.01) after the first
    4, none after the last.  FROZEN (pretrained local prior).
  * T: Linear(256->1).  FROZEN.
  * F_color: 4x Linear(103->256->..->256), LeakyReLU after the first 3.
  * R: Linear(277->256)->LReLU->Linear(256->256)->LReLU->Linear(256->3)
    -> sigmoid.

Parameters are dictionaries of tensors with ``[in, out]`` weights.
"""

import numpy as np
import torch
from torch import nn

from benchmark.plain.device import constant
from benchmark.plain.precision import mm, q

LEAKY_SLOPE = 0.01  # torch nn.LeakyReLU default


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.leaky_relu(x, 0.01)``: the slope is a scalar of x's dtype
    (in bf16, 0.010009765625), as in JAX; ``F.leaky_relu`` would multiply
    by the f32 0.01 before rounding."""
    slope = constant(LEAKY_SLOPE, x.dtype, x.device)
    return torch.where(x >= 0, x, slope * x)


def mlp_apply(layers, x: torch.Tensor, final_act=None,
              hidden_act="leaky_relu") -> torch.Tensor:
    """Apply an MLP in f32; activation after every layer except the
    last."""
    x = x.float()
    for i, layer in enumerate(layers):
        x = q(mm(x, layer["w"]) + layer["b"])
        if i < len(layers) - 1:
            if hidden_act == "leaky_relu":
                x = leaky_relu(x)
            elif hidden_act == "relu":
                x = torch.relu(x)
    if final_act == "sigmoid":
        x = q(torch.sigmoid(x))     # the program's sigmoid runs in bf16
    elif final_act == "leaky_relu":
        x = leaky_relu(x)
    return x


class ParamTree(nn.Module):
    """A frozen network's parameter tree (nested dicts and lists of arrays
    or tensors) held as the module's buffers, so that ``.to(device)``
    moves it; :attr:`params` gives the tree back, its leaves the buffers.
    Leaves under a key of ``ints`` stay Python ints (e.g. a stride)."""

    def __init__(self, params, ints=()):
        super().__init__()

        def register(tree, prefix):
            if isinstance(tree, dict):
                return {k: (int(v) if k in ints else
                            register(v, f"{prefix}{k}_"))
                        for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return [register(v, f"{prefix}{i}_") for i, v in
                        enumerate(tree)]
            name = prefix[:-1]
            self.register_buffer(name, tree.detach().float()
                                 if torch.is_tensor(tree) else
                                 torch.from_numpy(np.array(tree, np.float32)))
            return name

        self._ints = tuple(ints)
        self._layout = register(params, "")

    @property
    def params(self):
        """The parameter tree, its tensors the module's buffers."""
        def build(tree):
            if isinstance(tree, dict):
                return {k: (v if k in self._ints else build(v))
                        for k, v in tree.items()}
            if isinstance(tree, list):
                return [build(v) for v in tree]
            return getattr(self, tree)
        return build(self._layout)
