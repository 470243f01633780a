"""The reference's frozen local-geometry prior, from its torch checkpoint
(port of ``spurfies_tpu/convert/torch2jax.py:31-69``).

``ckpt/local_prior.pt`` (the ShapeNet prior) keys
``*.local_sdf_field.<i>.{weight,bias}`` map onto the 5 F_geometry Linears
and ``density_branch.{weight,bias}`` onto T (spurfies/train.py:124-143).
Torch stores a Linear's weight ``[out, in]``; the port's layers are
``[in, out]`` (``x @ w``), so each weight is transposed once here.
"""

import numpy as np
import torch

from spurfies_tpu_torch.convert.from_jax import params_from_numpy


def _np(t):
    return np.asarray(t.detach().cpu().numpy(), dtype=np.float32)


def _linear(sd, prefix):
    return {"w": _np(sd[f"{prefix}.weight"]).T,
            "b": _np(sd[f"{prefix}.bias"])}


def convert_local_prior(path_or_state, device="cuda"):
    """-> the frozen tree ``{"F_geometry": [5 linears], "T": [1 linear]}``
    of tensors on ``device``, as ``Trainer.load_frozen`` takes it.

    Accepts a file path or an already-loaded state dict, raw
    (``{"model_state_dict": ...}``) or bare.
    """
    if isinstance(path_or_state, (str, bytes)):
        state = torch.load(path_or_state, map_location="cpu",
                           weights_only=False)
    else:
        state = path_or_state
    if "model_state_dict" in state:
        state = state["model_state_dict"]

    # the local_sdf_field Linears in index order; torch Sequential indices
    # 0, 2, 4, 6, 8 are the Linears (LeakyReLUs at odd indices)
    sdf_keys = sorted(
        {k.rsplit(".", 1)[0] for k in state
         if "local_sdf_field" in k and k.endswith(("weight", "bias"))},
        key=lambda s: int(s.rsplit(".", 1)[-1]))
    if len(sdf_keys) != 5:
        raise ValueError(f"expected 5 local_sdf_field linears, got {sdf_keys}")
    t_key = next(k.rsplit(".", 1)[0] for k in state if "density_branch" in k)
    tree = {"F_geometry": [_linear(state, k) for k in sdf_keys],
            "T": [_linear(state, t_key)]}
    return params_from_numpy(tree, device)
