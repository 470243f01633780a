"""The reference's two frozen networks, from their torch checkpoints
(port of ``spurfies_tpu/convert/torch2jax.py``).

  * ``ckpt/local_prior.pt`` (the ShapeNet prior): keys
    ``*.local_sdf_field.<i>.{weight,bias}`` map onto the 5 F_geometry
    Linears and ``density_branch.{weight,bias}`` onto T
    (spurfies/train.py:124-143).  Torch stores a Linear's weight
    ``[out, in]``; the port's layers are ``[in, out]`` (``x @ w``), so each
    weight is transposed once here.
  * ``ckpt/vismvsnet.pt`` (Vis-MVSNet): the ``module.feat_ext.*`` subtree
    (spurfies/feat_utils.py:362-369) becomes ``model.featext``'s tree.  Its
    conv kernels keep torch's layouts; each BatchNorm is folded into a
    scale and shift (eval mode only).
"""

import numpy as np
import torch

from spurfies_tpu_torch.convert.from_jax import params_from_numpy
from spurfies_tpu_torch.device import resolve_device


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


def _bn_fold(sd, prefix, eps=1e-5):
    """A BatchNorm's eval-mode affine map as ``{"scale", "shift"}``
    (``torch2jax._bn_fold``)."""
    gamma = _np(sd[f"{prefix}.weight"])
    beta = _np(sd[f"{prefix}.bias"])
    mean = _np(sd[f"{prefix}.running_mean"])
    var = _np(sd[f"{prefix}.running_var"])
    scale = gamma / np.sqrt(var + eps)
    return {"scale": scale, "shift": beta - mean * scale}


def _basic_block(sd, prefix, stride):
    p = {"conv1": {"w": _np(sd[f"{prefix}.conv1.weight"])},
         "bn1": _bn_fold(sd, f"{prefix}.bn1"),
         "conv2": {"w": _np(sd[f"{prefix}.conv2.weight"])},
         "bn2": _bn_fold(sd, f"{prefix}.bn2"),
         "stride": stride}
    if f"{prefix}.downsample.0.weight" in sd:
        p["downsample"] = {"w": _np(sd[f"{prefix}.downsample.0.weight"])}
        p["downsample_bn"] = _bn_fold(sd, f"{prefix}.downsample.1")
    return p


# UNet(16, enc=2, dec=1, filters=[32, 64, 128], prefix="2d"): the encoder's
# ListModule names and strides, the decoder's names
ENC_STAGES = (("2d2_0", 1), ("2d4_1", 2), ("2d8_2", 2))
DEC_STAGES = ("2d16_3", "2d8_4")


def convert_vismvsnet(path_or_state, device="cuda"):
    """-> the :class:`model.featext.FeatExt` of the reference checkpoint,
    its buffers on ``device``.

    Accepts a file path or a loaded state dict: the full checkpoint
    (``{"state_dict": {"module.feat_ext....": ...}}``) or the stripped
    feat_ext subtree.
    """
    from spurfies_tpu_torch.model.featext import FeatExt

    if isinstance(path_or_state, (str, bytes)):
        state = torch.load(path_or_state, map_location="cpu",
                           weights_only=False)
    else:
        state = path_or_state
    if "state_dict" in state:
        state = {k[len("module.feat_ext."):]: v
                 for k, v in state["state_dict"].items()
                 if k.startswith("module.feat_ext.")}
    enc = [[_basic_block(state, f"unet.enc_blocks.{name}.0", stride),
            _basic_block(state, f"unet.enc_blocks.{name}.1", 1)]
           for name, stride in ENC_STAGES]
    dec = [{"deconv": {"w": _np(state[f"unet.dec_blocks.{name}.0.weight"])},
            "post": {"w": _np(state[f"unet.dec_blocks.{name}.1.weight"])},
            "res": [_basic_block(state, f"unet.dec_blocks.{name}.2.0", 1)]}
           for name in DEC_STAGES]
    tree = {"init_conv": {"w": _np(state["init_conv.0.weight"])},
            "init_bn": _bn_fold(state, "init_conv.1"),
            "enc": enc, "dec": dec,
            "head1": {"w": _np(state["final_conv_1.weight"])},
            "head2": {"w": _np(state["final_conv_2.weight"])},
            "head3": {"w": _np(state["final_conv_3.weight"])}}
    return FeatExt(params_from_numpy(tree, "cpu")).to(
        resolve_device(device))
