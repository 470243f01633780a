"""The Vis-MVSNet extractor's parameter tree from a reference checkpoint's
state dict (the port's ``convert/torch_ckpt.convert_vismvsnet``): each
BatchNorm folded into its eval-mode affine map."""

import numpy as np
import torch

ENC_STAGES = (("2d2_0", 1), ("2d4_1", 2), ("2d8_2", 2))
DEC_STAGES = ("2d16_3", "2d8_4")


def _t(x, device):
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def _bn_fold(sd, prefix, device, eps=1e-5):
    gamma, beta = sd[f"{prefix}.weight"], sd[f"{prefix}.bias"]
    mean, var = sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"]
    scale = gamma.double() / torch.sqrt(var.double() + eps)
    return {"scale": _t(scale.float(), device),
            "shift": _t((beta.double() - mean.double() * scale).float(),
                        device)}


def _block(sd, prefix, stride, device):
    p = {"conv1": {"w": _t(sd[f"{prefix}.conv1.weight"], device)},
         "bn1": _bn_fold(sd, f"{prefix}.bn1", device),
         "conv2": {"w": _t(sd[f"{prefix}.conv2.weight"], device)},
         "bn2": _bn_fold(sd, f"{prefix}.bn2", device),
         "stride": stride}
    if f"{prefix}.downsample.0.weight" in sd:
        p["downsample"] = {"w": _t(sd[f"{prefix}.downsample.0.weight"],
                                   device)}
        p["downsample_bn"] = _bn_fold(sd, f"{prefix}.downsample.1", device)
    return p


def featext_params(state: dict, device) -> dict:
    sd = {k[len("module.feat_ext."):]: v
          for k, v in state["state_dict"].items()
          if k.startswith("module.feat_ext.")}
    return {
        "init_conv": {"w": _t(sd["init_conv.0.weight"], device)},
        "init_bn": _bn_fold(sd, "init_conv.1", device),
        "enc": [[_block(sd, f"unet.enc_blocks.{n}.0", s, device),
                 _block(sd, f"unet.enc_blocks.{n}.1", 1, device)]
                for n, s in ENC_STAGES],
        "dec": [{"deconv": {"w": _t(sd[f"unet.dec_blocks.{n}.0.weight"],
                                    device)},
                 "post": {"w": _t(sd[f"unet.dec_blocks.{n}.1.weight"],
                                  device)},
                 "res": [_block(sd, f"unet.dec_blocks.{n}.2.0", 1, device)]}
                for n in DEC_STAGES],
        "head1": {"w": _t(sd["final_conv_1.weight"], device)},
        "head2": {"w": _t(sd["final_conv_2.weight"], device)},
        "head3": {"w": _t(sd["final_conv_3.weight"], device)}}
