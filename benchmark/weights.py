"""The trainable weights of a cell, made on the device from the seed and
handed alike to the program and to the reference.

The distributions are the reference's (``spurfies/model/pointneus_disent.py``
:116-205 and ``torch.nn.Linear``'s defaults): each Linear's weight and bias
U(-1/sqrt(fan_in), 1/sqrt(fan_in)); colour latents U(-1e-4, 1e-4) with the
first three set to the point's colour mapped to [-1, 1]; geometry latents
N(0, 0.01) clipped to norm 1; beta at ``density.beta_init``.  Two draws
make them all: one uniform, one normal.  ``color_gain`` scales the colour
MLPs' weight matrices (sqrt(6) gives He's variance, 2 / fan_in), so that
the colour of an untrained state is not flat.
"""

import math

import torch

from benchmark.flops import HID, encoding_dim


def layer_dims(model: dict) -> dict:
    fdim = model.get("feature_vector_size", 64)
    return {
        "F_color": [fdim + encoding_dim(model.get("pos_multires", 6)),
                    HID, HID, HID, HID],
        "R": [HID + encoding_dim(model.get("view_multires", 3)), HID, HID, 3],
    }


def make_weights(model: dict, colors, generator: torch.Generator, device,
                 color_gain: float = 1.0):
    """``{"F_color": [{"w", "b"}], "R": [...], "beta", "feats_color",
    "feats_geometry"}`` f32 on ``device``; ``colors [N, 3]`` (0..255) are
    the kept points' colours."""
    n = colors.shape[0]
    fdim = model.get("feature_vector_size", 64)
    dims = layer_dims(model)
    sizes = []
    for net in ("F_color", "R"):
        d = dims[net]
        sizes += [(d[i] * d[i + 1], d[i]) for i in range(len(d) - 1)]
        sizes += [(d[i + 1], d[i]) for i in range(len(d) - 1)]
    total = sum(s for s, _ in sizes) + n * fdim
    u = torch.rand(total, generator=generator, device=device) * 2.0 - 1.0
    g = torch.randn(n * (fdim // 2), generator=generator, device=device)

    at = 0

    def take(count):
        nonlocal at
        out = u[at:at + count]
        at += count
        return out

    tree = {}
    for net in ("F_color", "R"):
        d = dims[net]
        ws = [take(d[i] * d[i + 1]).view(d[i], d[i + 1])
              * (color_gain / math.sqrt(d[i])) for i in range(len(d) - 1)]
        bs = [take(d[i + 1]) / math.sqrt(d[i]) for i in range(len(d) - 1)]
        tree[net] = [{"w": w.clone(), "b": b.clone()}
                     for w, b in zip(ws, bs)]
    tree["beta"] = torch.tensor(
        model.get("density", {}).get("beta_init", 0.1), dtype=torch.float32,
        device=device)
    fc = take(n * fdim).view(n, fdim) * 1e-4
    if model.get("initialize_colors", True):
        fc[:, :3] = torch.as_tensor(colors[:, :3], dtype=torch.float32,
                                    device=device) * 2.0 / 255.0 - 1.0
    tree["feats_color"] = fc.clone()
    fg = 0.01 * g.view(n, fdim // 2)
    norms = torch.linalg.norm(fg, dim=-1, keepdim=True)
    tree["feats_geometry"] = fg * torch.clamp(norms, max=1.0) / (norms + 1e-7)
    return tree


def leaves(tree, prefix=""):
    """``[(path, tensor)]`` of a weight tree: dicts in key order, lists in
    order (the order in which the program's and the reference's
    optimizers keep their leaves)."""
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves(v,
                                                              f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]
