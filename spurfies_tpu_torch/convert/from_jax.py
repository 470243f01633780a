"""Weights and scenes carried across from the JAX package, as numpy.

The JAX package's parameter tree
``{"frozen": {"F_geometry", "T"}, "train": {"F_color", "R", "beta",
"feats_color", "feats_geometry"}}`` -- lists of ``{"w", "b"}`` Linears --
becomes the same tree of tensors.  Both packages store a Linear's weight as
``[in, out]`` (``x @ w``), so no array is transposed here; the pair-MLP
kernels make their own transposed copies (``ops.pair_mlp``).

The Vis-MVSNet extractor's tree (``spurfies_tpu/model/featext.py``) is the
exception: JAX keeps its conv kernels HWIO, the port PyTorch's OIHW, and
the transposed convolutions as the flipped dilated-conv kernel
(``torch2jax._deconv_w``), the port as ``F.conv_transpose2d``'s IOHW
(:func:`featext_from_jax`).
"""

from pathlib import Path

import numpy as np
import torch

from spurfies_tpu_torch.device import resolve_device
from spurfies_tpu_torch.model.neural_points import SceneState
from spurfies_tpu_torch.ops.voxel_grid import QueryTable, VoxelGridSpec


# the repo's pretrained prior (artifacts/local_prior), exported once to npz
PRIOR_ASSET = Path(__file__).resolve().parent.parent / "assets" / \
    "local_prior.npz"


def _to(a, dev, dtype=None):
    t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(dev)


def params_from_numpy(tree, device="cuda"):
    """Numpy tree (nested dicts / lists of arrays) -> the same tree of
    tensors on ``device``; float arrays become f32."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        a = np.asarray(x)
        return _to(a, dev, torch.float32 if a.dtype.kind == "f" else None)

    return conv(tree)


def params_to_numpy(tree):
    """Inverse of :func:`params_from_numpy`."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


def scene_from_numpy(d, device="cuda") -> SceneState:
    """SceneState from numpy arrays: ``points [N, 3]``, ``table_idx
    [C, qcap]``, ``table_pos [C, 3, qcap]``, ``table_r``, ``n_points``,
    ``tv_idx``, ``tv_valid``, ``occ_fine [rows, 128]`` and ``spec`` (a dict
    of VoxelGridSpec fields) -- what the JAX package's SceneState holds."""
    dev = resolve_device(device)
    table = QueryTable(idx=_to(d["table_idx"], dev, torch.int32).contiguous(),
                       pos=_to(d["table_pos"], dev,
                               torch.float32).contiguous(),
                       r=float(d["table_r"]), n_points=int(d["n_points"]))
    spec = VoxelGridSpec(**{k: (tuple(v) if isinstance(v, (list, tuple))
                                else v) for k, v in d["spec"].items()})
    return SceneState(
        points=_to(d["points"], dev, torch.float32),
        table=table,
        tv_idx=_to(d["tv_idx"], dev, torch.int32),
        tv_valid=_to(d["tv_valid"], dev, torch.bool),
        occ_fine=(None if d.get("occ_fine") is None
                  else _to(d["occ_fine"], dev, torch.int8)),
        spec=spec)


def load_prior_npz(path=PRIOR_ASSET, device="cuda"):
    """The frozen prior ``{"F_geometry": [5], "T": [1]}`` from an npz with
    keys ``F_geometry.<i>.w``, ``F_geometry.<i>.b``, ``T.0.w``, ``T.0.b``
    (``spurfies_tpu_torch/assets/local_prior.npz``)."""
    with np.load(path) as z:
        arrs = {k: z[k] for k in z.files}
    tree = {}
    for name in ("F_geometry", "T"):
        n = len({k.split(".")[1] for k in arrs if k.startswith(name + ".")})
        tree[name] = [{"w": arrs[f"{name}.{i}.w"], "b": arrs[f"{name}.{i}.b"]}
                      for i in range(n)]
    return params_from_numpy(tree, device)


def featext_from_jax(tree):
    """The JAX package's featext parameter tree (numpy or jax arrays) as
    the port's numpy tree (``model.featext``): conv kernels HWIO -> OIHW,
    the transposed convolutions' flipped HWIO kernels -> IOHW unflipped,
    the folded BN scale/shift and the strides as they are."""
    def conv(p):
        return {"w": np.ascontiguousarray(
            np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1))}

    def deconv(p):
        w = np.asarray(p["w"], np.float32).transpose(2, 3, 0, 1)
        return {"w": np.ascontiguousarray(w[:, :, ::-1, ::-1])}

    def bn(p):
        return {k: np.asarray(p[k], np.float32) for k in ("scale", "shift")}

    def block(p):
        out = {"conv1": conv(p["conv1"]), "bn1": bn(p["bn1"]),
               "conv2": conv(p["conv2"]), "bn2": bn(p["bn2"]),
               "stride": int(p["stride"])}
        if "downsample" in p:
            out["downsample"] = conv(p["downsample"])
            out["downsample_bn"] = bn(p["downsample_bn"])
        return out

    return {"init_conv": conv(tree["init_conv"]),
            "init_bn": bn(tree["init_bn"]),
            "enc": [[block(b) for b in stage] for stage in tree["enc"]],
            "dec": [{"deconv": deconv(d["deconv"]), "post": conv(d["post"]),
                     "res": [block(b) for b in d["res"]]}
                    for d in tree["dec"]],
            **{f"head{i}": conv(tree[f"head{i}"]) for i in (1, 2, 3)}}


def dust3r_from_jax(tree):
    """The JAX package's DUSt3R parameter tree (numpy or jax arrays) as the
    port's numpy tree (``prep.dust3r_net.Dust3rNet``): each Linear's
    ``[in, out]`` weight -> ``[out, in]``, the patch kernel HWIO -> OIHW,
    biases and LayerNorms as they are."""
    def arr(a):
        return np.asarray(a, np.float32)

    def conv(tree):
        if isinstance(tree, list):
            return [conv(v) for v in tree]
        if "w" in tree and not isinstance(tree["w"], dict):
            return {"w": np.ascontiguousarray(arr(tree["w"]).T),
                    "b": arr(tree["b"])}
        if "g" in tree:
            return {"g": arr(tree["g"]), "b": arr(tree["b"])}
        return {k: conv(v) for k, v in tree.items()}

    out = {k: conv(v) for k, v in tree.items() if k != "patch_embed"}
    out["patch_embed"] = {
        "w": np.ascontiguousarray(
            arr(tree["patch_embed"]["w"]).transpose(3, 2, 0, 1)),
        "b": arr(tree["patch_embed"]["b"])}
    return out
