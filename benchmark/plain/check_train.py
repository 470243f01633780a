"""The plain reference of a training cell and the numbers it compares.

:func:`reference_train` rebuilds the scene from the benchmark's cloud (the
voxel downsample, the query table, the TV graph and the occupancy bitmap),
calibrates the ray and probe budgets, prepares the prior from its file,
and takes the benchmark's weights, batches and draws through the same
number of steps as the program's set-up did, in f32 with TF32 off (or
with the rounding of :mod:`benchmark.plain.precision`: in scaled fp8, the
control; in bf16, a witness at the configurations' precision).

:func:`compare` gives, each as a share of the reference's own scale:
  * ``loss_gap``: the worst step's |loss - loss_ref| / |loss_ref|;
  * ``rgb_loss_gap``: the same for the loss's colour term alone, which no
    discrete choice of the sampler or the local loss moves;
  * ``grad_gap``: the worst leaf's gap between the norms of the first
    gradient as the optimizers got it (after the global-norm clip), over
    the larger of that leaf's reference norm and the median leaf's;
  * ``step_gap``: the same for the norm of each leaf's change over the
    steps, leaving out the leaves whose reference gradient is under a
    thousandth of the median leaf's (their change is round-off under Adam);
  * ``step_gap_median``: the median over those leaves of the same gap;
  * ``grad_dir_gap_median`` and ``grad_dir_gap``: the median and the
    largest over the same leaves (those of more than one element) of 1 -
    the cosine between the program's first gradient and the reference's
    (a direction, so the global-norm clip does not move it);
  * ``color_latent_dir_gap``: the same for the colour latents alone, the
    leaf that every ray's colour term reaches and that no discrete choice
    of the local loss touches (a batch's rays pick the rows it moves);
  * ``budget_width_gap``: rays between the program's ray-budget width and
    the reference's (exact: limit 0).
"""

import numpy as np
import torch

from benchmark.plain import precision
from benchmark.plain.config import config_from_dict
from benchmark.plain.model.neural_points import build_scene
from benchmark.plain.model.renderer import ray_budget
from benchmark.plain.train.optim import Optimizer, flatten
from benchmark.plain.train.trainer import (
    calibrate_budgets,
    make_train_step,
    prepare_prior,
)


def load_prior(path, device):
    with np.load(path) as z:
        arrs = {k: z[k] for k in z.files}
    tree = {}
    for name in ("F_geometry", "T"):
        n = len({k.split(".")[1] for k in arrs if k.startswith(name + ".")})
        tree[name] = [{"w": torch.as_tensor(arrs[f"{name}.{i}.w"],
                                            dtype=torch.float32,
                                            device=device),
                       "b": torch.as_tensor(arrs[f"{name}.{i}.b"],
                                            dtype=torch.float32,
                                            device=device)}
                      for i in range(n)]
    return tree


def tree_from_paths(flat: dict, device):
    """``{"F_color.0.w": t, ...}`` -> the nested tree (lists for integer
    keys), leaves on ``device`` with gradients on."""
    root = {}
    for path, t in flat.items():
        node = root
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t.to(device).clone().requires_grad_(True)

    def fix(node):
        if isinstance(node, dict) and node and all(k.isdigit() for k in node):
            return [fix(node[str(i)]) for i in range(len(node))]
        if isinstance(node, dict):
            return {k: fix(v) for k, v in node.items()}
        return node
    return fix(root)


def paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in tree for p in paths(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in paths(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def local_context(local: dict, device) -> dict:
    """The local loss's context: the extractor's half-resolution head on
    the benchmark's feature images, the cameras and the source map."""
    from benchmark.plain.featext_weights import featext_params
    from benchmark.plain.model.featext import featext_apply

    params = featext_params(local["state"], device)
    with torch.no_grad():
        _, _, f3 = featext_apply(params, torch.from_numpy(
            local["images"]).to(device))
    return {"feats": f3.permute(0, 2, 3, 1).contiguous(),
            "cams": torch.from_numpy(local["cams_hd"]).to(device),
            "src": torch.tensor(local["src"], dtype=torch.int64,
                                device=device),
            "size": torch.tensor(float(local["size"]), device=device),
            "center": torch.from_numpy(local["center"]).to(device)}


def reference_train(inputs: dict, device, program_width: int,
                    mode: str = "f32") -> dict:
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    precision.set_mode(mode)
    try:
        return _reference_train(inputs, device, program_width)
    finally:
        precision.set_mode("f32")
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _reference_train(inputs, device, program_width):
    import dataclasses

    cfg = config_from_dict(inputs["config"])
    scene, _ = build_scene(inputs["points"], cfg.model, inputs["colors"],
                           device=device)
    views = inputs["views"]
    if cfg.model.ray_budget_frac < 0 or cfg.model.probe_budget_frac < 0:
        ray_frac, probe_frac = calibrate_budgets(scene, views, cfg)
        upd = {}
        if cfg.model.ray_budget_frac < 0:
            upd["ray_budget_frac"] = ray_frac
        if cfg.model.probe_budget_frac < 0:
            upd["probe_budget_frac"] = probe_frac
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                                 **upd))
    n_pix = cfg.train.num_pixels
    width = ray_budget(n_pix, cfg.model) or n_pix
    out = {"width": width,
           "points": scene.points.cpu().numpy()}
    if width != program_width:
        return out
    prior = prepare_prior(load_prior(inputs["prior"], device))
    params = tree_from_paths(inputs["weights"], device)
    names = paths(params)
    opt = Optimizer(cfg.train)
    state = {"params": params, "opt_state": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    vd = {k: torch.as_tensor(np.asarray(v), device=device)
          for k, v in views.items()}
    bundle = {"scene": scene, "prior": prior}
    use_local = inputs.get("local") is not None and cfg.loss.local_weight > 0
    if use_local:
        bundle["local"] = local_context(inputs["local"], device)
    _, train_step = make_train_step(cfg, opt, use_local=use_local)
    before = {n: t.detach().clone() for n, t in zip(names, flatten(params))}
    losses, rgb = [], []
    for i, st in enumerate(inputs["steps"]):
        v = st["view"]
        pix = torch.as_tensor(st["pix"], device=device)
        vi = torch.tensor([v], device=device)
        batch = {"inputs": {"uv": vd["uv"][pix][None],
                            "pose": vd["pose"][vi],
                            "intrinsics": vd["intrinsics"][vi]},
                 "gt": {"rgb": vd["rgb"][vi, pix],
                        "mask": vd["mask"][vi, pix]},
                 "view": vi}
        draws = {k: t.to(device) for k, t in st["draws"].items()}
        parts, grads = train_step(bundle, state, batch, draws)
        losses.append(float(parts["loss"]))
        rgb.append(float(parts["rgb_loss"]))
        if i == 0:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = min(1.0, cfg.train.grad_clip / max(float(norm), 1e-12))
            out["grad"] = {n: float(torch.linalg.norm(g)) * scale
                           for n, g in zip(names, grads)}
            out["first_grad"] = {n: g.detach().cpu()
                                 for n, g in zip(names, grads)}
    out["loss"] = losses
    out["rgb_loss"] = rgb
    out["delta"] = {n: float(torch.linalg.norm(t.detach() - before[n]))
                    for n, t in zip(names, flatten(params))}
    return out


def leaf_gaps(program: dict, ref: dict) -> dict:
    """Each leaf's gaps of ``compare``'s ``grad_gap``, ``step_gap`` and
    ``grad_dir_gap``: ``{leaf: [grad, step, direction]}`` (for reading
    which leaf sets them)."""
    out = {}
    for key in ("grad", "delta"):
        r = ref[key]
        scale = float(np.median(list(r.values())))
        for k in r:
            out.setdefault(k, []).append(
                abs(program[key][k] - r[k]) / max(r[k], scale, 1e-30))
    for k in out:
        out[k].append(_dir_gap(program["first_grad"][k],
                               ref["first_grad"][k]))
    return out


def _leaf_gaps(prog: dict, ref: dict, keep) -> list:
    scale = float(np.median([ref[k] for k in keep]))
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], scale, 1e-30) for k in keep]
    return gaps if all(np.isfinite(gaps)) else [float("inf")]


def _dir_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    cos = float(a @ b) / max(float(a.norm() * b.norm()), 1e-300)
    return 1.0 - cos if np.isfinite(cos) else float("inf")


def _rel(prog, ref) -> float:
    gaps = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref)]
    return max(gaps) if all(np.isfinite(prog)) else float("inf")


def compare(program: dict, ref: dict):
    """``[(name, value)]``; a reference that could not follow the program
    (another budget width, another point set) gives inf gaps."""
    width_gap = float(abs(program["width"] - ref["width"]))
    same_points = (program["points"].shape == ref["points"].shape
                   and np.array_equal(program["points"], ref["points"]))
    if "loss" not in ref or not same_points:
        inf = float("inf")
        return [("loss_gap", inf), ("rgb_loss_gap", inf), ("grad_gap", inf),
                ("step_gap", inf), ("step_gap_median", inf),
                ("grad_dir_gap_median", inf), ("grad_dir_gap", inf),
                ("color_latent_dir_gap", inf), ("budget_width_gap", width_gap)]
    g = ref["grad"]
    med = float(np.median(list(g.values())))
    moving = [k for k in g if g[k] >= 1e-3 * med]
    steps = _leaf_gaps(program["delta"], ref["delta"], moving)
    dirs = [_dir_gap(program["first_grad"][k], ref["first_grad"][k])
            for k in moving if ref["first_grad"][k].numel() > 1]
    return [("loss_gap", _rel(program["loss"], ref["loss"])),
            ("rgb_loss_gap", _rel(program["rgb_loss"], ref["rgb_loss"])),
            ("grad_gap", max(_leaf_gaps(program["grad"], g, list(g)))),
            ("step_gap", max(steps)),
            ("step_gap_median", float(np.median(steps))),
            ("grad_dir_gap_median", float(np.median(dirs))),
            ("grad_dir_gap", max(dirs)),
            ("color_latent_dir_gap", _dir_gap(
                program["first_grad"]["feats_color"],
                ref["first_grad"]["feats_color"])),
            ("budget_width_gap", width_gap)]
