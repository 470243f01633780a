"""Global point-cloud alignment, the DUSt3R global_aligner stage (port of
``spurfies_tpu/prep/alignment.py``).

Behavioral spec from reference ``dust3r_inference.py:306-320`` /
``dust3r_inference_own.py:229-235``: pairwise DUSt3R pointmaps are fused by
optimizing, for 300 Adam iterations at lr 0.01 with cosine decay, per-edge
similarity transforms and per-view world geometry so all pairwise
predictions agree (confidence-weighted).  Benchmark mode presets the camera
poses (scaled so the mean camera-center norm is 0.225, :311-316); own-data
mode leaves them free.

All edges are optimized at once as stacked tensors on the pointmaps'
device, rotations as quaternions.  The optimizer is optax's ``adam``
(b1 0.9, b2 0.999, eps 1e-8, eps_root 0) on its
``cosine_decay_schedule(lr, iters, alpha=1e-3)``, written out here; the
loop never reads the card: the losses stay on the device and the result
is read back once, at the end.
"""

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    iters: int = 300
    lr: float = 0.01
    min_conf: float = 3.0


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w, x, y, z) -> [..., 3, 3]."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def cosine_lr(lr: float, iters: int, count: int, alpha: float = 1e-3):
    """optax's ``cosine_decay_schedule(lr, iters, alpha)`` at ``count``."""
    c = min(count, iters)
    return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / iters))
                 + alpha)


def init_alignment(edges, pointmaps_i, pointmaps_j, conf_i, conf_j,
                   n_views: int):
    """The optimization's state: its inputs on their device, the
    parameters and their Adam moments.  ``edges`` is a host array;
    pointmaps and confidences are tensors (the state lives on their
    device) or arrays (on the CPU)."""
    # copies: the inputs may be inference tensors (``infer_pair``'s), which
    # autograd cannot save for the backward
    xi = torch.as_tensor(pointmaps_i, dtype=torch.float32).clone()
    dev = xi.device
    xj, wi, wj = (torch.as_tensor(a, dtype=torch.float32, device=dev).clone()
                  for a in (pointmaps_j, conf_i, conf_j))
    e_np = np.asarray(edges)
    E = len(e_np)

    # confidence weights: log(conf) clipped at 0 like DUSt3R
    wi = torch.clamp(torch.log(torch.clamp(wi, min=1e-6)), min=0.0)
    wj = torch.clamp(torch.log(torch.clamp(wj, min=1e-6)), min=0.0)

    params = {
        "edge_logscale": torch.zeros(E, device=dev),
        "edge_quat": torch.tensor([1.0, 0.0, 0.0, 0.0],
                                  device=dev).repeat(E, 1),
        "edge_trans": torch.zeros(E, 3, device=dev),
        # per-view world geometry initialized from the first incoming edge
        "world": _init_world(e_np, xi, xj, n_views),
    }
    for p in params.values():
        p.requires_grad_(True)
    return {"xi": xi, "xj": xj, "wi": wi, "wj": wj,
            "denom": torch.sum(wi) + torch.sum(wj) + 1e-9,
            "src": torch.from_numpy(e_np[:, 0].astype(np.int64)).to(dev),
            "dst": torch.from_numpy(e_np[:, 1].astype(np.int64)).to(dev),
            "params": params,
            "mu": [torch.zeros_like(p) for p in params.values()],
            "nu": [torch.zeros_like(p) for p in params.values()]}


def alignment_loss(st):
    """Confidence-weighted distance of every edge's transformed pointmaps
    to the world points of its two views."""
    p = st["params"]
    s = torch.exp(p["edge_logscale"])[:, None, None]
    R = quat_to_rot(p["edge_quat"])
    t = p["edge_trans"][:, None, :]

    def dist(x, tgt):  # eps-regularized: exact-zero residuals (the world
        # init copies an edge) would NaN the norm backward
        # R x as a broadcast product and a sum over j, not einsum's bmm:
        # R's gradient is then a reduction over P, where bmm's is a
        # [3, P] x [P, 3] product with no parallelism over P (about 11 ms
        # an iteration on an H100 at 3 x 196,608 points)
        a = s * torch.sum(R[:, None] * x[:, :, None, :], -1) + t
        return torch.sqrt(torch.sum((a - tgt) ** 2, -1) + 1e-12)

    li = torch.sum(st["wi"] * dist(st["xi"], p["world"][st["src"]]))
    lj = torch.sum(st["wj"] * dist(st["xj"], p["world"][st["dst"]]))
    return (li + lj) / st["denom"]


def run_alignment(st, cfg: AlignConfig = AlignConfig()) -> torch.Tensor:
    """``cfg.iters`` Adam steps on ``st`` (:func:`init_alignment`); returns
    the ``[iters]`` tensor of each step's loss, before its update, on the
    device.  Nothing in the loop reads the device."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    leaves = list(st["params"].values())
    losses = torch.empty(cfg.iters, device=leaves[0].device)
    for it in range(cfg.iters):
        with torch.enable_grad():
            loss = alignment_loss(st)
            grads = torch.autograd.grad(loss, leaves)
        losses[it] = loss.detach()
        lr = cosine_lr(cfg.lr, cfg.iters, it)
        c1 = 1 - b1 ** (it + 1)
        c2 = 1 - b2 ** (it + 1)
        with torch.no_grad():
            for p, g, m, v in zip(leaves, grads, st["mu"], st["nu"]):
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + eps))
    return losses


def align_pointmaps(edges, pointmaps_i, pointmaps_j, conf_i, conf_j,
                    n_views: int, cfg: AlignConfig = AlignConfig(),
                    preset_poses=None):
    """Fuse pairwise pointmaps into per-view world pointmaps.

    Args:
      edges: ``[E, 2]`` int (i, j) view-index pairs (host array).
      pointmaps_i/j: ``[E, P, 3]`` -- edge e's prediction of view i's and
        view j's geometry, both in view i's camera frame (DUSt3R
        convention); tensors (the optimization runs on their device) or
        arrays (on the CPU).
      conf_i/j: ``[E, P]`` confidences.
      n_views: number of views.
      preset_poses: optional ``[V, 4, 4]`` c2w fixing view poses (benchmark
        mode); otherwise poses are optimized.

    Returns:
      dict (numpy, read back once) with world ``points [V, P, 3]``,
      ``poses [V, 4, 4]``, per-edge ``edge_scales``, the final ``loss`` (the
      last step's, before its update, as the JAX package reports it) and
      ``losses``, every step's.
    """
    st = init_alignment(edges, pointmaps_i, pointmaps_j, conf_i, conf_j,
                        n_views)
    losses = run_alignment(st, cfg).cpu().numpy()
    # the loss reads no view pose: free poses keep their identity init
    # (JAX's zero gradient gives a zero Adam update)
    if preset_poses is not None:
        poses = np.asarray(preset_poses, np.float32)
    else:
        poses = np.tile(np.eye(4, dtype=np.float32), (n_views, 1, 1))
    p = st["params"]
    return {
        "points": p["world"].detach().cpu().numpy(),
        "edge_scales": torch.exp(p["edge_logscale"]).detach().cpu().numpy(),
        "loss": float(losses[-1]) if cfg.iters else float("inf"),
        "losses": losses,
        "poses": poses,
    }


def _init_world(e_np, xi, xj, n_views):
    """Per-view world points from the first edge touching each view
    (identity transform)."""
    world = torch.zeros((n_views, xi.shape[1], 3), device=xi.device)
    filled = np.zeros(n_views, dtype=bool)
    for e in range(len(e_np)):
        i, j = int(e_np[e, 0]), int(e_np[e, 1])
        if not filled[i]:
            world[i] = xi[e]
            filled[i] = True
        if not filled[j]:
            world[j] = xj[e]
            filled[j] = True
    return world


def scale_preset_poses(poses, target_norm: float = 0.225):
    """Scale camera centers so their mean norm is ``target_norm``
    (reference dust3r_inference.py:311-316)."""
    poses = np.asarray(poses).copy()
    centers = poses[:, :3, 3]
    mean = float(np.linalg.norm(centers, axis=-1).mean())
    poses[:, :3, 3] = centers * (target_norm / max(mean, 1e-9))
    return poses, target_norm / max(mean, 1e-9)
