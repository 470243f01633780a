"""Two-group Adam + cosine schedule + non-finite guard + global-norm clip
(port of ``spurfies_tpu/train/optim.py``; reference
``spurfies/train.py:175-189,548-564,360-361``).

The semantics are optax's, written as plain tensor code:
  * ``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8) per group, the latent
    group (``feats_*``) and the rest, each with its own cosine schedule
    (torch's CosineAnnealingLR) and its own step count;
  * in front, ``finite_guarded_clip``: one global L2 norm serves both the
    clip at ``grad_clip`` and the guard.  A non-finite norm means a
    non-finite gradient: the update is then zero, the moments and counts
    stay as they were and ``notfinite_count`` (consecutive skips) goes up
    by one; a finite step resets it.

The guard decides on the card (``torch.where``), so a step never waits for
it.  ``torch.optim.Adam`` with an ``LRScheduler`` cannot hold its step
count back on a skipped step, hence this module.  Parameters are updated
in place.
"""

import math
from dataclasses import dataclass

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8
LATENT_KEYS = ("feats_color", "feats_geometry", "feats")


def cosine_lr(base_lr: float, t_max: int, eta_min: float):
    """torch CosineAnnealingLR: ``eta_min + (lr - eta_min) (1 + cos(pi t /
    T)) / 2`` at ``t = min(step, T)``; ``step`` an int tensor."""
    def schedule(step):
        t = torch.clamp(step, max=t_max).to(torch.float32)
        return eta_min + (base_lr - eta_min) * 0.5 * (
            1.0 + torch.cos(math.pi * t / t_max))
    return schedule


def flatten(tree):
    """Leaves of a parameter tree (dicts in key order, lists in order)."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in flatten(v)]
    return [tree]


@dataclass
class OptState:
    """Adam moments per leaf (in :func:`flatten` order), one step count per
    group and the consecutive-skip counter, all on the parameters' device."""
    mu: list
    nu: list
    count: dict
    notfinite_count: torch.Tensor

    def state_dict(self):
        return {"mu": self.mu, "nu": self.nu, "count": self.count,
                "notfinite_count": self.notfinite_count}

    @classmethod
    def from_state_dict(cls, d):
        return cls(list(d["mu"]), list(d["nu"]), dict(d["count"]),
                   d["notfinite_count"])


class Optimizer:
    """The two-group guarded Adam of ``build_optimizer`` (``optim.py:83``).

    ``init(params)`` makes the state; ``step(params, grads, state)``
    applies one update in place, to the parameters and the state."""

    def __init__(self, train_cfg):
        base = cosine_lr(train_cfg.learning_rate, train_cfg.cosine_t_max,
                         train_cfg.cosine_eta_min)
        scale = train_cfg.latent_learning_rate / train_cfg.learning_rate
        latent = cosine_lr(train_cfg.latent_learning_rate,
                           train_cfg.cosine_t_max,
                           train_cfg.cosine_eta_min * scale)
        self.schedules = {"base": base, "latent": latent}
        self.clip = train_cfg.grad_clip

    def labels(self, params):
        """The group of each leaf, in :func:`flatten` order."""
        return [("latent" if k in LATENT_KEYS else "base")
                for k in params for _ in flatten(params[k])]

    def init(self, params) -> OptState:
        leaves = flatten(params)
        dev = leaves[0].device
        return OptState(
            mu=[torch.zeros_like(p) for p in leaves],
            nu=[torch.zeros_like(p) for p in leaves],
            count={g: torch.zeros((), dtype=torch.int32, device=dev)
                   for g in self.schedules},
            notfinite_count=torch.zeros((), dtype=torch.int32, device=dev))

    @torch.no_grad()
    def step(self, params, grads, state: OptState):
        """One update of the leaves of ``params`` by ``grads`` (a list in
        :func:`flatten` order)."""
        leaves = flatten(params)
        labels = self.labels(params)
        sq = torch.stack([torch.sum(g * g) for g in grads]).sum()
        norm = torch.sqrt(sq)
        finite = torch.isfinite(norm)
        scale = torch.where(
            finite, torch.clamp(self.clip / torch.clamp(norm, min=1e-12),
                                max=1.0), 0.0)
        step_size, bc1, bc2, count_inc = {}, {}, {}, {}
        for group, schedule in self.schedules.items():
            c = state.count[group]
            count_inc[group] = c + 1
            cf = count_inc[group].to(torch.float32)
            bc1[group] = 1.0 - torch.pow(B1, cf)
            bc2[group] = 1.0 - torch.pow(B2, cf)
            step_size[group] = -schedule(c)
        for i, (p, g, group) in enumerate(zip(leaves, grads, labels)):
            g = g * scale
            mu = (1.0 - B1) * g + B1 * state.mu[i]
            nu = (1.0 - B2) * (g * g) + B2 * state.nu[i]
            upd = (mu / bc1[group]) / (torch.sqrt(nu / bc2[group]) + EPS)
            upd = step_size[group] * upd
            p.add_(torch.where(finite, upd, 0.0))
            state.mu[i] = torch.where(finite, mu, state.mu[i])
            state.nu[i] = torch.where(finite, nu, state.nu[i])
        for group in self.schedules:
            state.count[group] = torch.where(finite, count_inc[group],
                                             state.count[group])
        state.notfinite_count = torch.where(
            finite, 0, state.notfinite_count + 1).to(torch.int32)
        return state
