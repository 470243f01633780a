"""Local-geometry-prior pretraining (port of
``spurfies_tpu/prior/pretrain.py``; reproduces the role of
``ckpt/local_prior.pt``).

Recipe (designed from the paper's description; the reference repo ships
only the result): jointly train the shared SDF decoder (F_geometry + T)
and per-shape, per-point 32-dim geometry latents so that the
RBF-interpolated neighbourhood SDF matches ground truth near each shape's
surface.  Losses: SDF L1 + eikonal + latent L2.  :func:`frozen_params`
yields the decoder as ``Trainer.load_frozen`` takes it.

The corpus (every shape's padded points, queries, ground truth and query
table, stacked) lives on the device; a step picks a shape and a query
batch, queries the shape's table with the port's ``query_grid`` (K1, the
packed variant: 4,096 points a shape) and runs the decoder as plain
PyTorch with autograd double backward: the spatial gradient is
``torch.autograd.grad(sdf.sum(), x, create_graph=True)``, so the eikonal
term trains the decoder.  The pair-MLP kernels give no weight gradients
(the decoder is frozen everywhere else), so they cannot serve here.  The
JAX package's CPU path does the same (``vmap(value_and_grad)`` over
``aggregate_sdf``); its TPU path runs ``sdf_and_grad`` through the Pallas
kernel K6a, whose VJP returns no decoder cotangents, so there the decoder
learns nothing (``tests/test_torch_prior.py``).  The decoder's products
are f32 ``torch.matmul`` (TF32 off, PyTorch's default).

The optimizer is optax's ``chain(clip_by_global_norm(1.0),
multi_transform({latents: adam(latent_lr), decoder: adam(lr)}))``, written
out: one global norm over both groups, a clip with no finite guard, Adam
(b1 0.9, b2 0.999, eps 1e-8) per group on every entry.
"""

import dataclasses

import numpy as np
import torch

from spurfies_tpu_torch.config import ModelConfig
from spurfies_tpu_torch.convert.from_jax import load_prior_npz
from spurfies_tpu_torch.device import resolve_device
from spurfies_tpu_torch.model.field import (
    SDF_FILLER,
    aggregate_sdf,
    rbf_weights,
)
from spurfies_tpu_torch.model.networks import init_model_params, mlp_apply
from spurfies_tpu_torch.ops.pair_mlp import _prep_layers
from spurfies_tpu_torch.ops.voxel_grid import (
    QueryTable,
    VoxelGridSpec,
    build_query_table,
    query_grid,
)
from spurfies_tpu_torch.prior.shapes import sample_shape
from spurfies_tpu_torch.train.optim import B1, B2, EPS, flatten

CLIP_NORM = 1.0


@dataclasses.dataclass(frozen=True)
class PriorConfig:
    n_shapes: int = 32
    n_surface_cap: int = 4096       # padded neural points per shape
    n_query: int = 8192             # query pool per shape
    batch_queries: int = 4096
    spacing: float = 0.02
    latent_dim: int = 32
    k: int = 8
    r: float = 2.0
    rbf: float = 45.0
    lr: float = 5e-4
    latent_lr: float = 1e-3
    eikonal_weight: float = 0.1
    latent_reg: float = 1e-4
    steps: int = 20000
    seed: int = 0
    # tighter bounds than scenes: shapes fit in +-0.8
    bounds: float = 0.8
    qcap: int = 64


def build_corpus(cfg: PriorConfig, shapes=None, device="cuda"):
    """Stack the shapes into fixed-shape tensors and query tables on
    ``device``: ``points [S, cap, 3]`` (padded far outside the grid, so the
    pads never enter a table), ``point_mask [S, cap]``, ``query [S, Q,
    3]``, ``query_sdf [S, Q]``, ``table_idx [S, cells, qcap]`` and
    ``table_pos [S, cells, 3, qcap]``.  Returns (corpus, spec).

    shapes: optional pre-built shape dicts (surface / query / query_sdf,
    the protocol of ``prior.shapes.sample_shape`` and
    ``prior.mesh_corpus.mesh_to_shape``); default the procedural
    primitives, drawn from ``np.random.default_rng(cfg.seed)``.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    spec = VoxelGridSpec(lo=(-cfg.bounds,) * 3, hi=(cfg.bounds,) * 3,
                         qcap=cfg.qcap)
    if shapes is not None and len(shapes) != cfg.n_shapes:
        raise ValueError(
            f"got {len(shapes)} shapes but cfg.n_shapes={cfg.n_shapes}")
    pts_all, mask_all, q_all, qs_all, t_idx, t_pos = [], [], [], [], [], []
    for i in range(cfg.n_shapes):
        sh = (shapes[i] if shapes is not None else
              sample_shape(rng, n_query=cfg.n_query, spacing=cfg.spacing))
        if len(sh["query"]) < cfg.n_query:
            raise ValueError(f"shape {i}: {len(sh['query'])} queries < "
                             f"cfg.n_query={cfg.n_query}")
        pts = sh["surface"][:cfg.n_surface_cap]
        n = len(pts)
        pts_p = np.concatenate(
            [pts, np.full((cfg.n_surface_cap - n, 3), 10.0, np.float32)])
        table = build_query_table(torch.as_tensor(pts_p, device=dev), spec,
                                  r=cfg.r)
        pts_all.append(pts_p)
        mask_all.append(np.arange(cfg.n_surface_cap) < n)
        q_all.append(sh["query"][:cfg.n_query])
        qs_all.append(sh["query_sdf"][:cfg.n_query])
        t_idx.append(table.idx)
        t_pos.append(table.pos)
    corpus = {
        "points": torch.as_tensor(np.stack(pts_all), device=dev),
        "point_mask": torch.as_tensor(np.stack(mask_all), device=dev),
        "query": torch.as_tensor(np.stack(q_all), device=dev),
        "query_sdf": torch.as_tensor(np.stack(qs_all), device=dev),
        "table_idx": torch.stack(t_idx).contiguous(),
        "table_pos": torch.stack(t_pos).contiguous(),
    }
    return corpus, spec


def init_prior_params(cfg: PriorConfig, generator: torch.Generator,
                      device="cuda"):
    """``{"decoder": {F_geometry, T}, "latents": [S, cap, latent_dim]}``
    (the decoder of ``model.networks.init_model_params``, latents
    0.01 N(0, 1)), drawn on the CPU from ``generator``; every leaf
    requires grad."""
    dev = resolve_device(device)
    mcfg = ModelConfig(feature_vector_size=cfg.latent_dim * 2)
    decoder = init_model_params(mcfg, generator, dev)["frozen"]
    latents = 0.01 * torch.randn(cfg.n_shapes, cfg.n_surface_cap,
                                 cfg.latent_dim, generator=generator)
    params = {"decoder": decoder, "latents": latents.to(dev)}
    for leaf in flatten(params):
        leaf.requires_grad_(True)
    return params


def shape_table(corpus, cfg: PriorConfig, s: int) -> QueryTable:
    """Shape ``s``'s query table, a view of the stacked tables (nothing is
    rebuilt per step)."""
    return QueryTable(idx=corpus["table_idx"][s], pos=corpus["table_pos"][s],
                      r=cfg.r, n_points=cfg.n_surface_cap)


def decoder_sdf_and_grad(decoder, latents, points, idx, valid, x,
                         rbf: float):
    """The RBF-weighted SDF of the trainable decoder at ``x`` ``[M, 3]`` and
    its spatial gradient, differentiable in the decoder and the latents
    (the JAX package's plain ``sdf_and_grad``: per pair T(F_geometry([lat,
    x - p])) in f32, the weights of the detached distances).  Returns
    (sdf ``[M]``, filler where no neighbour; grad ``[M, 3]``)."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        safe = torch.clamp(idx, min=0).long()
        x_pi = xg[:, None, :] - points[safe]
        w, norm = rbf_weights(x_pi, valid, rbf)
        # plain indexing: its sorted backward is deterministic, and the
        # host-bound step has the device time for it (PERF.md)
        h = mlp_apply(decoder["F_geometry"],
                      torch.cat([latents[safe], x_pi], -1))
        s = torch.where(valid, mlp_apply(decoder["T"], h)[..., 0], 0.0)
        has = norm[..., 0] > 0
        agg = torch.sum(w * s, -1) / torch.where(has, norm[..., 0], 1.0)
        sdf = torch.where(has, agg, SDF_FILLER)
        grad, = torch.autograd.grad(sdf.sum(), xg, create_graph=create)
    return sdf, grad


def prior_loss(params, corpus, spec, cfg: PriorConfig, s: int, qidx):
    """The loss of shape ``s`` at its queries ``qidx``
    (``pretrain.py:136-152``): SDF L1 + eikonal_weight x eikonal +
    latent_reg x latent L2, the first two over the queries with a
    neighbour.  Returns (loss, {"sdf_l1", "eikonal", "coverage"})."""
    x = corpus["query"][s][qidx]
    gt = corpus["query_sdf"][s][qidx]
    idx, _ = query_grid(x, shape_table(corpus, cfg, s), spec, k=cfg.k)
    valid = idx >= 0
    lat = params["latents"][s]
    sdf, grad = decoder_sdf_and_grad(params["decoder"], lat,
                                     corpus["points"][s], idx, valid, x,
                                     cfg.rbf)
    has = torch.any(valid, -1)
    n = torch.clamp(torch.sum(has), min=1)
    sdf_loss = torch.sum(torch.where(has, torch.abs(sdf - gt), 0.0)) / n
    # a neighbour-less row's gradient is exactly 0: a unit vector stands in
    # before the norm, so that its backward stays finite
    unit = torch.tensor([1.0, 0.0, 0.0], device=x.device)
    gnorm = torch.linalg.norm(torch.where(has[:, None], grad, unit), dim=-1)
    eik = torch.sum(torch.where(has, (gnorm - 1.0) ** 2, 0.0)) / n
    reg = torch.mean(torch.sum(lat ** 2, -1))
    loss = sdf_loss + cfg.eikonal_weight * eik + cfg.latent_reg * reg
    return loss, {"sdf_l1": sdf_loss, "eikonal": eik,
                  "coverage": torch.mean(has.to(torch.float32))}


@dataclasses.dataclass
class PriorOptState:
    """Adam moments per leaf (in ``flatten`` order of the params) and one
    step count per group."""
    mu: list
    nu: list
    count: dict


class PriorOptimizer:
    """optax's ``chain(clip_by_global_norm(1.0), multi_transform(
    {"latents": adam(latent_lr), "decoder": adam(lr)}))``."""

    def __init__(self, cfg: PriorConfig):
        self.lr = {"latents": cfg.latent_lr, "decoder": cfg.lr}

    @staticmethod
    def labels(params):
        return [k for k in params for _ in flatten(params[k])]

    def init(self, params) -> PriorOptState:
        leaves = flatten(params)
        return PriorOptState(
            mu=[torch.zeros_like(p) for p in leaves],
            nu=[torch.zeros_like(p) for p in leaves],
            count={g: torch.zeros((), dtype=torch.int32,
                                  device=leaves[0].device) for g in self.lr})

    @torch.no_grad()
    def step(self, params, grads, state: PriorOptState):
        """One update in place.  The clip: ``g / |g| * 1.0`` when the global
        norm is at least 1 (optax divides first), else ``g``; no guard."""
        norm = torch.sqrt(torch.stack([torch.sum(g * g) for g in grads]).sum())
        clip = norm < CLIP_NORM
        bc1, bc2 = {}, {}
        for g_, c in state.count.items():
            state.count[g_] = c + 1
            cf = state.count[g_].to(torch.float32)
            bc1[g_] = 1.0 - torch.pow(B1, cf)
            bc2[g_] = 1.0 - torch.pow(B2, cf)
        for i, (p, g, group) in enumerate(zip(flatten(params), grads,
                                              self.labels(params))):
            g = torch.where(clip, g, g / norm * CLIP_NORM)
            state.mu[i] = (1.0 - B1) * g + B1 * state.mu[i]
            state.nu[i] = (1.0 - B2) * (g * g) + B2 * state.nu[i]
            upd = (state.mu[i] / bc1[group]) / (
                torch.sqrt(state.nu[i] / bc2[group]) + EPS)
            p.add_(-self.lr[group] * upd)
        return state


def make_prior_train_step(cfg: PriorConfig, spec, optimizer: PriorOptimizer,
                          generator=None, device="cuda"):
    """``train_step(params, opt_state, corpus, s=None, qidx=None)``: one
    step in place; returns its metrics (0-d tensors on the device, with
    ``loss``).  The draws -- the shape ``s`` (a host int, drawn from the
    CPU ``generator``) and ``qidx [batch_queries]`` (distinct query ids,
    drawn on the device) -- are optional inputs, so a test can inject the
    JAX package's."""
    dev = resolve_device(device)
    host_gen = torch.Generator().manual_seed(cfg.seed)
    dev_gen = generator

    def train_step(params, opt_state, corpus, s=None, qidx=None):
        if s is None:
            s = int(torch.randint(0, cfg.n_shapes, (), generator=host_gen))
        if qidx is None:
            qidx = torch.randperm(cfg.n_query, generator=dev_gen,
                                  device=dev)[:cfg.batch_queries]
        leaves = flatten(params)
        loss, aux = prior_loss(params, corpus, spec, cfg, s, qidx)
        grads = torch.autograd.grad(loss, leaves)
        optimizer.step(params, grads, opt_state)
        aux = {k: v.detach() for k, v in aux.items()}
        aux["loss"] = loss.detach()
        return aux

    return train_step


def pretrain(cfg: PriorConfig = PriorConfig(), log_every: int = 500,
             callback=None, shapes=None, device="cuda"):
    """Run pretraining on ``device``; returns (params, history): one record
    of the last step's metrics per ``log_every`` steps (one readback a
    window)."""
    dev = resolve_device(device)
    corpus, spec = build_corpus(cfg, shapes=shapes, device=dev)
    params = init_prior_params(cfg, torch.Generator().manual_seed(cfg.seed),
                               dev)
    opt = PriorOptimizer(cfg)
    opt_state = opt.init(params)
    step = make_prior_train_step(
        cfg, spec, opt, torch.Generator(device=dev).manual_seed(cfg.seed + 1),
        dev)
    history = []
    done = 0
    while done < cfg.steps:
        n = min(log_every, cfg.steps - done)
        for _ in range(n):
            aux = step(params, opt_state, corpus)
        done += n
        keys = list(aux)
        vals = torch.stack([aux[k] for k in keys]).cpu().tolist()
        rec = dict(zip(keys, vals), step=done)
        history.append(rec)
        if callback:
            callback(rec)
    return params, history


def frozen_params(params):
    """The decoder in ``Trainer.load_frozen``'s format."""
    return params["decoder"]


def eval_holdout(decoder, shapes, cfg: PriorConfig, fit_steps: int = 1500,
                 seed: int = 0, device="cuda"):
    """Held-out SDF L1 of a FROZEN decoder on unseen shapes
    (``pretrain.py:234-295``): fresh latents are fitted with Adam against
    the frozen decoder on half of each shape's queries (batches drawn
    with replacement), and the L1 is read on the other half.  The decoder
    is frozen here, so the SDF runs through the kernels (K1, and K3 with
    its latent gradient K4), bf16 on the card and f32 on the CPU.
    Returns (mean held-out L1, per-shape L1s)."""
    dev = resolve_device(device)
    holdout = dataclasses.replace(cfg, n_shapes=len(shapes))
    corpus, spec = build_corpus(holdout, shapes=shapes, device=dev)
    half = cfg.n_query // 2
    prior = _prep_layers(decoder, torch.bfloat16 if dev.type == "cuda"
                         else torch.float32)
    gen = torch.Generator().manual_seed(seed)
    dev_gen = torch.Generator(device=dev).manual_seed(seed)

    def masked_l1(lat, s, x, gt):
        idx, _ = query_grid(x, shape_table(corpus, holdout, s), spec,
                            k=cfg.k)
        sdf, has = aggregate_sdf(prior, lat, corpus["points"][s], idx,
                                 idx >= 0, x, cfg.rbf)
        l1 = torch.where(has, torch.abs(sdf - gt), 0.0)
        return torch.sum(l1) / torch.clamp(torch.sum(has), min=1)

    l1s = []
    for s in range(len(shapes)):
        lat = (0.01 * torch.randn(cfg.n_surface_cap, cfg.latent_dim,
                                  generator=gen)).to(dev).requires_grad_(True)
        mu, nu = torch.zeros_like(lat), torch.zeros_like(lat)
        for t in range(1, fit_steps + 1):
            q = torch.randint(0, half, (cfg.batch_queries,), generator=dev_gen,
                              device=dev)
            g, = torch.autograd.grad(masked_l1(lat, s, corpus["query"][s][q],
                                               corpus["query_sdf"][s][q]),
                                     lat)
            with torch.no_grad():
                mu = (1.0 - B1) * g + B1 * mu
                nu = (1.0 - B2) * (g * g) + B2 * nu
                lat -= cfg.latent_lr * (mu / (1.0 - B1 ** t)) / (
                    torch.sqrt(nu / (1.0 - B2 ** t)) + EPS)
        with torch.no_grad():
            l1s.append(masked_l1(lat, s, corpus["query"][s][half:],
                                 corpus["query_sdf"][s][half:]))
    l1s = torch.stack(l1s).cpu().tolist()
    return float(np.mean(l1s)), l1s


def save_prior(path: str, params):
    """Write the decoder as the npz of ``convert.from_jax.PRIOR_ASSET``
    (``F_geometry.<i>.w``, ``F_geometry.<i>.b``, ``T.0.w``, ``T.0.b``;
    f32, ``[in, out]``), which ``load_prior`` reads back."""
    dec = params["decoder"]
    np.savez(path, **{f"{name}.{i}.{k}": layer[k].detach().cpu().numpy()
                      for name in ("F_geometry", "T")
                      for i, layer in enumerate(dec[name])
                      for k in ("w", "b")})


def load_prior(path: str, device="cuda"):
    """The decoder that :func:`save_prior` wrote, as ``Trainer.load_frozen``
    takes it."""
    return load_prior_npz(path, device)
