"""The frozen prior's pair MLP with RBF weights and per-point sums, and its
latent gradient: the plain versions of the port's K2, K3 and K4.

Pair rows are point-major: ``idx_ext [P, k]`` indexes a table
``[N+1, 32+3] = [latent | position]`` whose row N is the dump row at
``DUMP_POS``; an invalid pair points there and gets w == 0 exactly.  The
products run in f32, each operand through :func:`benchmark.plain.precision.q`.
"""

from dataclasses import dataclass

import torch

from benchmark.plain.device import constant
from benchmark.plain.faults import FAULTS
from benchmark.plain.precision import mm, q

DUMP_POS = 1.0e9        # dump-row position: w = exp(-rbf^2 * ~1e18) == 0
LAT = 32


@dataclass
class PriorLayers:
    """The frozen prior, prepared once (``_prep_layers``): weights
    ``[in, out]`` (the last one the fused 256->1 tail), biases ``[1, out]``,
    and the number of layers with a LeakyReLU."""
    ws: list
    bs: list
    n_act: int
    compute_dtype: torch.dtype = torch.float32


def _prep_layers(frozen, compute_dtype=torch.float32) -> PriorLayers:
    """F_geometry[4] and T are plain linear and fuse exactly, in f32, into
    one 256->1 layer: w_v = W4 @ W_T, b_v = b4 @ W_T + b_T."""
    layers = [(l["w"], l["b"]) for l in frozen["F_geometry"]]
    layers += [(l["w"], l["b"]) for l in frozen["T"]]
    n_act = len(frozen["F_geometry"]) - 1
    w_tail, b_tail = layers[n_act]
    wv = w_tail.float()
    bv = b_tail.float()
    for w, b in layers[n_act + 1:]:
        bv = bv @ w.float() + b.float()
        wv = wv @ w.float()
    fused = layers[:n_act] + [(wv, bv)]
    ws = [w.float() for w, _ in fused]
    bs = [(b.float()[None] if b.ndim == 1 else b.float()) for _, b in fused]
    return PriorLayers(ws, bs, n_act)


def pair_table(latents: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """``[N+1, D+3]`` rows ``[latent | position]``; row N is the dump row."""
    d = latents.shape[1]
    dump = torch.cat([latents.new_zeros(1, d),
                      latents.new_full((1, 3), DUMP_POS)], 1)
    return torch.cat([torch.cat([latents, points.to(latents.dtype)], 1),
                      dump], 0).contiguous()


def _gather(table, idx_ext, x, rbf: float):
    """Pair rows, x_pi, w: ``g [P*k, d+3]``, ``xpi [P*k, 3]``, ``w [P*k]``."""
    k = idx_ext.shape[1]
    rows = table.shape[0]
    idx = idx_ext.reshape(-1).long()
    g = table[torch.where((idx >= 0) & (idx < rows), idx, rows - 1)]
    xpi = torch.repeat_interleave(x, k, dim=0) - g[:, -3:]
    d2 = (xpi[:, 0] * xpi[:, 0] + xpi[:, 1] * xpi[:, 1]) + xpi[:, 2] * xpi[:, 2]
    rbf2 = constant(float(rbf) ** 2, torch.float32, x.device)
    w = torch.exp(-rbf2 * d2)
    return g, xpi, w


def _up_sweep(layers: PriorLayers, lat, xpi, keep_gates: bool):
    """s [T] and the gates of layers 0..n_act-1 (a > 0)."""
    d = lat.shape[1]
    w0 = layers.ws[0]
    a = (mm(lat, w0[:d]) + mm(xpi, w0[d:])) + layers.bs[0]
    gates = []
    x = None
    for i in range(len(layers.ws)):
        if i > 0:
            a = mm(x, layers.ws[i]) + layers.bs[i]
        if i < layers.n_act:
            if keep_gates:
                gates.append(a > 0)
            x = torch.maximum(a, 0.01 * a)
        else:
            x = a
    return q(x[:, 0]) + FAULTS["sdf_offset"], gates


def _down_sweep(layers: PriorLayers, gates, t: int):
    """r = ds/du [T, 35]."""
    delta = layers.ws[-1].t().expand(t, -1)                 # [T, 256]
    for i in range(layers.n_act - 1, -1, -1):
        delta = delta * torch.where(gates[i], 1.0, 0.01)
        delta = mm(delta, layers.ws[i].t())
    return delta


@torch.no_grad()
def pair_sdf_value_agg(table, idx_ext, x, layers: PriorLayers, rbf: float):
    """``pt [P, 2] = (sum_k w s, sum_k w)``: the sampler's probe."""
    p, k = idx_ext.shape
    g, xpi, w = _gather(table, idx_ext, x, rbf)
    s, _ = _up_sweep(layers, g[:, :-3], xpi, keep_gates=False)
    return torch.stack([w * s, w], dim=1).view(p, k, 2).sum(dim=1)


@torch.no_grad()
def pair_sdf_aggregate(table, idx_ext, x, layers: PriorLayers, rbf: float):
    """``(pt [P, 5] = (sum w s, sum w, sum w ds/dx), w [P*k], r_lat [P*k,
    32])``."""
    p, k = idx_ext.shape
    g, xpi, w = _gather(table, idx_ext, x, rbf)
    d = g.shape[1] - 3
    s, gates = _up_sweep(layers, g[:, :d], xpi, keep_gates=True)
    r = _down_sweep(layers, gates, g.shape[0])              # [T, d+3]
    cols = torch.cat([(w * s)[:, None], w[:, None], w[:, None] * r[:, d:]], 1)
    return cols.view(p, k, 5).sum(dim=1), w, r[:, :d]


def pair_sdf_aggregate_bwd(num_bar, w, r_lat, idx_ext, n: int):
    """``[n, 32]`` with ``out[idx[t]] += (num_bar[t // k] * w[t]) *
    r_lat[t]``; a row outside ``[0, n)`` or whose w is 0 adds nothing."""
    k = idx_ext.shape[1]
    idx = idx_ext.reshape(-1).long()
    keep = (idx >= 0) & (idx < n) & (w != 0)
    ct = (torch.repeat_interleave(num_bar, k) * w)[:, None] * r_lat.float()
    out = torch.zeros((n + 1, r_lat.shape[1]), dtype=torch.float32,
                      device=w.device)
    out.index_add_(0, torch.where(keep, idx, n),
                   torch.where(keep[:, None], ct, 0.0))
    return out[:n]


class PairSdfAggregate(torch.autograd.Function):
    """``(num [P], den [P], gagg [P, 3])``, differentiable in the latents
    (``num_bar * w * r_lat`` scattered) and in x (``num_bar * gagg``: the
    weights' distances are detached); den's and gagg's cotangents are
    dropped (den has no latent dependence; gagg's latent derivative is zero
    almost everywhere, the prior being piecewise linear)."""

    @staticmethod
    def forward(ctx, latents, points, idx_ext, x, layers: PriorLayers,
                rbf: float):
        pt, w, r_lat = pair_sdf_aggregate(pair_table(latents, points),
                                          idx_ext, x.contiguous(), layers,
                                          rbf)
        gagg = pt[:, 2:5]
        ctx.save_for_backward(w, r_lat, idx_ext, gagg)
        ctx.n = latents.shape[0]
        return pt[:, 0], pt[:, 1], gagg

    @staticmethod
    def backward(ctx, num_bar, den_bar, gagg_bar):
        w, r_lat, idx_ext, gagg = ctx.saved_tensors
        lat_bar = x_bar = None
        if ctx.needs_input_grad[0]:
            lat_bar = pair_sdf_aggregate_bwd(num_bar.contiguous(), w, r_lat,
                                             idx_ext, ctx.n)
        if ctx.needs_input_grad[3]:
            x_bar = num_bar[:, None] * gagg
        return lat_bar, None, None, x_bar, None, None
