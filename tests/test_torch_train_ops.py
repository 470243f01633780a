"""The training slice's pieces against the JAX package, on the CPU: K5 and
K4's plain versions against the interpret-mode Pallas kernels, the
differentiable K3 (``PairSdfAggregate``) and ``gather_pair_rows`` against
JAX's gradients, the losses, and the guarded two-group Adam against
``build_optimizer``.  Inputs are made with numpy from a seed and handed to
both packages.
"""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_pair_mlp import jax_field_state

from spurfies_tpu.config import LossConfig, ModelConfig, TrainConfig
from spurfies_tpu.model import field as jfield
from spurfies_tpu.model import losses as jlosses
from spurfies_tpu.model.networks import init_model_params
from spurfies_tpu.ops import pallas_mlp as jpm
from spurfies_tpu.ops.pallas_scatter import scatter_add_rows as j_scatter
from spurfies_tpu.train.optim import build_optimizer
from spurfies_tpu_torch.config import LossConfig as TLossConfig
from spurfies_tpu_torch.config import ModelConfig as TModelConfig
from spurfies_tpu_torch.config import TrainConfig as TTrainConfig
from spurfies_tpu_torch.convert.from_jax import params_from_numpy
from spurfies_tpu_torch.model import field as tfield
from spurfies_tpu_torch.model import losses as tlosses
from spurfies_tpu_torch.model import networks as tnet
from spurfies_tpu_torch.model import sampler as tsamp
from spurfies_tpu_torch.ops import pair_mlp as tpm
from spurfies_tpu_torch.ops import scatter_rows as tsr
from spurfies_tpu_torch.train import optim as toptim

RBF = 45.0


# ---------------------------------------------------------------- K5 ----

@pytest.mark.parametrize("m,d,n,lo,hi", [(4096, 32, 512, -3, 515),
                                         (2048, 64, 96, -3, 99),
                                         (1024, 32, 8, 0, 3)],
                         ids=["d32", "d64", "heavy-duplicates"])
def test_scatter_rows_plain_matches_pallas_interpret(m, d, n, lo, hi):
    """Indices outside [0, n) are dropped on both sides; heavy duplicates
    sum in another order: within 1e-5 (1e-4 for ~340 terms a row, the
    tolerance of tests/test_pallas_scatter.py)."""
    rng = np.random.default_rng(m + d)
    idx = rng.integers(lo, hi, size=m).astype(np.int32)
    ct = rng.normal(size=(m, d)).astype(np.float32)
    ref = np.asarray(j_scatter(jnp.asarray(ct), jnp.asarray(idx), n,
                               tile=256, interpret=True))
    out = tsr.scatter_add_rows(torch.from_numpy(ct), torch.from_numpy(idx), n)
    tol = 1e-4 if hi - lo < 8 else 1e-5
    np.testing.assert_allclose(out.numpy(), ref, rtol=tol, atol=tol)


def test_scatter_rows_reads_a_strided_slice():
    """The colour cotangent's 64 latent columns of 67, read in place."""
    rng = np.random.default_rng(1)
    wide = torch.from_numpy(rng.normal(size=(777, 67)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 50, 777).astype(np.int32))
    got = tsr.scatter_add_rows(wide[:, :64], idx, 50)
    ref = np.asarray(j_scatter(jnp.asarray(wide[:, :64].numpy()),
                               jnp.asarray(idx.numpy()), 50, tile=256,
                               interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        tsr.scatter_add_rows(wide[:, :64], idx[:10], 50)


def test_zero_rows_add_nothing_to_the_scatter():
    """Why K5 may skip an add whose value is 0 (+0 or -0): a sum that
    starts at +0 never becomes -0, and adding +-0 to it leaves its bits as
    they were.  On the plain version, dropping the all-zero rows (40 %,
    at index 0, as a step's masked slots are), and then every zero-valued
    term of each column, gives the same bits; a NaN term is not 0 and
    still reaches ``out``."""
    rng = np.random.default_rng(9)
    m, d, n = 3000, 16, 40
    ct = rng.normal(size=(m, d)).astype(np.float32)
    idx = rng.integers(-2, n + 2, m).astype(np.int32)
    zero = rng.uniform(size=m) < 0.4
    zero[5] = False
    ct[zero] = np.where(rng.uniform(size=(int(zero.sum()), d)) < 0.5,
                        np.float32(0.0), np.float32(-0.0))
    idx[zero] = 0
    ct[rng.uniform(size=(m, d)) < 0.1] = -0.0             # scattered zeros
    ct[5, 3], idx[5] = np.nan, 7
    ct, idx = torch.from_numpy(ct), torch.from_numpy(idx)
    full = tsr.scatter_add_rows_ref(ct, idx, n)
    keep = torch.from_numpy(~zero)
    rows = tsr.scatter_add_rows_ref(ct[keep], idx[keep], n)
    terms = torch.stack([tsr.scatter_add_rows_ref(
        ct[ct[:, c] != 0][:, c:c + 1], idx[ct[:, c] != 0], n)[:, 0]
        for c in range(d)], 1)
    assert bool((full.view(torch.int32) == rows.view(torch.int32)).all())
    assert bool((full.view(torch.int32) == terms.view(torch.int32)).all())
    assert not bool(torch.signbit(full[full == 0]).any())   # no -0 sums
    for out in (full, rows, terms):
        assert bool(torch.isnan(out[7, 3]))
        assert int(torch.isnan(out).sum()) == 1


# ---------------------------------------------------------------- K4 ----

def _bwd_inputs(p=256, k=8, n=300, seed=4):
    """K3-shaped residuals: dump rows (w == 0, idx n), 5 fully empty
    points, and a few w == 0 rows on real indices."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (p, k)).astype(np.int32)
    valid = rng.uniform(size=(p, k)) > 0.3
    valid[:5] = False
    idx = np.where(valid, idx, n).astype(np.int32)
    w = np.where(valid.reshape(-1), rng.uniform(0.0, 1.0, p * k),
                 0.0).astype(np.float32)
    w[7::97] = 0.0
    r = (0.1 * rng.normal(size=(p * k, 32))).astype(np.float32)
    num_bar = rng.normal(size=p).astype(np.float32)
    return num_bar, w, r, idx, n


def test_agg_bwd_plain_matches_pallas_interpret():
    """K4 plain against ``_fused_agg_bwd_call(..., interpret=True)``: the
    same products (num_bar * w) * r in f32, summed in another order."""
    num_bar, w, r, idx, n = _bwd_inputs()
    p, k = idx.shape
    ref = np.asarray(jpm._fused_agg_bwd_call(
        jnp.asarray(num_bar)[:, None], jnp.asarray(w)[:, None],
        jnp.asarray(r), jnp.asarray(idx.reshape(-1)), n + 1, k,
        interpret=True))[:n]
    out = tpm.pair_sdf_aggregate_bwd(torch.from_numpy(num_bar),
                                     torch.from_numpy(w), torch.from_numpy(r),
                                     torch.from_numpy(idx), n)
    assert out.shape == (n, 32)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_agg_bwd_drops_rows_outside_the_table():
    num_bar, w, r, idx, n = _bwd_inputs(seed=5)
    args = [torch.from_numpy(a) for a in (num_bar, w, r)]
    bad = idx.copy()
    bad[9, :3] = -4
    bad[10, :3] = n + 12
    dump = idx.copy()
    dump[9, :3] = n
    dump[10, :3] = n
    got = tpm.pair_sdf_aggregate_bwd(*args, torch.from_numpy(bad), n)
    ref = tpm.pair_sdf_aggregate_bwd(*args, torch.from_numpy(dump), n)
    assert torch.equal(got, ref)


# --------------------------------- the differentiable K3 (Function) ----

@pytest.fixture
def flush_denormals():
    """In this setup most neighbours lie far from their query, so many RBF
    weights fall below f32's normal range; XLA's CPU flushes them to 0 and
    so must the port here, or "has a neighbour" and 1/den differ."""
    assert torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


@pytest.fixture(scope="module")
def agg_setup():
    """tests/test_pallas_mlp.py TestFusedAggregation's setup."""
    params = init_model_params(jax.random.PRNGKey(1), ModelConfig())
    rng = np.random.default_rng(0)
    n, m, k = 300, 200, 8
    lat = (rng.normal(size=(n, 32)).astype(np.float32)) * 0.1
    pts = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    idx = rng.integers(0, n, (m, k)).astype(np.int32)
    valid = rng.uniform(size=(m, k)) > 0.3
    valid[:5] = False
    x = rng.uniform(-0.5, 0.5, (m, 3)).astype(np.float32)
    frozen_np = jax.tree_util.tree_map(np.asarray, params["frozen"])
    prior = tpm._prep_layers(params_from_numpy(frozen_np, "cpu"),
                             torch.float32)
    return params["frozen"], prior, lat, pts, idx, valid, x


def _jax_fused_sdf(frozen, lat, pts, idx, valid, x):
    with jax_field_state():
        return jfield.sdf_and_grad(frozen, lat, pts, idx, valid, x, RBF)


def _torch_sdf(agg_setup, lat_t, x_t):
    _, prior, _, pts, idx, valid, _ = agg_setup
    return tfield.sdf_and_grad(prior, lat_t, torch.from_numpy(pts),
                               torch.from_numpy(idx),
                               torch.from_numpy(valid), x_t, RBF)


def test_function_latent_grad_matches_jax(agg_setup, flush_denormals):
    """test_latent_grad_parity's loss and tolerance (1e-3 rel, 1e-6 abs):
    the plain K3/K4 against JAX's interpret-mode fused custom VJP."""
    frozen, _, lat, pts, idx, valid, x = agg_setup
    c = np.random.default_rng(7).normal(size=(x.shape[0],)).astype(
        np.float32)

    def jloss(latents):
        s, _ = _jax_fused_sdf(frozen, latents, jnp.asarray(pts),
                              jnp.asarray(idx), jnp.asarray(valid),
                              jnp.asarray(x))
        return jnp.sum(jnp.where(s < 500.0, s, 0.0) * c)

    g_ref = np.asarray(jax.grad(jloss)(jnp.asarray(lat)))
    lat_t = torch.from_numpy(lat).requires_grad_(True)
    s, _ = _torch_sdf(agg_setup, lat_t, torch.from_numpy(x))
    torch.sum(torch.where(s < 500.0, s, 0.0) * torch.from_numpy(c)).backward()
    np.testing.assert_allclose(lat_t.grad.numpy(), g_ref, rtol=1e-3,
                               atol=1e-6)


def test_function_x_grad_matches_jax(agg_setup, flush_denormals):
    """test_x_grad_parity's loss; the x pullback num_bar * gagg against
    the same pullback in JAX's fused VJP, so 1e-5 of the scale."""
    frozen, _, lat, pts, idx, valid, x = agg_setup
    c = np.random.default_rng(8).normal(size=(x.shape[0],)).astype(
        np.float32)

    def jloss(xq):
        s, _ = _jax_fused_sdf(frozen, jnp.asarray(lat), jnp.asarray(pts),
                              jnp.asarray(idx), jnp.asarray(valid), xq)
        return jnp.sum(jnp.where(s < 500.0, s, 0.0) * c)

    g_ref = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    x_t = torch.from_numpy(x).requires_grad_(True)
    s, _ = _torch_sdf(agg_setup, torch.from_numpy(lat), x_t)
    torch.sum(torch.where(s < 500.0, s, 0.0) * torch.from_numpy(c)).backward()
    np.testing.assert_allclose(x_t.grad.numpy(), g_ref, rtol=1e-5,
                               atol=1e-5 * np.abs(g_ref).max())


def test_grad_theta_puts_nothing_into_the_latents(agg_setup):
    """The eikonal's latent gradient is zero almost everywhere (the frozen
    prior is piecewise linear; test_gradient_cotangent_is_zero_everywhere
    pins it in JAX), and the Function drops it exactly."""
    _, _, lat, *_ = agg_setup
    x = agg_setup[-1]
    lat_t = torch.from_numpy(lat).requires_grad_(True)
    _, grad = _torch_sdf(agg_setup, lat_t, torch.from_numpy(x))
    assert grad.requires_grad
    (g,) = torch.autograd.grad(((grad.norm(dim=-1) - 1.0) ** 2).sum(), lat_t)
    assert torch.equal(g, torch.zeros_like(g))


def test_aggregate_sdf_need_grad_is_the_function(agg_setup):
    """aggregate_sdf(need_grad=True) gives sdf_and_grad's SDF, with a
    latent gradient; need_grad=False (K2) carries none."""
    _, prior, lat, pts, idx, valid, x = agg_setup
    args = (torch.from_numpy(pts), torch.from_numpy(idx),
            torch.from_numpy(valid), torch.from_numpy(x), RBF)
    lat_t = torch.from_numpy(lat).requires_grad_(True)
    s, has = tfield.aggregate_sdf(prior, lat_t, *args)
    s2, _ = tfield.sdf_and_grad(prior, lat_t, *args)
    assert torch.equal(s, s2) and s.requires_grad
    v, has_v = tfield.aggregate_sdf(prior, lat_t, *args, need_grad=False)
    assert not v.requires_grad and torch.equal(has, has_v)


# ------------------------------------------------- gather_pair_rows ----

def test_gather_pair_rows_grad_equals_plain_indexing():
    """Its forward is plain indexing; its backward (K5 on the latent
    columns) gives the latents plain indexing's gradient, and the points
    none."""
    rng = np.random.default_rng(2)
    lat = torch.from_numpy(rng.normal(size=(40, 64)).astype(np.float32))
    pts = torch.from_numpy(rng.normal(size=(40, 3)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 40, (30, 8)).astype(np.int32))
    ct = torch.from_numpy(rng.normal(size=(30, 8, 67)).astype(np.float32))
    a = lat.clone().requires_grad_(True)
    g3 = tfield.gather_pair_rows(a, pts, idx)
    b = lat.clone().requires_grad_(True)
    ref = torch.cat([b, pts], 1)[idx.long()]
    assert torch.equal(g3, ref)
    (ga,) = torch.autograd.grad((g3 * ct).sum(), a)
    (gb,) = torch.autograd.grad((ref * ct).sum(), b)
    torch.testing.assert_close(ga, gb, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ losses ----

def _loss_inputs(seed=3, r=64, s=16):
    rng = np.random.default_rng(seed)
    valid = rng.uniform(size=(r, s)) > 0.4
    grad = rng.normal(size=(r, s, 3)).astype(np.float32)
    valid[3] = False                      # a ray with no valid sample
    grad[~valid] = 0.0                    # invalid rows are all zero
    weights = (rng.uniform(size=(r, s)) / s).astype(np.float32)
    weights[5] = 0.0                      # a miss ray: clipped at 1e-3
    return {
        "rgb_values": rng.uniform(size=(r, 3)).astype(np.float32),
        "grad_theta": grad, "valid_pt": valid, "weights": weights,
        "tv_loss": np.float32(0.3), "pseudo_pts_loss": np.float32(0.02),
        "fd_eikonal_loss": np.float32(0.7),
    }, {"rgb": rng.uniform(size=(r, 3)).astype(np.float32),
        "mask": (rng.uniform(size=(r, 1)) > 0.5).astype(np.float32)}


@pytest.mark.parametrize("rgb", ["l1", "mse"])
def test_total_loss_values_and_grads_match_jax(rgb):
    """Every part and the total, and the gradients in rgb, grad_theta and
    weights (with all-zero valid rows: the backward stays finite), in f32:
    1e-6 relative."""
    out, gt = _loss_inputs()
    diff = ("rgb_values", "grad_theta", "weights")
    kw = dict(rgb_loss=rgb, fd_eikonal_weight=0.05,
              fd_eikonal_anneal_init=0.5, fd_eikonal_anneal_steps=100)
    jcfg, tcfg = LossConfig(**kw), TLossConfig(**kw)

    def jtotal(*xs):
        o = dict(out, **{k: jnp.asarray(v) for k, v in zip(diff, xs)})
        return jlosses.total_loss(o, {k: jnp.asarray(v) for k, v in
                                      gt.items()}, jcfg,
                                  step=jnp.asarray(30, jnp.int32))

    (lj, pj), gj = jax.value_and_grad(jtotal, argnums=(0, 1, 2),
                                      has_aux=True)(
        *(jnp.asarray(out[k]) for k in diff))
    xs = [torch.from_numpy(np.asarray(out[k])).requires_grad_(True)
          for k in diff]
    o = {k: torch.as_tensor(np.asarray(v)) for k, v in out.items()}
    o.update(zip(diff, xs))
    lt, pt = tlosses.total_loss(o, {k: torch.from_numpy(v)
                                    for k, v in gt.items()}, tcfg,
                                step=torch.tensor(30, dtype=torch.int32))
    for key, v in pj.items():
        np.testing.assert_allclose(float(pt[key].detach()), float(v),
                                   rtol=1e-6,
                                   err_msg=key)
    gt_ = torch.autograd.grad(lt, xs)
    for a, b, name in zip(gt_, gj, diff):
        assert bool(torch.isfinite(a).all()), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-9, err_msg=name)


def test_fd_eikonal_weight_anneals_as_jax():
    kw = dict(fd_eikonal_weight=0.01, fd_eikonal_anneal_init=0.3,
              fd_eikonal_anneal_steps=200)
    for step in (0, 17, 150, 200, 999):
        j = jlosses.fd_eikonal_weight_at(LossConfig(**kw),
                                         jnp.asarray(step, jnp.int32))
        t = tlosses.fd_eikonal_weight_at(TLossConfig(**kw),
                                         torch.tensor(step))
        np.testing.assert_allclose(float(t), float(j), rtol=1e-6)
    assert tlosses.fd_eikonal_weight_at(TLossConfig(), None) == 0.0


# --------------------------------------------------------- optimizer ----

def _opt_params(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "F_color": [{"w": rng.normal(size=(5, 4)).astype(np.float32),
                     "b": rng.normal(size=(4,)).astype(np.float32)}],
        "beta": np.float32(0.1),
        "feats_color": rng.normal(size=(6, 3)).astype(np.float32),
        "feats_geometry": rng.normal(size=(6, 2)).astype(np.float32),
    }


def test_guarded_adam_matches_optax_for_5_steps():
    """Five steps of build_optimizer(TrainConfig()) with different
    latent/base rates: one clipped step (norm 200 > 1), one NaN step
    (skipped: zero update, moments and counts kept, notfinite 1), then
    steps that go on.  Params, moments, counts and notfinite_count agree to
    1e-6 relative."""
    kw = dict(latent_learning_rate=2e-3, cosine_t_max=7)
    tx = build_optimizer(TrainConfig(**kw))
    opt = toptim.Optimizer(TTrainConfig(**kw))
    p_np = _opt_params()
    pj = jax.tree_util.tree_map(jnp.asarray, p_np)
    sj = tx.init(pj)
    pt = params_from_numpy(p_np, "cpu")
    st = opt.init(pt)
    rng = np.random.default_rng(9)
    for i in range(5):
        g_np = _map(lambda a: (rng.normal(size=np.shape(a)) * 1e-2).astype(
            np.float32), p_np)
        if i == 1:
            g_np["feats_color"] = g_np["feats_color"] * 2e4     # clipped
        if i == 2:
            g_np["F_color"][0]["w"][1, 2] = np.nan               # skipped
        upd, sj = tx.update(jax.tree_util.tree_map(jnp.asarray, g_np), sj,
                            pj)
        pj = optax.apply_updates(pj, upd)
        opt.step(pt, toptim.flatten(params_from_numpy(g_np, "cpu")), st)
        assert int(st.notfinite_count) == int(sj.notfinite_count) == \
            (1 if i == 2 else 0)
        for a, b in zip(toptim.flatten(pt), toptim.flatten(
                _map(np.asarray, pj, order=p_np))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    inner = sj.inner_state.inner_states
    leaf = 0
    for key in pt:
        group = "latent" if key.startswith("feats") else "base"
        adam = inner[group].inner_state[0]
        assert int(st.count[group]) == int(adam.count) == 4
        for mom_t, mom_j in ((st.mu, adam.mu), (st.nu, adam.nu)):
            for i, b in enumerate(toptim.flatten(
                    _map(np.asarray, mom_j[key], order=p_np[key]))):
                np.testing.assert_allclose(mom_t[leaf + i].numpy(),
                                           np.asarray(b), rtol=1e-6,
                                           atol=1e-12)
        leaf += len(toptim.flatten(pt[key]))


def _map(fn, tree, order=None):
    """``fn`` over the leaves of ``tree``, its dicts in the key order of
    ``order`` (default: its own; JAX's trees come back key-sorted)."""
    order = tree if order is None else order
    if isinstance(order, dict):
        return {k: _map(fn, tree[k], order[k]) for k in order}
    if isinstance(order, (list, tuple)):
        return [_map(fn, t, o) for t, o in zip(tree, order)]
    return fn(tree)


def test_cosine_lr_matches_jax():
    from spurfies_tpu.train.optim import cosine_lr
    sj, st = cosine_lr(5e-4, 100, 3e-4), toptim.cosine_lr(5e-4, 100, 3e-4)
    for step in (0, 1, 50, 99, 100, 500):
        np.testing.assert_allclose(
            float(st(torch.tensor(step, dtype=torch.int32))),
            float(sj(jnp.asarray(step, jnp.int32))), rtol=1e-6)


# ---------------------------------------------------- device defaults ----

@pytest.mark.parametrize("name", ["linear_init", "mlp_init",
                                  "init_model_params", "uniform_z_vals"])
def test_entry_points_take_the_card_unless_told(name, monkeypatch):
    """Each raises without a card unless given device='cpu' (and
    uniform_z_vals's device is a required argument)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    calls = {
        "linear_init": lambda **d: tnet.linear_init(3, 4, gen, **d),
        "mlp_init": lambda **d: tnet.mlp_init([3, 4, 2], gen, **d),
        "init_model_params": lambda **d: tnet.init_model_params(
            TModelConfig(), gen, **d),
        "uniform_z_vals": lambda **d: tsamp.uniform_z_vals(
            4, 0.5, 4.5, 8, False, **d),
    }
    fn = calls[name]
    if name == "uniform_z_vals":
        with pytest.raises(TypeError):
            fn()
        with pytest.raises(RuntimeError):
            tsamp.uniform_z_vals(4, 0.5, 4.5, 8, False, "cuda")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    out = fn(device="cpu")
    leaf = toptim.flatten(out)[0] if not torch.is_tensor(out) else out
    assert leaf.device.type == "cpu"
