"""K6 / K7 (the per-pair prior kernels) and the field functions over them,
against the JAX package on the CPU.

The JAX side runs its Pallas kernels in interpret mode with f32 matmuls,
as ``tests/test_pallas_mlp.py:36-135`` does, and the port its plain
versions with an f32 prior.  Kernel level: the same 64-row ``u`` (and the
rows ``g``/queries ``x`` that give it) from numpy; field level: the sphere
scene of ``tests/test_model.py:23-35`` with neighbours from the JAX
``query_grid``, handed to both packages.
"""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pair_mlp import jax_fused

from spurfies_tpu.config import ModelConfig
from spurfies_tpu.model import field as jfield
from spurfies_tpu.model.networks import init_model_params
from spurfies_tpu.model.neural_points import build_scene
from spurfies_tpu.ops import pallas_mlp as jpm
from spurfies_tpu.ops.voxel_grid import query_grid
from spurfies_tpu_torch.convert.from_jax import params_from_numpy
from spurfies_tpu_torch.model import field as tfield
from spurfies_tpu_torch.ops import pair_mlp as tpm

CFG = ModelConfig()


def _np(tree):
    """Writable numpy copies (``torch.from_numpy`` takes them as they are)."""
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope="module")
def rows():
    """tests/test_pallas_mlp.py's prior and u; g and x with x - pos == x_pi
    (its ``_gx_inputs``)."""
    frozen = init_model_params(jax.random.PRNGKey(0), ModelConfig())["frozen"]
    rng = np.random.default_rng(1)
    u = np.concatenate([rng.normal(0, 0.3, (64, 32)),
                        rng.normal(0, 0.03, (64, 3))], -1).astype(np.float32)
    x = np.random.default_rng(3).normal(0, 0.3, (64, 3)).astype(np.float32)
    g = np.concatenate([u[:, :32], x - u[:, 32:]], 1)
    prior = tpm._prep_layers(params_from_numpy(_np(frozen), "cpu"),
                             torch.float32)
    return frozen, prior, u, g, x


_S, _R, _XPI = (1e-5, 1e-5), (1e-4, 1e-5), (1e-6, 1e-6)     # (rtol, atol)


@pytest.mark.parametrize("kernel", ["K7b", "K7a", "K6b", "K6a"])
def test_rows_plain_matches_pallas_interpret(rows, kernel):
    """Each plain version against its JAX function in interpret mode, f32:
    s within 1e-5, r within 1e-4 relative + 1e-5, x_pi within 1e-6 (the
    same f32 subtraction)."""
    frozen, prior, u, g, x = rows
    f32 = jnp.float32
    if kernel == "K7b":
        ref = (jpm.pair_sdf_value(frozen, jnp.asarray(u), f32),)
        got = (tpm.pair_sdf_value(torch.from_numpy(u), prior),)
        tols = (_S,)
    elif kernel == "K7a":
        ref = jpm.pair_sdf_value_and_input_grad(frozen, jnp.asarray(u), f32)
        got = tpm.pair_sdf_value_and_input_grad(torch.from_numpy(u), prior)
        tols = (_S, _R)
    elif kernel == "K6b":
        ref = jpm.pair_sdf_rows_value(frozen, jnp.asarray(g), jnp.asarray(x),
                                      f32)
        got = tpm.pair_sdf_rows_value(torch.from_numpy(g),
                                      torch.from_numpy(x), prior)
        tols = (_S, _XPI)
    else:
        ref = jpm.pair_sdf_rows_grad(frozen, jnp.asarray(g), jnp.asarray(x),
                                     f32)
        got = tpm.pair_sdf_rows_grad(torch.from_numpy(g), torch.from_numpy(x),
                                     prior)
        tols = (_S, _R, _XPI)
    assert len(got) == len(ref) == len(tols)
    for a, b, (rtol, atol) in zip(got, ref, tols):
        assert a.dtype == torch.float32 and not a.requires_grad
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=atol)


def test_rows_grad_function_matches_jax_vjp(rows):
    """``PairSdfRowsGrad``'s g and x gradients against ``jax.grad`` through
    ``pair_sdf_rows_grad``'s custom VJP, for a loss in s and x_pi; r carries
    no gradient."""
    frozen, prior, _, g, x = rows
    rng = np.random.default_rng(4)
    c = rng.normal(size=(64,)).astype(np.float32)
    c3 = rng.normal(size=(64, 3)).astype(np.float32)

    def jloss(gg, xx):
        s, _, xpi = jpm.pair_sdf_rows_grad(frozen, gg, xx, jnp.float32)
        return jnp.sum(s * c) + jnp.sum(xpi * c3)

    jg, jx = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(g), jnp.asarray(x))
    tg = torch.from_numpy(g).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    s, r, xpi = tpm.PairSdfRowsGrad.apply(tg, tx, prior)
    assert s.requires_grad and xpi.requires_grad and not r.requires_grad
    loss = (s * torch.from_numpy(c)).sum() + (xpi * torch.from_numpy(c3)).sum()
    gg, gx = torch.autograd.grad(loss, (tg, tx))
    for a, b in ((gg, jg), (gx, jx)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


def test_value_and_input_grad_function_matches_jax_vjp(rows):
    """``PairSdfValueAndInputGrad``'s u gradient, ``s_bar r``, against
    ``jax.grad`` through ``pair_sdf_value_and_input_grad``."""
    frozen, prior, u, _, _ = rows
    c = np.random.default_rng(2).normal(size=(64,)).astype(np.float32)
    ju = jax.grad(lambda uu: jnp.sum(jpm.pair_sdf_value_and_input_grad(
        frozen, uu, jnp.float32)[0] * c))(jnp.asarray(u))
    tu = torch.from_numpy(u).requires_grad_(True)
    s, r = tpm.PairSdfValueAndInputGrad.apply(tu, prior)
    assert not r.requires_grad
    (gu,) = torch.autograd.grad((s * torch.from_numpy(c)).sum(), tu)
    np.testing.assert_allclose(gu.numpy(), np.asarray(ju), rtol=1e-4,
                               atol=1e-6)


# ------------------------------------------------------------ field ----

@pytest.fixture(scope="module")
def sphere():
    """tests/test_model.py's sphere scene and parameters; 32 queries: 24
    near the surface and 8 in empty space (no neighbour)."""
    rng = np.random.default_rng(7)
    v = rng.normal(size=(4000, 3))
    pts = (0.5 * v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(
        np.float32)
    cols = rng.uniform(0, 255, size=(4000, 3)).astype(np.float32)
    scene, latents = build_scene(jax.random.PRNGKey(0), pts, CFG, cols)
    params = init_model_params(jax.random.PRNGKey(1), CFG)
    params["train"].update(latents)
    rng = np.random.default_rng(11)
    x = np.concatenate([
        np.asarray(scene.points[:24]) + rng.normal(0, 0.01, (24, 3)),
        rng.uniform(0.8, 0.95, (8, 3))]).astype(np.float32)
    idx, _ = query_grid(jnp.asarray(x), scene.table, scene.spec, k=CFG.k)
    idx = np.asarray(idx)
    tp = _np(params["train"])
    return {"frozen": params["frozen"], "tp": tp,
            "points": np.asarray(scene.points), "idx": idx,
            "valid": idx >= 0, "x": x,
            "prior": tpm._prep_layers(params_from_numpy(
                _np(params["frozen"]), "cpu"), torch.float32)}


def _args(sp, lat):
    """The field functions' arguments after the prior, for both packages."""
    arrays = (sp["points"], sp["idx"], sp["valid"], sp["x"])
    return ((lat,) + tuple(jnp.asarray(a) for a in arrays),
            tuple(torch.from_numpy(np.array(a)) for a in arrays))


def _sdf_loss(s, c):
    return (s.where(s < 100.0, 0.0) * c).sum() if torch.is_tensor(s) else \
        jnp.sum(jnp.where(s < 100.0, s, 0.0) * c)


def _eik_loss(s, gr):
    """tests/test_model.py:166-181's eikonal-plus-SDF loss."""
    if torch.is_tensor(s):
        return ((torch.linalg.norm(gr, dim=-1) - 1.0) ** 2).sum() + \
            s.where(s < 100.0, 0.0).sum()
    return jnp.sum((jnp.linalg.norm(gr, axis=-1) - 1.0) ** 2) + \
        jnp.sum(jnp.where(s < 100.0, s, 0.0))


@pytest.mark.parametrize("fn", ["aggregate_value", "aggregate_grad",
                                "sdf_and_grad"])
def test_unfused_field_matches_jax(sphere, fn):
    """``fused_agg=False`` (K6b / K6a on gathered rows, weights and sums in
    PyTorch, the latent gradient scattered by K5) against the JAX
    package's ``set_fused_agg(False)`` path: the SDF within 1e-5, the
    spatial gradient within 1e-4 relative + 1e-5, the latent gradient of
    an SDF loss (of the eikonal-plus-SDF loss for sdf_and_grad) within
    1e-4 relative + 1e-6: f32 on both sides, sums in another order."""
    sp = sphere
    geo = sp["tp"]["feats_geometry"]
    c = np.random.default_rng(5).normal(size=(32,)).astype(np.float32)
    jargs, targs = _args(sp, jnp.asarray(geo))
    lat = torch.from_numpy(geo).requires_grad_(True)

    if fn == "aggregate_value":
        s_j, has_j = jax_fused(lambda: jfield.aggregate_sdf(
            sp["frozen"], *jargs, CFG.rbf, need_grad=False), fused_agg=False)
        s_t, has_t = tfield.aggregate_sdf(sp["prior"], lat, *targs, CFG.rbf,
                                          need_grad=False, fused_agg=False)
        assert not s_t.requires_grad
        np.testing.assert_array_equal(has_t.numpy(), np.asarray(has_j))
        assert 0 < has_t.sum() < 32
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5,
                                   atol=1e-5)
        return

    if fn == "aggregate_grad":
        def jloss(g):
            s, _ = jfield.aggregate_sdf(sp["frozen"], g, *jargs[1:], CFG.rbf)
            return _sdf_loss(s, c), s
        s_t, _ = tfield.aggregate_sdf(sp["prior"], lat, *targs, CFG.rbf,
                                      fused_agg=False)
        loss_t = _sdf_loss(s_t, torch.from_numpy(c))
    else:
        def jloss(g):
            s, gr = jfield.sdf_and_grad(sp["frozen"], g, *jargs[1:], CFG.rbf)
            return _eik_loss(s, gr), (s, gr)
        s_t, gr_t = tfield.sdf_and_grad(sp["prior"], lat, *targs, CFG.rbf,
                                        fused_agg=False)
        loss_t = _eik_loss(s_t, gr_t)
    (_, aux), g_j = jax_fused(lambda: jax.value_and_grad(jloss, has_aux=True)(
        jargs[0]), fused_agg=False)
    s_j = aux[0] if fn == "sdf_and_grad" else aux
    np.testing.assert_allclose(s_t.detach().numpy(), np.asarray(s_j),
                               rtol=1e-5, atol=1e-5)
    if fn == "sdf_and_grad":
        np.testing.assert_allclose(gr_t.detach().numpy(), np.asarray(aux[1]),
                                   rtol=1e-4, atol=1e-5)
    (g_t,) = torch.autograd.grad(loss_t, lat)
    assert float(np.abs(np.asarray(g_j)).max()) > 0
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("over", [False, True], ids=["fits", "overflows"])
def test_sdf_and_grad_pairs_matches_jax(sphere, over):
    """``sdf_and_grad_pairs`` (K7a on the column-major compacted pairs)
    against the JAX package's fused branch (``tests/test_model.py:234-257``),
    with a budget that holds every valid pair and one that sheds a third:
    SDF within 1e-5, gradient within 1e-4 relative + 1e-5, and the latent
    gradient of the eikonal-plus-SDF loss within 1e-4 relative + 1e-6."""
    sp = sphere
    geo = sp["tp"]["feats_geometry"]
    n_valid = int(sp["valid"].sum())
    budget = 2 * n_valid // 3 if over else n_valid + 8
    jargs, targs = _args(sp, jnp.asarray(geo))

    def jloss(g):
        s, gr = jfield.sdf_and_grad_pairs(sp["frozen"], g, *jargs[1:],
                                          CFG.rbf, budget)
        return _eik_loss(s, gr), (s, gr)

    (_, (s_j, gr_j)), g_j = jax_fused(lambda: jax.value_and_grad(
        jloss, has_aux=True)(jargs[0]))
    lat = torch.from_numpy(geo).requires_grad_(True)
    s_t, gr_t = tfield.sdf_and_grad_pairs(sp["prior"], lat, *targs, CFG.rbf,
                                          budget)
    (g_t,) = torch.autograd.grad(_eik_loss(s_t, gr_t), lat)
    np.testing.assert_allclose(s_t.detach().numpy(), np.asarray(s_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gr_t.detach().numpy(), np.asarray(gr_j),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-4,
                               atol=1e-6)
    if not over:      # nothing shed: the dense K3 path gives the same SDF
        s_d, _ = tfield.sdf_and_grad(sp["prior"], lat.detach(), *targs,
                                     CFG.rbf)
        np.testing.assert_allclose(s_t.detach().numpy(), s_d.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_aggregate_color_pairs_matches_jax(sphere):
    """``aggregate_color_pairs`` against JAX's in f32 (as
    ``tests/test_model.py:259-298`` runs it), with a budget that sheds a
    quarter of the pairs: colours within 1e-5, the colour-latent gradient
    (K5 behind ``gather_latents``) within 1e-4 relative + 1e-6."""
    sp = sphere
    tp = sp["tp"]
    budget = 3 * int(sp["valid"].sum()) // 4
    dirs = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (32, 1))
    jtp = jax.tree_util.tree_map(jnp.asarray, tp)
    jargs, targs = _args(sp, jtp["feats_color"])

    def jloss(feats):
        rgb = jfield.aggregate_color_pairs(
            jtp, feats, *jargs[1:], jnp.asarray(dirs), CFG.rbf, budget,
            compute_dtype=jnp.float32)
        return jnp.sum(rgb * jnp.arange(3.0)), rgb

    (_, rgb_j), g_j = jax.value_and_grad(jloss, has_aux=True)(jargs[0])
    ttp = params_from_numpy({k: tp[k] for k in ("F_color", "R")}, "cpu")
    feats = torch.from_numpy(tp["feats_color"]).requires_grad_(True)
    rgb_t = tfield.aggregate_color_pairs(
        ttp, feats, *targs, torch.from_numpy(dirs), CFG.rbf, budget,
        compute_dtype=torch.float32)
    (g_t,) = torch.autograd.grad((rgb_t * torch.arange(3.0)).sum(), feats)
    np.testing.assert_allclose(rgb_t.detach().numpy(), np.asarray(rgb_j),
                               rtol=1e-5, atol=1e-5)
    assert float(np.abs(np.asarray(g_j)).max()) > 0
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-4,
                               atol=1e-6)
