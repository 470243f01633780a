"""The training slice: the port's training render, loss and gradients, one
``train_step``, the budget calibration and ``Trainer`` against the JAX
package, on the CPU.

The JAX side runs its fused Pallas path in interpret mode with f32
matmuls, as its own tests do (``tests/test_pallas_mlp.py:289-303``), and
the port its plain versions with an f32 prior; the colour MLPs run in bf16
on both sides.  Both get the same scene, latents and prior, and the port
gets the JAX draws: rebuilt here from the JAX keys along the splits of
``renderer.py:63`` and ``sampler.py:146``, and the draw calls of
``sampler.py:35, 59, 228`` and ``trainer.py:246-248``.  The port's scene
gets ``n_points=0``, so that its K1 takes the exact variant, which is what
the JAX package's CPU path (``lax.top_k``) computes.
"""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import contextlib
import importlib.util
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pair_mlp import jax_fused
from test_torch_render import scene_to_numpy

from spurfies_tpu.config import Config, apply_overrides
from spurfies_tpu.model import losses as jlosses
from spurfies_tpu.model import renderer as jren
from spurfies_tpu.model.neural_points import build_scene
from spurfies_tpu.model.networks import init_model_params
from spurfies_tpu.train import trainer as jtrainer
from spurfies_tpu.train.optim import build_optimizer
from spurfies_tpu_torch.config import Config as TConfig
from spurfies_tpu_torch.config import apply_overrides as t_apply_overrides
from spurfies_tpu_torch.convert.from_jax import (
    load_prior_npz,
    params_from_numpy,
    scene_from_numpy,
)
from spurfies_tpu_torch.data.synthetic import make_synthetic_scene
from spurfies_tpu_torch.model import field as tfield
from spurfies_tpu_torch.model import losses as tlosses
from spurfies_tpu_torch.model import renderer as tren
from spurfies_tpu_torch.ops.pair_mlp import _prep_layers
from spurfies_tpu_torch.train import trainer as ttrainer
from spurfies_tpu_torch.train.optim import Optimizer, flatten

OVERRIDES = ["model.ray_sampler.n_samples_eval=32",
             "model.ray_sampler.n_samples=32",
             "model.ray_sampler.n_samples_extra=16",
             "model.max_shading_pts=48",
             "model.color_top_samples=16",
             "train.num_pixels=256"]
TRAINED = ("feats_geometry", "feats_color", "F_color", "R", "beta")


@pytest.fixture(scope="module")
def world():
    pts, cols, views = make_synthetic_scene(n_points=1500, img_res=(24, 40))
    cfg = apply_overrides(Config(), OVERRIDES)
    scene, latents = build_scene(jax.random.PRNGKey(0), pts, cfg.model, cols)
    params = init_model_params(jax.random.PRNGKey(1), cfg.model)
    # the repo's prior, from the port's npz export of artifacts/local_prior
    # (tests/test_torch_prior_asset.py holds the two equal)
    t_frozen = load_prior_npz(device="cpu")
    frozen = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                    t_frozen)
    tp = dict(params["train"], **latents)
    # latents with some structure, as tests/test_torch_render.py's
    rng = np.random.default_rng(3)
    tp["feats_geometry"] = jnp.asarray(
        0.3 * rng.normal(size=latents["feats_geometry"].shape), jnp.float32)
    tp["beta"] = jnp.asarray(0.02, jnp.float32)
    t_scene = scene_from_numpy(scene_to_numpy(scene, n_points=0),
                               device="cpu")
    return {"views": views, "scene": scene, "frozen": frozen, "tp": tp,
            "t_scene": t_scene, "t_frozen": t_frozen,
            "prior": _prep_layers(t_frozen, torch.float32)}


def _configs(overrides):
    return (apply_overrides(Config(), OVERRIDES + overrides),
            t_apply_overrides(TConfig(), OVERRIDES + overrides))


def _ordered(tree, order):
    """``tree`` as numpy, its dicts in the key order of ``order`` (JAX's
    transformed trees come back key-sorted)."""
    if isinstance(order, dict):
        return {k: _ordered(tree[k], order[k]) for k in order}
    if isinstance(order, (list, tuple)):
        return [_ordered(t, o) for t, o in zip(tree, order)]
    return np.asarray(tree)


def _t_params(tp):
    """The JAX tree of trainable tensors as the port's, requiring grad."""
    t = params_from_numpy(_ordered(tp, tp), device="cpu")
    for leaf in flatten(t):
        leaf.requires_grad_(True)
    return t


def body_rays(n_rays, mcfg):
    """The rays the render body draws for: the ray budget's width when it
    is active (renderer.py:78-80)."""
    if 0 < mcfg.ray_budget_frac < 1:
        budget = -(-int(n_rays * mcfg.ray_budget_frac) // 64) * 64
        budget = min(n_rays, max(128, budget))
        if budget < n_rays:
            return budget
    return n_rays


def jax_render_draws(key, n_rays, mcfg, iters=1):
    """The training render's draws that the JAX package makes from
    ``key``, as tensors for the port's ``draws``."""
    scfg = mcfg.ray_sampler
    r = body_rays(n_rays, mcfg)
    _, skey = jax.random.split(key)                          # renderer :63
    keys = jax.random.split(skey, iters + 3)                 # sampler :146
    u_z = jax.random.uniform(keys[0], (r, scfg.n_samples_eval))
    u_pdf = jax.random.uniform(keys[iters], (r, scfg.n_samples))
    cols = jax.random.permutation(keys[-2], scfg.n_samples_eval * iters)[
        :scfg.n_samples_extra]
    return {"u_z": torch.from_numpy(np.array(u_z)),
            "u_pdf": torch.from_numpy(np.array(u_pdf)),
            "extra_cols": torch.from_numpy(np.array(cols)).long()}


@contextlib.contextmanager
def port_fused_color(on):
    """The port's ``field.FUSED_COLOR`` set to ``on``, and put back as it
    was on exit."""
    saved = tfield.FUSED_COLOR
    try:
        tfield.FUSED_COLOR = on
        yield
    finally:
        tfield.FUSED_COLOR = saved


def _jax_loss(world, cfg, inputs, gt, key, fused_color=False):
    scene, frozen = world["scene"], world["frozen"]

    def loss(tp):
        params = {"frozen": frozen, "train": tp}
        out = jren.render_rays(params, scene, inputs, key, cfg.model,
                               train=True, iters=cfg.train.fast_iters)
        out["tv_loss"] = jren.tv_loss(params, scene)
        out["pseudo_pts_loss"] = jren.pseudo_sdf_loss(params, scene, out,
                                                      cfg.model)
        total, parts = jlosses.total_loss(out, gt, cfg.loss)
        return total, (parts, out)

    return jax_fused(lambda: jax.jit(jax.value_and_grad(
        loss, has_aux=True))(world["tp"]), cfg.model.fused_agg,
        fused_color=fused_color)


def _port_loss(world, tcfg, inputs, gt, draws):
    tp = _t_params(world["tp"])
    params = {"frozen": world["prior"], "train": tp}
    out = tren.render_rays(params, world["t_scene"], inputs, tcfg.model,
                           train=True, iters=tcfg.train.fast_iters,
                           draws=draws)
    out["tv_loss"] = tren.tv_loss(params, world["t_scene"])
    out["pseudo_pts_loss"] = tren.pseudo_sdf_loss(params, world["t_scene"],
                                                  out, tcfg.model)
    total, parts = tlosses.total_loss(out, gt, tcfg.loss)
    leaves = flatten({k: tp[k] for k in TRAINED})
    grads = torch.autograd.grad(total, leaves)
    return total, parts, out, grads


def _batch(world, n, seed):
    views = world["views"]
    pix = np.random.default_rng(seed).choice(views["uv"].shape[0], n,
                                             replace=False)
    j_inputs = {"uv": jnp.asarray(views["uv"][pix])[None],
                "pose": jnp.asarray(views["pose"][:1]),
                "intrinsics": jnp.asarray(views["intrinsics"][:1])}
    gt = {"rgb": views["rgb"][0][pix], "mask": views["mask"][0][pix]}
    t_inputs = {k: torch.from_numpy(np.array(v)) for k, v in
                j_inputs.items()}
    return (j_inputs, {k: jnp.asarray(v) for k, v in gt.items()}, t_inputs,
            {k: torch.from_numpy(v) for k, v in gt.items()})


def _grad_tree(g_jax, tp):
    return flatten({k: _ordered(g_jax[k], tp[k]) for k in TRAINED})


def _rel_err(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


BUDGET = ["model.ray_budget_frac=0.6", "model.probe_budget_frac=0.5"]


@pytest.mark.parametrize("case,overrides", [
    ("budget", BUDGET),
    ("dense", ["model.ray_budget_frac=0", "model.probe_budget_frac=1"]),
    ("unfused", BUDGET + ["model.fused_agg=false"]),
    ("pairs", BUDGET + ["model.pair_budget_frac=0.625",
                        "model.color_pair_frac=0.75"]),
    ("render_budget", BUDGET + ["model.render_budget_frac=0.9"]),
    ("fused_color", BUDGET)])
def test_train_render_loss_and_grads_match_jax(world, case, overrides):
    """The training render with the JAX draws injected: its outputs, its
    loss parts and the gradient of every trained tensor, at the default
    model options and under ``model.fused_agg=false`` (the per-pair K6
    path), ``pair_budget_frac``/``color_pair_frac`` (the pair-compacted
    SDF through K7a and colour) and ``render_budget_frac``, and
    with ``field.FUSED_COLOR`` on both sides (``fused_color``: K8a/K8b, the
    JAX kernels in interpret mode).

    Geometry is f32 on both sides and differs only in rounding (the pair
    sums' order), so depth, acc and the rendered points agree to 1e-4 on
    98 % of the rays (measured: 1e-5 at the max) and the geometry and beta
    gradients to 2e-3 relative L2 (measured: 3e-4).  The colour MLPs run
    in bf16 on both sides with other rounding points -- JAX's backward runs
    its products in bf16, the port's in f32 on bf16-rounded operands -- so
    rgb agrees to 1e-2 (tests/test_torch_render.py's limit; measured: 3e-3)
    and the colour gradients (feats_color, F_color, R) to 4e-2 relative L2
    (measured: at most 1.8e-2).  The losses, means over the rays: 1e-3
    relative (measured: 1.3e-4).  The option cases read the same (largest
    over the leaves: geometry and beta 1.04e-3, colour 1.7e-2 to 2.4e-2;
    loss parts 1.0e-4).  Under ``fused_color`` the colour runs in the
    prior's dtype, f32 on both sides, and reads well inside the same
    limits (measured: rgb 1.7e-6 on 98 % of the rays, colour gradients
    4.3e-3, geometry and beta 1.0e-3, loss parts 2.5e-5)."""
    fused = case == "fused_color"
    cfg, tcfg = _configs(overrides)
    key = jax.random.PRNGKey(11)
    j_in, j_gt, t_in, t_gt = _batch(world, 256, seed=5)
    (lj, (pj, oj)), gj = _jax_loss(world, cfg, j_in, j_gt, key, fused)
    draws = jax_render_draws(key, 256, tcfg.model)
    with port_fused_color(fused):
        lt, pt, ot, gt = _port_loss(world, tcfg, t_in, t_gt, draws)

    mask = np.asarray(oj["ray_mask"])
    assert (ot["ray_mask"].numpy() != mask).mean() <= 0.01
    both = mask & ot["ray_mask"].numpy()
    assert both.mean() > 0.3
    for name, tol in (("rgb_values", 1e-2), ("acc", 1e-4),
                      ("depth_values", 1e-4), ("pts_rendered", 1e-4)):
        err = np.abs(ot[name].detach().numpy() - np.asarray(oj[name]))
        err = err.reshape(len(mask), -1).max(-1)[both]
        assert (err > tol).mean() <= 0.02, (name, np.sort(err)[-5:])
    for name, v in pj.items():
        np.testing.assert_allclose(float(pt[name].detach()), float(v),
                                   rtol=1e-3, atol=1e-7, err_msg=name)
    for a, b, name in zip(gt, _grad_tree(gj, world["tp"]), _leaf_names(
            world["tp"])):
        assert np.isfinite(a.numpy()).all(), name
        tol = 2e-3 if name.startswith(("feats_geometry", "beta")) else 4e-2
        assert _rel_err(a.numpy(), b) < tol, (name, _rel_err(a.numpy(), b))


def _leaf_names(tp):
    return [f"{k}[{i}]" for k in TRAINED for i in range(len(flatten(tp[k])))]


def jax_batch_draws(key, views, n_pix):
    """sample_batch's view and pixels (trainer.py:246-248)."""
    kv, kp = jax.random.split(key)
    v = jax.random.randint(kv, (), 0, views["rgb"].shape[0])
    pix = jax.random.choice(kp, views["uv"].shape[0], (n_pix,),
                            replace=False)
    return (torch.tensor([int(v)]),
            torch.from_numpy(np.array(pix)).long())


def test_one_train_step_matches_jax(world):
    """One ``train_step`` at the default model options; see
    :func:`_one_step_matches_jax`."""
    _one_step_matches_jax(world, [])


@pytest.mark.parametrize("case,overrides", [
    ("unfused", ["model.fused_agg=false"]),
    ("pairs", ["model.pair_budget_frac=0.625", "model.color_pair_frac=0.75"]),
    ("fused_color", [])])
def test_one_train_step_matches_jax_under_options(world, case, overrides):
    """One ``train_step`` under ``model.fused_agg=false``, under the
    pair-compacted SDF and colour, and with ``field.FUSED_COLOR`` on both
    sides (K8a/K8b, f32 as the prior), by :func:`_one_step_matches_jax`'s
    limits."""
    _one_step_matches_jax(world, overrides, case == "fused_color")


def _one_step_matches_jax(world, overrides, fused_color=False):
    """One ``train_step`` with the JAX draws injected: the loss parts, and
    the parameters after the guarded Adam.  Adam's first update is nearly
    -lr sign(g), so an entry whose gradient lies within the colour path's
    difference of 0 may step the other way, and Adam's g / (|g| + eps)
    turns a small gradient's relative difference into a step's.  So the
    geometry and beta (gradients within 3e-4) agree to 1e-2 lr on 99.8 %
    of their entries (measured: 99.91 %); the colour leaves, whose bf16
    gradients differ by up to 2 %, are held by the direction of their
    update: cosine >= 0.95 (measured: 0.983 at the least).  The step
    count and notfinite agree exactly."""
    cfg, tcfg = _configs(BUDGET + overrides)
    views = world["views"]
    tx = build_optimizer(cfg.train)
    _, j_step = jtrainer.make_train_step(cfg, tx)
    bundle = {"scene": world["scene"], "frozen": world["frozen"],
              "views": {k: jnp.asarray(v) for k, v in views.items()}}
    state = jtrainer.TrainState(world["tp"], tx.init(world["tp"]),
                                jnp.asarray(0, jnp.int32))
    key = jax.random.PRNGKey(21)
    j_state, pj = jax_fused(lambda: jax.jit(j_step)(bundle, state, key),
                            cfg.model.fused_agg, fused_color=fused_color)

    opt = Optimizer(tcfg.train)
    _, sample_batch, t_step = ttrainer.make_train_step(tcfg, opt, "cpu")
    t_views = {k: torch.from_numpy(np.asarray(v)) for k, v in views.items()}
    v, pix = jax_batch_draws(jax.random.fold_in(key, 0), views,
                             cfg.train.num_pixels)
    tp = _t_params(world["tp"])
    t_state = ttrainer.TrainState(tp, opt.init(tp),
                                  torch.zeros((), dtype=torch.int32))
    draws = jax_render_draws(jax.random.fold_in(key, 1),
                             cfg.train.num_pixels, tcfg.model)
    with port_fused_color(fused_color):
        pt = t_step({"scene": world["t_scene"], "prior": world["prior"],
                     "views": t_views}, t_state, None, draws=draws,
                    batch=sample_batch(t_views, None, v=v, pix=pix))
    for name in ("loss", "rgb_loss", "eikonal_loss", "mask_loss",
                 "pseudo_loss", "tv_loss"):
        np.testing.assert_allclose(float(pt[name]), float(pj[name]),
                                   rtol=1e-3, err_msg=name)
    assert float(pt["notfinite"]) == float(pj["notfinite"]) == 0
    assert int(t_state.step) == int(j_state.step) == 1
    lr = cfg.train.learning_rate
    p0 = flatten({k: _ordered(world["tp"][k], world["tp"][k])
                  for k in TRAINED})
    p1j = flatten({k: _ordered(j_state.params[k], world["tp"][k])
                   for k in TRAINED})
    p1t = flatten({k: tp[k] for k in TRAINED})
    geo, colour = {}, {}
    for a, b, c, name in zip(p1t, p1j, p0, _leaf_names(world["tp"])):
        dt, dj = (a.detach().numpy() - c).ravel(), (b - c).ravel()
        if name.startswith(("feats_geometry", "beta")):
            geo[name] = float((np.abs(dt - dj) > 1e-2 * lr).mean())
        else:
            colour[name] = float(dt @ dj / max(np.linalg.norm(dt)
                                               * np.linalg.norm(dj), 1e-30))
    assert all(v <= 0.002 for v in geo.values()), geo
    assert all(v >= 0.95 for v in colour.values()), colour


@pytest.fixture(scope="module")
def train_out(world):
    """A JAX training render's outputs (numpy), the shading points that
    the fd-eikonal term reuses."""
    cfg, _ = _configs([])
    j_in = _batch(world, 256, seed=9)[0]
    out = jax_fused(lambda: jax.jit(lambda tp: jren.render_rays(
        {"frozen": world["frozen"], "train": tp}, world["scene"], j_in,
        jax.random.PRNGKey(3), cfg.model, train=True, iters=1))(world["tp"]),
        cfg.model.fused_agg)
    return {k: np.asarray(out[k]) for k in ("valid_pt", "xyz", "nbr_idx",
                                            "nbr_valid")}


@pytest.mark.parametrize("term", ["tv", "cloud_anchor", "fd_eikonal"])
def test_loss_terms_match_jax(world, train_out, term):
    """The TV, cloud-anchor and fd-eikonal terms and their gradient in the
    geometry latents, with the JAX draws (fold_in(key, 7) / (key, 8) of
    trainer.py:200-208, the draws of renderer.py:484-489, 517).  f32
    geometry on both sides: values within 1e-5 relative, gradients within
    1e-4 relative L2 (the fd term divides a difference of two SDFs by
    2 eps = 1e-2)."""
    cfg, tcfg = _configs([])
    key = jax.random.PRNGKey(13)
    scene, t_scene = world["scene"], world["t_scene"]
    n = scene.points.shape[0]
    out_t = {k: torch.from_numpy(np.array(v)) for k, v in train_out.items()}
    if term == "tv":
        jfn = lambda p: jren.tv_loss(p, scene)          # noqa: E731
        tfn = lambda p: tren.tv_loss(p, t_scene)        # noqa: E731
    elif term == "cloud_anchor":
        k7 = jax.random.fold_in(key, 7)
        sel = torch.from_numpy(np.array(
            jax.random.randint(k7, (512,), 0, n))).long()
        jfn = lambda p: jren.cloud_anchor_loss(          # noqa: E731
            p, scene, k7, cfg.model, n_points=512)
        tfn = lambda p: tren.cloud_anchor_loss(          # noqa: E731
            p, t_scene, tcfg.model, n_points=512, sel=sel)
    else:
        k8 = jax.random.fold_in(key, 8)
        m = train_out["xyz"].reshape(-1, 3).shape[0]
        k8b, ksub = jax.random.split(k8)
        sel = torch.from_numpy(np.array(
            jax.random.randint(ksub, (1024,), 0, m))).long()
        u = torch.from_numpy(np.array(jax.random.normal(k8b, (1024, 3))))
        jfn = lambda p: jren.fd_eikonal_loss(            # noqa: E731
            p, scene, train_out, k8, cfg.model, n_sub=1024)
        tfn = lambda p: tren.fd_eikonal_loss(            # noqa: E731
            p, t_scene, out_t, tcfg.model, n_sub=1024, sel=sel, u=u)

    def jloss(geo):
        tp = dict(world["tp"], feats_geometry=geo)
        return jfn({"frozen": world["frozen"], "train": tp})

    vj, gj = jax_fused(lambda: jax.value_and_grad(jloss)(
        world["tp"]["feats_geometry"]), cfg.model.fused_agg)
    geo = torch.from_numpy(np.array(world["tp"]["feats_geometry"]))
    geo.requires_grad_(True)
    vt = tfn({"frozen": world["prior"], "train": {"feats_geometry": geo}})
    (gt,) = torch.autograd.grad(vt, geo)
    assert float(vj) > 0
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-5)
    assert _rel_err(gt.numpy(), np.asarray(gj)) < 1e-4


def test_calibrate_ray_budget_matches_jax(world):
    """The host-numpy calibration on the same scene bitmap and views gives
    the JAX package's fractions exactly (the same numpy operations)."""
    for ov in ([], ["model.ray_budget_frac=0"]):
        cfg, tcfg = _configs(ov)
        j = jtrainer._calibrate_ray_budget(world["scene"], world["views"],
                                           cfg)
        t = ttrainer._calibrate_ray_budget(world["t_scene"], world["views"],
                                           tcfg)
        assert t == j and 0 < t[0] <= 1 and 0 < t[1] <= 1


def test_rays_occupied_np_is_the_host_twin_of_coarse_occupancy(world):
    """The host-numpy per-ray occupancy equals the JAX package's, and
    agrees with the port's card-side ``coarse_ray_occupancy`` (rays lifted
    in numpy and in torch may round a sample across a cell face)."""
    cfg, tcfg = _configs([])
    views = world["views"]
    args = (world["scene"].spec, cfg.model.ray_sampler, views["uv"],
            views["pose"][1], views["intrinsics"][1])
    occ0 = np.asarray(world["scene"].occ_fine).reshape(-1)
    host = ttrainer._rays_occupied_np(occ0, *args)
    assert np.array_equal(host, jtrainer._rays_occupied_np(occ0, *args))
    inp = {"uv": torch.from_numpy(views["uv"])[None],
           "pose": torch.from_numpy(views["pose"][1:2]),
           "intrinsics": torch.from_numpy(views["intrinsics"][1:2])}
    dirs, cam = tren.get_camera_params(inp["uv"], inp["pose"],
                                       inp["intrinsics"])
    dev = tren.coarse_ray_occupancy(cam.expand(dirs.shape[1], 3),
                                    dirs.reshape(-1, 3), world["t_scene"],
                                    tcfg.model.ray_sampler).numpy()
    assert 0.1 < host.mean() < 1.0
    assert (dev != host).mean() <= 0.005


TINY = ["model.max_shading_pts=24", "model.color_top_samples=8",
        "model.ray_sampler.near=0.5", "model.ray_sampler.far=3.0",
        "model.ray_sampler.n_samples=16", "model.ray_sampler.n_samples_eval=32",
        "model.ray_sampler.n_samples_extra=8", "train.num_pixels=128"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """30 steps on a 48x48 sphere (tests/test_train.py's end-to-end scene,
    cut to stay in tier 1), with the port's own draws."""
    pts, cols, views = make_synthetic_scene(n_points=3000, n_views=3,
                                            img_res=(48, 48))
    cfg = t_apply_overrides(TConfig(), TINY)
    trainer = ttrainer.Trainer(cfg, pts, cols, views, device="cpu",
                               compute_dtype=torch.float32)
    metrics = []
    trainer.run(30, window=10, callback=lambda s, m: metrics.append((s, m)))
    return trainer, metrics, (cfg, pts, cols, views)


def test_trainer_lowers_rgb_loss_on_the_cpu(trained):
    trainer, metrics, _ = trained
    assert [s for s, _ in metrics] == [10, 20, 30]
    assert int(trainer.state.step) == 30
    first, last = metrics[0][1], metrics[-1][1]
    assert np.isfinite(last["loss"]) and last["notfinite"] == 0
    assert last["rgb_loss"] < first["rgb_loss"]
    assert 0 < trainer.cfg.model.ray_budget_frac < 1       # auto budgets
    assert 0 < trainer.cfg.model.probe_budget_frac < 1
    views = trained[2][3]
    out = trainer.render_image(views["uv"][:300], views["pose"][0],
                               views["intrinsics"][0])
    assert out["rgb_values"].shape == (300, 3)
    assert np.isfinite(out["rgb_values"]).all()


def test_checkpoint_round_trip(trained, tmp_path):
    """Params, frozen, optimizer state and step restore exactly; a file
    without optimizer state restores its params with a fresh optimizer and
    a warning."""
    trainer, _, (cfg, pts, cols, views) = trained
    path = str(tmp_path / "ck.pt")
    trainer.save_checkpoint(path)
    other = ttrainer.Trainer(t_apply_overrides(cfg, ["train.seed=5"]), pts,
                             cols, views, device="cpu",
                             compute_dtype=torch.float32)
    other.restore_checkpoint(path)
    step = int(trainer.state.step)
    assert step >= 30 and int(other.state.step) == step
    for a, b in zip(flatten(other.state.params),
                    flatten(trainer.state.params)):
        assert torch.equal(a, b) and a.requires_grad
    sa, sb = other.state.opt_state, trainer.state.opt_state
    for a, b in zip(sa.mu + sa.nu + list(sa.count.values()),
                    sb.mu + sb.nu + list(sb.count.values())):
        assert torch.equal(a, b)
    assert torch.equal(sa.notfinite_count, sb.notfinite_count)
    for a, b in zip(flatten(other.frozen), flatten(trainer.frozen)):
        assert torch.equal(a, b)

    ck = torch.load(path, weights_only=True)
    del ck["opt_state"]
    torch.save(ck, path)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        other.restore_checkpoint(path)
    assert any("optimizer" in str(w.message) for w in caught)
    assert all(int(c) == 0 for c in other.state.opt_state.count.values())
    other.run(2, window=2)                      # the fresh state trains
    assert int(other.state.step) == step + 2


def test_smoke_capture_step_records_every_kernel_launch(trained):
    """``chip_smoke.capture_step`` sees each kernel wrapper called as often
    in one step as ``PER_STEP`` says (the counts the card run holds the
    launch counters to), with all of the wrapper's parameters, and puts
    the wrappers back afterwards."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    trainer = trained[0]
    before = [getattr(m, n) for m, n, _ in smoke.kernel_sites()]
    seen = smoke.capture_step(trainer)
    assert {k: len(v) for k, v in seen.items()} == smoke.PER_STEP
    assert [getattr(m, n) for m, n, _ in smoke.kernel_sites()] == before
    assert all(len(a) == 7 for a in seen["select_knn"])
    assert sorted(len(a[0]) for a in seen["select_knn"])[0] == 128
    for name in ("pair_sdf_value_agg", "pair_sdf_aggregate"):
        assert all(len(a) == 5 for a in seen[name])
    n = trainer.scene.points.shape[0]
    assert all(a[4] == n for a in seen["pair_sdf_aggregate_bwd"])
    assert seen["scatter_add_rows"][0][1].shape[0] == \
        seen["scatter_add_rows"][0][0].shape[0]
