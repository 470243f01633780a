"""The legacy entangled model (``model.entangled``, reference
``pointneus.py``) against the JAX package, on the CPU: the cases of
``tests/test_entangled.py`` on the port, its field functions and one
training step's render, loss and gradients with the same weights, scene
and draws, and the Trainer's path (an image, a few steps, a
checkpoint round trip).

Everything is f32 on both sides (the entangled MLPs have no compute
dtype), so the limits are f32 sum-order ones.  The port's scene gets
``n_points=0`` (the exact K1, JAX's CPU ``lax.top_k``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_render import scene_to_numpy

from spurfies_tpu.config import Config, apply_overrides
from spurfies_tpu.model import field as jfield
from spurfies_tpu.model import losses as jlosses
from spurfies_tpu.model import renderer as jren
from spurfies_tpu.model.neural_points import build_scene as j_build_scene
from spurfies_tpu.model.networks import init_model_params as j_init
from spurfies_tpu_torch.config import Config as TConfig
from spurfies_tpu_torch.config import apply_overrides as t_apply_overrides
from spurfies_tpu_torch.convert.from_jax import (
    params_from_numpy,
    scene_from_numpy,
)
from spurfies_tpu_torch.core.embedder import encoding_dim
from spurfies_tpu_torch.data.synthetic import make_synthetic_scene
from spurfies_tpu_torch.model import field as tfield
from spurfies_tpu_torch.model import losses as tlosses
from spurfies_tpu_torch.model import renderer as tren
from spurfies_tpu_torch.model.neural_points import build_scene
from spurfies_tpu_torch.model.networks import init_model_params
from spurfies_tpu_torch.train.optim import flatten
from spurfies_tpu_torch.train.trainer import Trainer

OVERRIDES = ["model.entangled=true", "model.max_shading_pts=16",
             "model.ray_sampler.near=0.5", "model.ray_sampler.far=3.0",
             "model.ray_sampler.n_samples=32", "train.num_pixels=96"]
TRAINED = ("feats", "F", "T", "R", "beta")


def _configs():
    return (apply_overrides(Config(), OVERRIDES),
            t_apply_overrides(TConfig(), OVERRIDES))


def _rel_err(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_param_shapes():
    _, tcfg = _configs()
    p = init_model_params(tcfg.model, torch.Generator().manual_seed(0),
                          device="cpu")
    assert p["frozen"] == {}
    assert p["train"]["F"][0]["w"].shape == (64 + encoding_dim(4, 3), 256)
    assert [layer["w"].shape[1] for layer in p["train"]["F"]] == [256] * 4
    assert p["train"]["T"][0]["w"].shape == (256, 1)
    assert p["train"]["R"][0]["w"].shape == (256 + encoding_dim(6, 3), 256)
    assert p["train"]["R"][-1]["w"].shape == (256, 3)
    assert p["train"]["beta"].shape == ()


def test_inverse_distance_weights():
    x_pi = torch.tensor([[[0.01, 0, 0], [0.02, 0, 0]]])
    w, norm = tfield.inverse_distance_weights(
        x_pi, torch.ones((1, 2), dtype=torch.bool))
    np.testing.assert_allclose(w[0].numpy(), [100.0, 50.0], rtol=1e-4)
    np.testing.assert_allclose(float(norm[0, 0]), 150.0, rtol=1e-4)


def test_single_latent_scene():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(1000, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    _, tcfg = _configs()
    _, latents = build_scene((0.5 * v).astype(np.float32), tcfg.model,
                             device="cpu")
    assert set(latents) == {"feats"}
    assert latents["feats"].shape[1] == 64


@pytest.fixture(scope="module")
def world():
    pts, cols, views = make_synthetic_scene(n_points=2000, n_views=2,
                                            img_res=(32, 32))
    cfg, _ = _configs()
    scene, latents = j_build_scene(jax.random.PRNGKey(0), pts, cfg.model,
                                   cols)
    params = j_init(jax.random.PRNGKey(1), cfg.model)
    tp = dict(params["train"], **latents)
    rng = np.random.default_rng(3)
    tp["feats"] = jnp.asarray(0.3 * rng.normal(size=latents["feats"].shape),
                              jnp.float32)
    return {"pts": pts, "cols": cols, "views": views, "scene": scene,
            "tp": tp, "t_scene": scene_from_numpy(
                scene_to_numpy(scene, n_points=0), device="cpu")}


def _jax_leaves(tree, keys):
    """The leaves of a JAX tree in the port's order (JAX's transformed
    dicts come back key-sorted: a Linear's ``b`` before its ``w``)."""
    def order(t):
        if isinstance(t, dict):
            keys = ("w", "b") if set(t) == {"w", "b"} else t
            return [x for k in keys for x in order(t[k])]
        if isinstance(t, (list, tuple)):
            return [x for v in t for x in order(v)]
        return [np.asarray(t)]
    return [x for k in keys for x in order(tree[k])]


def _t_params(tp):
    t = params_from_numpy({k: (tp[k] if k in ("feats", "beta") else [
        {"w": np.asarray(layer["w"]), "b": np.asarray(layer["b"])}
        for layer in tp[k]]) for k in TRAINED}, device="cpu")
    for leaf in flatten(t):
        leaf.requires_grad_(True)
    return t


def _pairs(world, n=200, seed=0):
    """Shading points near the cloud and their exact neighbours."""
    rng = np.random.default_rng(seed)
    pts = np.asarray(world["scene"].points)
    x = (pts[rng.integers(0, len(pts), n)]
         + rng.normal(0, 0.02, (n, 3))).astype(np.float32)
    idx, _ = tren.query_grid(torch.from_numpy(x), world["t_scene"].table,
                             world["t_scene"].spec, k=8)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return x, idx.numpy(), dirs


def test_entangled_field_matches_jax(world):
    """``entangled_sdf_feat`` and ``entangled_sdf_grad_color`` on the same
    weights, points and neighbours (some with none): sdf, the aggregated
    features, the spatial gradient and the colour within 1e-5 relative
    (f32 sums in another order; measured ~1e-7), and the gradients of
    sum(sdf) + sum(|grad|^2) + sum(rgb) -- the eikonal's double backward
    -- in every weight within 1e-4 relative L2."""
    x, idx, dirs = _pairs(world)
    idx[:5] = -1                                   # points with no neighbour
    valid = idx >= 0
    tp = world["tp"]
    pts_j = world["scene"].points

    def jfn(p):
        s, g, rgb = jfield.entangled_sdf_grad_color(
            p, p["feats"], pts_j, jnp.asarray(idx), jnp.asarray(valid),
            jnp.asarray(x), jnp.asarray(dirs))
        has = s < 500
        return (jnp.sum(jnp.where(has, s, 0.0)) + jnp.sum(g * g)
                + jnp.sum(rgb)), (s, g, rgb)

    jp = {k: tp[k] for k in TRAINED}
    (_, (sj, gj, rj)), grads_j = jax.jit(
        jax.value_and_grad(jfn, has_aux=True))(jp)
    _, fj, hj = jfield.entangled_sdf_feat(jp, jp["feats"], pts_j,
                                          jnp.asarray(idx),
                                          jnp.asarray(valid), jnp.asarray(x))

    tpp = _t_params(tp)
    pts_t = world["t_scene"].points
    st, gt, rt = tfield.entangled_sdf_grad_color(
        tpp, tpp["feats"], pts_t, torch.from_numpy(idx),
        torch.from_numpy(valid), torch.from_numpy(x), torch.from_numpy(dirs))
    _, ft, ht = tfield.entangled_sdf_feat(
        tpp, tpp["feats"], pts_t, torch.from_numpy(idx),
        torch.from_numpy(valid), torch.from_numpy(x))
    assert (ht.numpy() == np.asarray(hj)).all() and not ht[:5].any()
    np.testing.assert_array_equal(st.detach().numpy()[:5], 1000.0)
    for a, b in ((st, sj), (gt, gj), (rt, rj), (ft, fj)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)
    has = st < 500
    loss = (torch.sum(torch.where(has, st, 0.0)) + torch.sum(gt * gt)
            + torch.sum(rt))
    field_leaves = ("feats", "F", "T", "R")          # beta: not in the field
    grads_t = torch.autograd.grad(loss, flatten({k: tpp[k]
                                                 for k in field_leaves}))
    for a, b in zip(grads_t, _jax_leaves(grads_j, field_leaves)):
        assert _rel_err(a.numpy(), b) < 1e-4


def _batch(world, n, seed):
    views = world["views"]
    pix = np.random.default_rng(seed).choice(views["uv"].shape[0], n,
                                             replace=False)
    j_in = {"uv": jnp.asarray(views["uv"][pix])[None],
            "pose": jnp.asarray(views["pose"][:1]),
            "intrinsics": jnp.asarray(views["intrinsics"][:1])}
    gt = {"rgb": views["rgb"][0][pix], "mask": views["mask"][0][pix]}
    return (j_in, {k: jnp.asarray(v) for k, v in gt.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in j_in.items()},
            {k: torch.from_numpy(v) for k, v in gt.items()})


def test_entangled_step_matches_jax(world):
    """One training render, loss and gradient of every trained tensor,
    with JAX's uniform draws (``renderer.py:63, 190-195``; ``sampler.py:
    35``): the loss skips TV and pseudo-SDF on both sides (``trainer.py:
    196``).  f32 on both sides: the outputs within 1e-5, the loss parts
    1e-5 relative, the gradients 1e-4 relative L2 (measured: 2e-6)."""
    cfg, tcfg = _configs()
    key = jax.random.PRNGKey(11)
    j_in, j_gt, t_in, t_gt = _batch(world, 96, seed=5)

    def jloss(tp):
        out = jren.render_rays({"frozen": {}, "train": tp}, world["scene"],
                               j_in, key, cfg.model, train=True, iters=1)
        total, parts = jlosses.total_loss(out, j_gt, cfg.loss)
        return total, (parts, out)

    jp = {k: world["tp"][k] for k in TRAINED}
    (_, (pj, oj)), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    _, skey = jax.random.split(key)
    u = jax.random.uniform(skey, (96, cfg.model.ray_sampler.n_samples))
    tp = _t_params(world["tp"])
    ot = tren.render_rays({"frozen": None, "train": tp}, world["t_scene"],
                          t_in, tcfg.model, train=True, iters=1,
                          draws={"u_z": torch.from_numpy(np.array(u))})
    total, pt = tlosses.total_loss(ot, t_gt, tcfg.loss)
    gt = torch.autograd.grad(total, flatten(tp))

    assert ot["ray_mask"].numpy().mean() > 0.3
    np.testing.assert_array_equal(ot["ray_mask"].numpy(),
                                  np.asarray(oj["ray_mask"]))
    for name in ("rgb_values", "acc", "depth_values", "weights",
                 "grad_theta", "sdf"):
        np.testing.assert_allclose(ot[name].detach().numpy(),
                                   np.asarray(oj[name]), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    for name, v in pj.items():
        np.testing.assert_allclose(float(pt[name].detach()), float(v),
                                   rtol=1e-5, atol=1e-8, err_msg=name)
    assert float(pt["tv_loss"]) == float(pt["pseudo_loss"]) == 0
    for a, b in zip(gt, _jax_leaves(gj, TRAINED)):
        assert np.isfinite(a.numpy()).all()
        assert _rel_err(a.numpy(), b) < 1e-4


def test_entangled_trainer_renders_trains_and_restores(world, tmp_path):
    """The port's Trainer under ``model.entangled=true`` (JAX's
    ``test_entangled_e2e``, cut to 30 steps): an image's every 4th pixel
    through ``make_render_fn`` (finite, some rays hit), finite losses with rgb
    falling, and a checkpoint that carries ``feats`` back bit-equal."""
    _, tcfg = _configs()
    tr = Trainer(tcfg, world["pts"], world["cols"], world["views"],
                 device="cpu", compute_dtype=torch.float32)
    assert tr.prior is None and set(tr.state.params) == {
        "F", "T", "R", "beta", "feats"}
    v = world["views"]
    uv = v["uv"][::4]                          # every 4th pixel: 256 rays
    out = tr.render_image(uv, v["pose"][0], v["intrinsics"][0])
    assert out["rgb_values"].shape == (uv.shape[0], 3)
    assert all(np.isfinite(o).all() for o in out.values())
    assert out["ray_mask"].mean() > 0.1
    hist = []
    tr.run(30, window=10, callback=lambda s, m: hist.append(m))
    assert all(np.isfinite(m["loss"]) and m["notfinite"] == 0 for m in hist)
    assert hist[-1]["rgb_loss"] < hist[0]["rgb_loss"]
    path = str(tmp_path / "ckpt.pt")
    tr.save_checkpoint(path)
    tr2 = Trainer(tcfg, world["pts"], world["cols"], world["views"],
                  device="cpu", compute_dtype=torch.float32)
    tr2.restore_checkpoint(path)
    assert int(tr2.state.step) == 30
    assert torch.equal(tr2.state.params["feats"], tr.state.params["feats"])


def test_entangled_default_config_renders_where_jax_fails(world):
    """At the default config the entangled model's uniform grid has 64
    samples a ray and ``max_shading_pts`` is 80: JAX's compaction keeps 64
    columns and its shading concatenates them with 80 columns of ray
    directions, which raises.  The port shades ``min(80, 64)`` columns:
    every output is ``[R, 64]``-shaped and finite."""
    cfg = apply_overrides(Config(), ["model.entangled=true"])
    tcfg = t_apply_overrides(TConfig(), ["model.entangled=true"])
    assert cfg.model.max_shading_pts > cfg.model.ray_sampler.n_samples
    j_in, _, t_in, _ = _batch(world, 64, seed=1)
    with pytest.raises(TypeError):             # raised while tracing
        jax.jit(lambda tp: jren.render_rays(
            {"frozen": {}, "train": tp}, world["scene"], j_in,
            jax.random.PRNGKey(2), cfg.model, train=True, iters=1))(
                world["tp"])
    with torch.no_grad():
        out = tren.render_rays(
            {"frozen": None, "train": _t_params(world["tp"])},
            world["t_scene"], t_in, tcfg.model, train=True, iters=1)
    n = tcfg.model.ray_sampler.n_samples
    assert out["weights"].shape == (64, n) and out["grad_theta"].shape == (
        64, n, 3)
    assert all(bool(torch.isfinite(v.float()).all()) for v in out.values())
