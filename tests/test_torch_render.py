"""The whole slice: the port's ``make_render_fn`` against the JAX package's,
on the same scene, latents and prior, on the CPU.

Geometry runs in f32 and colour in bf16 on both sides (the JAX package's
CPU defaults: plain-XLA SDF path in f32, ``aggregate_color`` in bf16; the
port's ``compute_dtype=torch.float32`` for the prior).  The sampler and the
shading budget are cut (``OVERRIDES``) the same on both sides.  The port's
scene gets ``n_points=0`` so that its K1 takes the exact variant, which is
what the JAX package's CPU path (``lax.top_k``) computes.
"""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spurfies_tpu.config import Config, apply_overrides
from spurfies_tpu.model.neural_points import build_scene
from spurfies_tpu.model.networks import init_model_params
from spurfies_tpu.prior.pretrain import load_prior
from spurfies_tpu.train.trainer import make_render_fn
from spurfies_tpu_torch.config import Config as TConfig
from spurfies_tpu_torch.config import apply_overrides as t_apply_overrides
from spurfies_tpu_torch.convert.from_jax import (
    params_from_numpy,
    scene_from_numpy,
)
from spurfies_tpu_torch.data.synthetic import make_synthetic_scene
from spurfies_tpu_torch.train.trainer import make_render_fn as t_make_render_fn

PRIOR = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                     "local_prior")
OVERRIDES = ["model.ray_sampler.n_samples_eval=32",
             "model.ray_sampler.max_total_iters=2",
             "model.ray_sampler.n_samples=32",
             "model.max_shading_pts=48",
             "model.color_top_samples=16"]
KEYS = ("rgb_values", "depth_values", "normal_map", "acc", "ray_mask")


def scene_to_numpy(scene, n_points=None):
    spec = scene.spec
    return {
        "points": np.asarray(scene.points),
        "table_idx": np.asarray(scene.table.idx),
        "table_pos": np.asarray(scene.table.pos),
        "table_r": scene.table.r,
        "n_points": scene.table.n_points if n_points is None else n_points,
        "tv_idx": np.asarray(scene.tv_idx),
        "tv_valid": np.asarray(scene.tv_valid),
        "occ_fine": np.asarray(scene.occ_fine),
        "spec": {f: getattr(spec, f) for f in
                 ("voxel_size", "voxel_scale", "lo", "hi",
                  "max_pts_per_cell", "kernel", "qcap")},
    }


@pytest.fixture(scope="module")
def rendered():
    pts, cols, views = make_synthetic_scene(n_points=1500, img_res=(24, 40))
    cfg = apply_overrides(Config(), OVERRIDES)
    key = jax.random.PRNGKey(0)
    scene, latents = build_scene(key, pts, cfg.model, cols)
    params = init_model_params(jax.random.PRNGKey(1), cfg.model)
    frozen = load_prior(os.path.abspath(PRIOR))
    tp = dict(params["train"], **latents)
    # latents with some structure: a real scene's are optimized, random
    # N(0, 0.01) ones make a near-constant field
    rng = np.random.default_rng(3)
    tp["feats_geometry"] = jnp.asarray(
        0.3 * rng.normal(size=latents["feats_geometry"].shape), jnp.float32)
    tp["beta"] = jnp.asarray(0.02, jnp.float32)
    uv, pose, K = views["uv"], views["pose"][0], views["intrinsics"][0]

    out_j = make_render_fn(cfg)(tp, scene, frozen, uv, jnp.asarray(pose),
                                jnp.asarray(K), key)
    tcfg = t_apply_overrides(TConfig(), OVERRIDES)
    tp_np = jax.tree_util.tree_map(np.asarray, tp)
    t_tp = params_from_numpy(tp_np, device="cpu")
    t_frozen = params_from_numpy(jax.tree_util.tree_map(np.asarray, frozen),
                                 device="cpu")
    t_scene = scene_from_numpy(scene_to_numpy(scene, n_points=0),
                               device="cpu")
    render = t_make_render_fn(tcfg, device="cpu",
                              compute_dtype=torch.float32)
    out_t = render(t_tp, t_scene, t_frozen, uv, pose, K)
    return {k: np.asarray(v) for k, v in out_j.items()}, out_t


def test_render_outputs_finite_and_shaped(rendered):
    out_j, out_t = rendered
    n = 24 * 40
    for k in KEYS:
        assert out_t[k].shape[0] == n
        assert out_t[k].shape == out_j[k].shape
        assert np.isfinite(out_t[k].astype(np.float64)).all()
    assert out_t["ray_mask"].sum() > 0.2 * n      # the sphere is in view


def test_render_matches_jax(rendered):
    out_j, out_t = rendered
    mask = out_j["ray_mask"]
    # ray_mask: has-neighbour at some sample; a sample that crosses the
    # radius boundary through f32 rounding may flip a grazing ray
    assert (out_t["ray_mask"] != mask).mean() <= 0.002
    both = mask & out_t["ray_mask"]
    # per-ray agreement: f32 geometry differs only in rounding (the port's
    # fused linear tail and summation order), which moves the sampler's
    # z-values by ulps; a ray whose sample crosses a kNN radius boundary or
    # swaps a top-W colour slot can differ more -- bound their share
    # (bound for 99% of the rays, bound for the median ray); rgb: bf16
    # colour MLPs on both sides, rounded at different points
    tol = {"depth_values": (2e-3, 1e-5), "acc": (2e-3, 1e-5),
           "normal_map": (1e-2, 1e-4), "rgb_values": (1e-2, 3e-3)}
    for k, (t, t_med) in tol.items():
        err = np.abs(out_t[k] - out_j[k]).reshape(len(mask), -1).max(-1)
        bad = err[both] > t
        assert bad.mean() <= 0.01, (k, bad.mean(), np.sort(err[both])[-5:])
        assert np.median(err[both]) < t_med, (k, np.median(err[both]))
