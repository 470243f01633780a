"""The probe budget's overflow flag under the ray budget, in both packages.

Under ``model.ray_budget_frac`` the training render compacts the batch's
occupied rays into a budget of slots (``compact_pair_slots``); the slots
left over are spare: each repeats the batch's last ray and its outputs are
cut away (``_scatter_rays_back``).  The sampler's first probe flattens its
points ray-major, so the spare slots' points come last, and the probe
budget (``sdf_probe``) keeps the first ``budget`` occupied points.  When
the last ray is occupied, its copies can fill the probe budget and raise
``probe_budget_overflow`` although no real ray lost a probe.

On the scene and batch below (a DUSt3R-like cloud of 4,315 points, 512
pixels of a 48x64 view, the calibrated budgets: ray 0.8201 -> 448 slots
for 390 occupied rays, probe 0.1089 -> 1,536 of 14,336 points), the JAX
package and the port, counted from the probe points and their occupancy,
drop 88 occupied points, every one a spare slot's and none a real ray's,
and both raise the flag.  With a tighter probe budget (0.08 -> 1,024
points) they drop 600: 222 of real rays and 378 of spare slots.

The port leaves the spare slots' points out of the occupancy that the
probe budget compacts (``_render_body``'s ``ray_ok``).  Every live point
keeps its rank, so every output of the render, the loss and every gradient
stay the same bits, and the flag is raised only when a real ray's probe is
dropped: False on the first batch, True on the second.  The JAX package is
left as it is, so its flag differs there by design (``ROADMAP.md`` Queue
3).

The JAX side runs its plain XLA field (``fused_agg=False``): the probe
points and their occupancy depend only on the rays and the draws.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pair_mlp import jax_fused
from test_torch_render import scene_to_numpy
from test_torch_train import OVERRIDES, _batch, _t_params, jax_render_draws

from spurfies_tpu.config import Config, apply_overrides
from spurfies_tpu.model import field as jfield
from spurfies_tpu.model import renderer as jren
from spurfies_tpu.model.neural_points import build_scene
from spurfies_tpu.model.networks import init_model_params
from spurfies_tpu.train import trainer as jtrainer
from spurfies_tpu_torch.config import Config as TConfig
from spurfies_tpu_torch.config import apply_overrides as t_apply_overrides
from spurfies_tpu_torch.convert.from_jax import (
    load_prior_npz,
    scene_from_numpy,
)
from spurfies_tpu_torch.data.synthetic import make_dust3r_like_scene
from spurfies_tpu_torch.model import field as tfield
from spurfies_tpu_torch.model import renderer as tren
from spurfies_tpu_torch.ops.pair_mlp import _prep_layers
from spurfies_tpu_torch.train import trainer as ttrainer
from spurfies_tpu_torch.train.optim import Optimizer, flatten

N_PIX = 512
SEED = 9
# (probe_budget_frac or None for the calibrated one, real drops, spare drops)
CASES = {"spare_only": (None, 0, 88), "real_drop": (0.08, 222, 378)}


@pytest.fixture(scope="module")
def world():
    pts, cols, views = make_dust3r_like_scene(n_points=2000,
                                              img_res=(48, 64))
    cfg = apply_overrides(Config(), OVERRIDES + [f"train.num_pixels={N_PIX}",
                                                 "model.ray_budget_frac=-1",
                                                 "model.probe_budget_frac=-1"])
    scene, latents = build_scene(jax.random.PRNGKey(0), pts, cfg.model, cols)
    params = init_model_params(jax.random.PRNGKey(1), cfg.model)
    t_frozen = load_prior_npz(device="cpu")
    frozen = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                    t_frozen)
    tp = dict(params["train"], **latents)
    rng = np.random.default_rng(3)
    tp["feats_geometry"] = jnp.asarray(
        0.3 * rng.normal(size=latents["feats_geometry"].shape), jnp.float32)
    tp["beta"] = jnp.asarray(0.02, jnp.float32)
    t_scene = scene_from_numpy(scene_to_numpy(scene, n_points=0),
                               device="cpu")
    ray_frac, probe_frac = jtrainer._calibrate_ray_budget(scene, views, cfg)
    return {"views": views, "scene": scene, "frozen": frozen, "tp": tp,
            "t_scene": t_scene, "prior": _prep_layers(t_frozen,
                                                      torch.float32),
            "ray_frac": ray_frac, "probe_frac": probe_frac}


def _configs(world, probe_frac):
    ov = OVERRIDES + [f"train.num_pixels={N_PIX}",
                      f"model.ray_budget_frac={world['ray_frac']}",
                      "model.probe_budget_frac="
                      f"{probe_frac or world['probe_frac']}"]
    return (apply_overrides(Config(), ov),
            t_apply_overrides(TConfig(), ov))


@contextlib.contextmanager
def recorded(module):
    """Every ``compact_pair_slots(valid, budget)`` of ``module`` while the
    block runs, as numpy ``(valid, budget, ok)``: the ray budget's, then
    each probe's.  Under ``jax.jit`` the values are kept when the compiled
    render runs."""
    calls = []
    orig = module.compact_pair_slots

    def keep(valid, budget, ok):
        calls.append((np.asarray(valid), budget, np.asarray(ok)))

    def record(valid, budget):
        out = orig(valid, budget)
        if isinstance(valid, torch.Tensor):
            keep(valid, budget, out[1])
        else:
            jax.debug.callback(lambda v, ok: keep(v, budget, ok), valid,
                               out[1], ordered=True)
        return out

    module.compact_pair_slots = record
    try:
        yield calls
    finally:
        module.compact_pair_slots = orig


def dropped_points(calls):
    """(real, spare): the occupied points of the first probe that its
    budget dropped, by the ray-budget slot they belong to (ok True: a real
    ray; ok False: a spare slot).  Points are ray-major [slots * Z]."""
    _, slots, ok = calls[0]
    occ, budget, _ = calls[1]
    dropped = occ & (np.cumsum(occ) - 1 >= budget)
    per_slot = dropped.reshape(slots, -1).sum(1)
    return int(per_slot[ok].sum()), int(per_slot[~ok].sum())


@contextlib.contextmanager
def spare_slots_probed():
    """The port's render as it was before the repair: ``_render_body``
    never sees the ray budget's ``ray_ok``, so its spare slots' probe
    points take probe-budget slots."""
    body = tren._render_body
    tren._render_body = lambda *a, ray_ok=None, **kw: body(*a, **kw)
    try:
        yield
    finally:
        tren._render_body = body


def _port_render(world, tcfg, t_in, draws):
    params = {"frozen": world["prior"], "train": _t_params(world["tp"])}
    with torch.no_grad():
        return tren.render_rays(params, world["t_scene"], t_in, tcfg.model,
                                train=True, iters=1, draws=draws)


def _same_bits(a, b):
    if a.dtype.is_floating_point:
        return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                                  b.view(torch.int32))
    return torch.equal(a, b)


def test_the_scene_has_spare_slots_and_an_occupied_last_ray(world):
    """The premises of the counts: the calibrated ray budget leaves spare
    slots on this batch, and the batch's last ray, which they repeat, is
    occupied."""
    _, tcfg = _configs(world, None)
    _, _, t_in, _ = _batch(world, N_PIX, seed=SEED)
    with recorded(tfield) as calls:
        _port_render(world, tcfg, t_in, jax_render_draws(
            jax.random.PRNGKey(SEED), N_PIX, tcfg.model))
    ray_occ, slots, ok = calls[0]
    assert ray_occ.shape == (N_PIX,) and slots == 448 < N_PIX
    assert int(ok.sum()) == int(ray_occ.sum()) == 390
    assert ray_occ[-1] and not ok[390:].any()
    assert calls[1][0].shape == (slots * 32,) and calls[1][1] == 1536


@pytest.mark.parametrize("case", list(CASES))
def test_dropped_probe_points_by_slot_match_jax(world, case):
    """Before the repair both packages raise the flag on the same batch
    and draws, and drop the same occupied probe points: ``CASES`` gives
    how many belong to real rays and how many to spare slots."""
    probe_frac, real, spare = CASES[case]
    cfg, tcfg = _configs(world, probe_frac)
    key = jax.random.PRNGKey(SEED)
    j_in, _, t_in, _ = _batch(world, N_PIX, seed=SEED)
    with recorded(jfield) as j_calls:
        j_out = jax_fused(lambda: jax.jit(lambda tp: jren.render_rays(
            {"frozen": world["frozen"], "train": tp}, world["scene"], j_in,
            key, cfg.model, train=True, iters=1))(world["tp"]),
            fused_agg=False)
        flag = bool(j_out["probe_budget_overflow"])
    with recorded(tfield) as t_calls, spare_slots_probed():
        t_out = _port_render(world, tcfg, t_in,
                             jax_render_draws(key, N_PIX, tcfg.model))
    assert flag and bool(t_out["probe_budget_overflow"])
    assert dropped_points(j_calls) == dropped_points(t_calls) == (real, spare)


@pytest.mark.parametrize("case", list(CASES))
def test_repair_keeps_every_output_and_flags_only_real_drops(world, case):
    """After the repair every output of ``render_rays(train=True)`` is the
    same bits as before it; the flag is False where only spare slots' points
    were dropped and True where a real ray's were, and the probe budget
    then drops no spare slot's point."""
    probe_frac, real, _ = CASES[case]
    _, tcfg = _configs(world, probe_frac)
    _, _, t_in, _ = _batch(world, N_PIX, seed=SEED)
    draws = jax_render_draws(jax.random.PRNGKey(SEED), N_PIX, tcfg.model)
    with spare_slots_probed():
        before = _port_render(world, tcfg, t_in, draws)
    with recorded(tfield) as calls:
        after = _port_render(world, tcfg, t_in, draws)
    assert before.keys() == after.keys()
    for key, v in before.items():
        if key != "probe_budget_overflow":
            assert _same_bits(after[key], v), key
    assert bool(before["probe_budget_overflow"])
    assert bool(after["probe_budget_overflow"]) == (real > 0)
    assert dropped_points(calls) == (real, 0)


def test_repair_keeps_the_loss_and_every_gradient(world):
    """One training step's loss, its parts and the gradient of every
    trained tensor, on the batch where only spare slots' points were
    dropped, are the same bits after the repair; only the
    ``probe_overflow`` metric changes (1 -> 0)."""
    _, tcfg = _configs(world, None)
    loss_fn, sample_batch, _ = ttrainer.make_train_step(
        tcfg, Optimizer(tcfg.train), "cpu")
    views = {k: torch.from_numpy(np.asarray(v)) for k, v in
             world["views"].items()}
    pix = torch.from_numpy(np.random.default_rng(SEED).choice(
        views["uv"].shape[0], N_PIX, replace=False)).long()
    batch = sample_batch(views, None, v=torch.tensor([0]), pix=pix)
    draws = jax_render_draws(jax.random.PRNGKey(SEED), N_PIX, tcfg.model)
    bundle = {"scene": world["t_scene"], "prior": world["prior"],
              "views": views}

    def step():
        tp = _t_params(world["tp"])
        leaves = flatten(tp)
        loss, parts = loss_fn(tp, bundle, batch,
                              torch.zeros((), dtype=torch.int32),
                              draws=draws)
        return loss, parts, torch.autograd.grad(loss, leaves,
                                                allow_unused=True)

    with spare_slots_probed():
        loss0, parts0, grads0 = step()
    loss1, parts1, grads1 = step()
    assert _same_bits(loss1.detach(), loss0.detach())
    for key, v in parts0.items():
        if key != "probe_overflow":
            assert _same_bits(parts1[key].detach(), v.detach()), key
    assert float(parts0["probe_overflow"]) == 1.0
    assert float(parts1["probe_overflow"]) == 0.0
    assert len(grads0) == len(grads1)
    for a, b in zip(grads1, grads0):
        assert (a is None) == (b is None)
        if a is not None:
            assert _same_bits(a, b)


@pytest.mark.parametrize("train,ray_frac", [(False, None), (True, 0.0)])
def test_renders_without_a_ray_budget_take_no_new_path(world, train,
                                                       ray_frac):
    """The eval render and a training render without a ray budget hand
    ``_render_body`` no ``ray_ok``: their probes are what they were."""
    _, tcfg = _configs(world, None)
    if ray_frac is not None:
        tcfg = t_apply_overrides(tcfg, [f"model.ray_budget_frac={ray_frac}"])
    _, _, t_in, _ = _batch(world, N_PIX, seed=SEED)
    seen = []
    body = tren._render_body

    def spy(*a, ray_ok=None, **kw):
        seen.append(ray_ok)
        return body(*a, ray_ok=ray_ok, **kw)

    tren._render_body = spy
    try:
        params = {"frozen": world["prior"],
                  "train": _t_params(world["tp"])}
        with torch.no_grad():
            tren.render_rays(params, world["t_scene"], t_in, tcfg.model,
                             train=train, iters=1,
                             generator=torch.Generator().manual_seed(0))
    finally:
        tren._render_body = body
    assert seen == [None]
