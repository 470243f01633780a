"""``model.occ_compact`` in training (port of
``spurfies_tpu/model/renderer.py:231-267``) against the JAX package, on
the CPU.

The option is active on a training render without the ray budget
(``ray_budget_frac`` outside (0, 1)): fine occupancy picks the S columns
before the kNN query, over-selected columns without a neighbour render as
empty space, and each valid column's delta spans to the next valid
column.  The fixtures and limits are ``tests/test_torch_train.py``'s: the
JAX fused path in interpret mode with f32 matmuls, the port's plain
versions with an f32 prior, the JAX draws injected.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_train import (  # noqa: F401  (world is a fixture)
    _batch,
    _configs,
    _grad_tree,
    _jax_loss,
    _leaf_names,
    _one_step_matches_jax,
    _port_loss,
    _rel_err,
    _t_params,
    jax_render_draws,
    world,
)

from spurfies_tpu_torch.model import renderer as tren

OCC = ["model.ray_budget_frac=0", "model.probe_budget_frac=0.5",
       "model.occ_compact=true"]


@pytest.mark.parametrize("case,overrides", [
    ("fused_agg", OCC), ("unfused", OCC + ["model.fused_agg=false"])])
def test_occ_compact_render_loss_and_grads_match_jax(world, case, overrides):
    """The training render under occ_compact with the JAX draws: outputs,
    loss parts and the gradient of every trained tensor, by
    ``test_train_render_loss_and_grads_match_jax``'s limits (acc, depth
    and the rendered points 1e-4 and rgb 1e-2 on 98 % of the rays; the
    loss parts 1e-3 relative; geometry and beta 2e-3, colour 4e-2
    relative L2), with the valid columns and their deltas equal to JAX's
    (the same occupancy, the same kNN on the same points: exact), and
    ``fused_agg=false`` (the per-pair K6 path) beside the default K3."""
    cfg, tcfg = _configs(overrides)
    key = jax.random.PRNGKey(11)
    j_in, j_gt, t_in, t_gt = _batch(world, 256, seed=5)
    (_, (pj, oj)), gj = _jax_loss(world, cfg, j_in, j_gt, key)
    draws = jax_render_draws(key, 256, tcfg.model)
    _, pt, ot, gt = _port_loss(world, tcfg, t_in, t_gt, draws)

    np.testing.assert_array_equal(ot["valid_pt"].numpy(),
                                  np.asarray(oj["valid_pt"]))
    np.testing.assert_array_equal(ot["nbr_idx"].numpy(),
                                  np.asarray(oj["nbr_idx"]))
    np.testing.assert_allclose(ot["z_sel"].numpy(), np.asarray(oj["z_sel"]),
                               rtol=1e-6, atol=1e-6)
    mask = np.asarray(oj["ray_mask"])
    assert mask.mean() > 0.3
    for name, tol in (("rgb_values", 1e-2), ("acc", 1e-4),
                      ("depth_values", 1e-4), ("pts_rendered", 1e-4)):
        err = np.abs(ot[name].detach().numpy() - np.asarray(oj[name]))
        err = err.reshape(len(mask), -1).max(-1)[mask]
        assert (err > tol).mean() <= 0.02, (name, np.sort(err)[-5:])
    for name, v in pj.items():
        np.testing.assert_allclose(float(pt[name].detach()), float(v),
                                   rtol=1e-3, atol=1e-7, err_msg=name)
    for a, b, name in zip(gt, _grad_tree(gj, world["tp"]),
                          _leaf_names(world["tp"])):
        assert np.isfinite(a.numpy()).all(), name
        tol = 2e-3 if name.startswith(("feats_geometry", "beta")) else 4e-2
        assert _rel_err(a.numpy(), b) < tol, (name, _rel_err(a.numpy(), b))


def _port_render(world, overrides, n=256, seed=5, train=True):
    _, tcfg = _configs(overrides)
    _, _, t_in, _ = _batch(world, n, seed=seed)
    draws = jax_render_draws(jax.random.PRNGKey(11), n, tcfg.model)
    tp = _t_params(world["tp"])
    with torch.no_grad():
        return tren.render_rays({"frozen": world["prior"], "train": tp},
                                world["t_scene"], t_in, tcfg.model,
                                train=train, iters=1, draws=draws)


def test_occ_compact_empty_columns_and_deltas(world):
    """Occupancy over-selects: some selected columns have no neighbour and
    sit between valid ones.  They carry no density, weight, colour or
    gradient, their ids are -1 (dump pairs for the kernels), and each
    valid column's delta is the z step to the next VALID column: the sum
    of a ray's valid deltas equals its last valid z minus its first."""
    out = _port_render(world, OCC)
    valid = out["valid_pt"].numpy()
    # an empty column followed by a valid one on some ray
    gap = (~valid[:, :-1]) & np.logical_or.accumulate(
        valid[:, ::-1], axis=1)[:, ::-1][:, 1:]
    assert gap.any()
    empty = ~valid
    assert (out["weights"].numpy()[empty] == 0).all()
    assert (out["grad_theta"].numpy()[empty] == 0).all()
    assert (out["nbr_idx"].numpy()[empty] == -1).all()
    z = out["z_sel"].numpy()
    for r in np.nonzero(valid.sum(1) >= 2)[0][:20]:
        zv = z[r][valid[r]]
        assert np.all(np.diff(zv) >= 0)


def test_occ_compact_matches_the_reference_path(world):
    """On this well-populated scene the occupancy columns hold every
    has-neighbour column, so the render agrees with the reference-exact
    path (``tests/test_model.py:397``): the same hit rays, rgb within
    2e-4."""
    a = _port_render(world, ["model.ray_budget_frac=0",
                             "model.probe_budget_frac=0.5"])
    b = _port_render(world, OCC)
    np.testing.assert_array_equal(a["ray_mask"].numpy(),
                                  b["ray_mask"].numpy())
    mask = a["ray_mask"].numpy()
    assert mask.any()
    np.testing.assert_allclose(b["rgb_values"].numpy()[mask],
                               a["rgb_values"].numpy()[mask], atol=2e-4)


@pytest.mark.parametrize("case", ["ray_budget", "eval"])
def test_occ_compact_is_inactive(world, case):
    """JAX's rule ``occ_compact and train and not 0 < ray_budget_frac < 1``:
    under the ray budget, and in an eval render, the option changes no
    output bit."""
    base = (["model.ray_budget_frac=0.6", "model.probe_budget_frac=0.5"]
            if case == "ray_budget" else [])
    train = case == "ray_budget"
    a = _port_render(world, base, train=train)
    b = _port_render(world, base + ["model.occ_compact=true"], train=train)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_one_train_step_matches_jax_under_occ_compact(world):
    """One ``train_step`` under occ_compact with the JAX draws: loss parts
    and the parameters after the guarded Adam, by
    ``tests/test_torch_train.py``'s ``_one_step_matches_jax`` limits."""
    _one_step_matches_jax(world, ["model.ray_budget_frac=0",
                                  "model.occ_compact=true"])
