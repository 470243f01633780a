"""The port's ``scripts.validate_pipeline.measure`` against the JAX package's
own script (``scripts/validate_pipeline.py:73-122``), on the CPU.

The JAX script runs through its ``main`` (2 steps, the mesh at 32, the
tiny sampler of ``tests/test_cli_chain.py`` with fewer shaded, coloured
and eval samples as its trailing overrides: both packages render all
128x128 rays of view 0) with its ``Trainer`` recorded.  That trainer's
state -- trained parameters and prior -- goes into the port's ``Trainer``
over the same sphere (``validate_pipeline.build``;
``convert.from_jax.params_from_numpy``), which holds the same points, and
``measure`` reads it at the same resolution.  The port's K1 runs on the
exact variant, which the JAX package's CPU path computes.

Tolerances (the JAX script prints its numbers rounded to 1e-5, the PSNR to
1e-2): the vertex counts equal; the iso level, the median SDF at the cloud,
within 5e-5 (the probe's 1e-4 relative + 1e-5 of
``test_field_matches_jax_plain_xla_path`` on SDF values of ~1e-2, plus the
rounding); the four radius errors and biases within 1e-4 (a vertex moves
by the SDF's error over its unit slope, ~1e-5, plus the rounding); the
masked PSNR within ``tests/test_torch_eval_cli.py``'s render bound without
its PNG term, plus the rounding.
"""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from test_cli_chain import TINY_OVERRIDES

import spurfies_tpu.train.trainer as jtrainer
from spurfies_tpu_torch.convert.from_jax import params_from_numpy
from spurfies_tpu_torch.ops import select_knn as sk
from spurfies_tpu_torch.ops import voxel_grid
from spurfies_tpu_torch.scripts import validate_pipeline

ROOT = Path(__file__).resolve().parent.parent
RES, STEPS = 32, 2
OV = [o for o in TINY_OVERRIDES if o.startswith(("model.", "train.num_pix",
                                                 "train.eval_iters"))] + [
    "model.max_shading_pts=4", "model.color_top_samples=2",
    "model.ray_sampler.n_samples_eval=8",
    "model.ray_sampler.n_samples_extra=2"]


def _exact_k1(*args, packed, **kwargs):
    return sk.select_knn(*args, packed=False, **kwargs)


@pytest.fixture(scope="module")
def measured():
    spec = importlib.util.spec_from_file_location(
        "jax_validate_pipeline", ROOT / "scripts" / "validate_pipeline.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    made = []

    class Recorded(jtrainer.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    mp = pytest.MonkeyPatch()
    out = io.StringIO()
    try:
        mp.setattr(jtrainer, "Trainer", Recorded)
        mp.setattr(sys, "argv", [
            "validate_pipeline.py", "--steps", str(STEPS), "--resolution",
            str(RES), "--prior", str(ROOT / "artifacts" / "local_prior")]
            + OV)
        with contextlib.redirect_stdout(out):
            script.main()
        [jtr] = made
        trainer, views, prior = validate_pipeline.build(OV, device="cpu")
        same = np.array_equal(trainer.scene.points.numpy(),
                              np.asarray(jtr.scene.points))
        trainer.state.params = params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jtr.state.params), "cpu")
        trainer.load_frozen(params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jtr.frozen), "cpu"))
        mp.setattr(voxel_grid, "select_knn", _exact_k1)
        got = validate_pipeline.measure(trainer, views, RES)
    finally:
        mp.undo()
    return {"ref": json.loads(out.getvalue()), "got": got, "same": same,
            "prior": prior}


def test_same_scene_and_prior(measured):
    assert measured["same"]
    assert measured["prior"] == measured["ref"]["prior"] == "pretrained"


def test_mesh_measurements_match_jax(measured):
    got, ref = measured["got"], measured["ref"]
    assert got["mesh_verts"] == ref["mesh_verts"] > 0
    assert got["auto_iso_level"] == pytest.approx(ref["auto_iso_level"],
                                                  rel=0, abs=5e-5)
    for key in ("mesh_mean_radius_err", "mesh_signed_bias",
                "mesh_err_auto_iso", "mesh_bias_auto_iso"):
        assert np.isfinite(got[key])
        assert got[key] == pytest.approx(ref[key], rel=0, abs=1e-4), key


def test_masked_psnr_matches_jax(measured):
    """``tests/test_torch_eval_cli.py::test_nvs_matches_jax``'s bound: rgb
    within 1e-2 on 99 % of the rays (any value on the rest) moves the RMSE
    against the GT by at most d, so |PSNR_t - PSNR_j| <= 20 log10(1 + d /
    RMSE_j); plus JAX's rounding to 1e-2."""
    got, ref = measured["got"]["masked_psnr"], measured["ref"]["masked_psnr"]
    d = np.sqrt(0.99 * 1e-2 ** 2 + 0.01)
    rmse = 10 ** (-ref / 20)
    assert abs(got - ref) <= 20 * np.log10(1 + d / rmse) + 5e-3, (got, ref)
