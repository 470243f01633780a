"""The port's ``scripts.run_100k`` and ``scripts.vis_scene`` against the JAX
package's scripts (``scripts/run_100k.py``, ``scripts/vis_scene.py``), on
the CPU.

* ``evaluate``: the JAX script's ``evaluate`` (imported by path) on a JAX
  ``Trainer`` over a 48x64 dust3r-like sphere with the tiny sampler of
  ``tests/test_cli_chain.py``, trained 2 steps; its parameters and prior
  go into the port's ``Trainer`` over the same cloud
  (``convert.from_jax.params_from_numpy``), and the port's ``evaluate``
  reads it at the same mesh resolution (32).  The port's K1 runs on the
  exact variant, which the JAX package's CPU path computes.  Tolerances
  (both scripts round to 1e-5, the PSNRs to 1e-2): the iso level within
  5e-5 and the radius errors and biases within 1e-4, as
  ``tests/test_torch_scripts_validate.py`` holds ``validate_pipeline``;
  every masked ray of both renders of view 0 (the trained beta and beta
  0.003) within ``RENDER_TOL`` = 1e-2 of JAX's (measured 3.4e-3); both
  PSNRs within the bound that the renders' RMS gap gives, plus the
  rounding; and the PSNR's shift under beta 0.003 (0.85 dB here) within
  twice that bound plus 2e-2 of JAX's.
* ``main`` at 6 steps in windows of 1, killed at 2, split by ``--stop-at
  4`` and ``--resume``: the record's keys, its windows' and its evals'
  keys are ``artifacts/run100k_default.json``'s (the evals also carry the
  newer ``masked_psnr_beta3e3``), and its events are the JAX script's
  events for the same run stopped at 4 and resumed (the JAX script's
  ``main`` run with its Trainer and evaluation stubbed, which is all of
  its bookkeeping).
* ``vis_scene.main`` of both packages on an own-data scene of the
  committed JPEG views (``tests/fixtures/jpeg``): the same PLY, byte for
  byte.
"""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import contextlib
import functools
import importlib.util
import io
import json
import os
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_cli_chain import TINY_OVERRIDES
from test_torch_jpeg import FIXTURES, SCENE, VIEWS

import spurfies_tpu.data.synthetic as jsyn
from spurfies_tpu.config import Config as JConfig
from spurfies_tpu.config import ModelConfig as JModelConfig
from spurfies_tpu.config import TrainConfig as JTrainConfig
from spurfies_tpu.config import apply_overrides as japply
from spurfies_tpu.prior.pretrain import load_prior
from spurfies_tpu.train.trainer import Trainer as JTrainer
from spurfies_tpu_torch.config import Config, ModelConfig, TrainConfig
from spurfies_tpu_torch.config import apply_overrides
from spurfies_tpu_torch.convert.from_jax import PRIOR_ASSET, params_from_numpy
from spurfies_tpu_torch.data import synthetic as tsyn
from spurfies_tpu_torch.ops import select_knn as sk
from spurfies_tpu_torch.ops import voxel_grid
from spurfies_tpu_torch.scripts import run_100k, vis_scene

ROOT = Path(__file__).resolve().parent.parent
RES, IMG, STEPS = 32, (48, 64), 2
RENDER_TOL = 1e-2
OV = [o for o in TINY_OVERRIDES if o.startswith(("model.", "train.num_pix",
                                                 "train.eval_iters"))] + [
    "model.max_shading_pts=4", "model.color_top_samples=2",
    "model.ray_sampler.n_samples_eval=8",
    "model.ray_sampler.n_samples_extra=2"]


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _exact_k1(*args, packed, **kwargs):
    return sk.select_knn(*args, packed=False, **kwargs)


@pytest.fixture(scope="module")
def evaluated():
    script = _script("run_100k")
    pts, cols, views = jsyn.make_dust3r_like_scene(img_res=IMG, radius=0.8)
    jcfg = japply(JConfig(model=JModelConfig(),
                          train=JTrainConfig(num_pixels=1024, fast_iters=1)),
                  OV)
    jtr = JTrainer(jcfg, pts, cols, views)
    jtr.load_frozen(load_prior(str(ROOT / "artifacts" / "local_prior")))
    jtr.run(STEPS, window=STEPS)
    ref = script.evaluate(jtr, jtr.cfg, 0.8, resolution=RES)

    cfg = apply_overrides(Config(model=ModelConfig(), train=TrainConfig(
        num_pixels=1024, fast_iters=1)), OV)
    tpts, tcols, tviews = tsyn.make_dust3r_like_scene(img_res=IMG,
                                                      radius=0.8)
    same_inputs = all(np.array_equal(a, b) for a, b in (
        (pts, tpts), (cols, tcols), *((views[k], tviews[k]) for k in views)))
    trainer = run_100k.build_trainer(cfg, tpts, tcols, tviews, str(PRIOR_ASSET),
                                     torch.device("cpu"))
    same = np.array_equal(trainer.scene.points.numpy(),
                          np.asarray(jtr.scene.points))
    trainer.state.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jtr.state.params), "cpu")
    trainer.load_frozen(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jtr.frozen), "cpu"))
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(voxel_grid, "select_knn", _exact_k1)
        got = run_100k.evaluate(trainer, 0.8, resolution=RES)
        rgb, rgb_diag, gt, mask = run_100k.view0_renders(trainer)
    finally:
        mp.undo()
    # the JAX script's two renders of view 0, as its evaluate makes them
    jp = dict(jtr.state.params)
    jp_diag = dict(jp, beta=jnp.asarray(0.003, jnp.float32))
    jrgb, jrgb_diag = (np.asarray(jtr.render_image(
        p, np.asarray(jtr.views["uv"]), jtr.views["pose"][0],
        jtr.views["intrinsics"][0], jax.random.PRNGKey(0))["rgb_values"])
        for p in (jp, jp_diag))
    renders = {"masked_psnr": (np.asarray(rgb), jrgb),
               "masked_psnr_beta3e3": (np.asarray(rgb_diag), jrgb_diag)}
    return {"ref": ref, "got": got, "same": same_inputs and same,
            "renders": renders, "gt": gt, "mask": mask}


def test_same_scene(evaluated):
    assert evaluated["same"]


def test_evaluate_keys_match_jax(evaluated):
    assert list(evaluated["got"]) == list(evaluated["ref"])


def test_mesh_evaluation_matches_jax(evaluated):
    got, ref = evaluated["got"], evaluated["ref"]
    assert got["iso_level"] == pytest.approx(ref["iso_level"], rel=0,
                                             abs=5e-5)
    for key in ("mesh_err", "mesh_bias", "mesh_err_auto_iso",
                "mesh_bias_auto_iso"):
        assert ref[key] is not None and np.isfinite(got[key])
        assert got[key] == pytest.approx(ref[key], rel=0, abs=1e-4), key


PSNR_KEYS = ["masked_psnr", "masked_psnr_beta3e3"]


@pytest.mark.parametrize("key", PSNR_KEYS)
def test_render_matches_jax(evaluated, key):
    """Each masked ray's colour within ``RENDER_TOL`` of the JAX script's
    render of it."""
    rgb, jrgb = evaluated["renders"][key]
    mask = evaluated["mask"]
    gap = np.abs(rgb[mask] - jrgb[mask]).max()
    assert gap <= RENDER_TOL, gap


@pytest.mark.parametrize("key", PSNR_KEYS)
def test_masked_psnr_matches_jax(evaluated, key):
    """The port's PSNR is that of its render, and differs from the JAX
    script's by no more than the renders' gap explains: with g the RMS of
    the masked rays' colour gap, |RMSE_t - RMSE_j| <= g, so |PSNR_t -
    PSNR_j| <= -20 log10(1 - g / RMSE_j); plus both scripts' rounding to
    1e-2."""
    got, ref = evaluated["got"][key], evaluated["ref"][key]
    rgb, jrgb = evaluated["renders"][key]
    gt, mask = evaluated["gt"], evaluated["mask"]
    assert run_100k._masked_psnr(rgb, gt, mask) == got
    g = np.sqrt(np.mean((rgb[mask] - jrgb[mask]) ** 2))
    rmse = np.sqrt(np.mean((jrgb[mask] - gt[mask]) ** 2))
    assert g < rmse
    assert abs(got - ref) <= -20 * np.log10(1 - g / rmse) + 1e-2, (got, ref)


def test_beta_diagnostic_shift_matches_jax(evaluated):
    """What setting ``beta`` to 0.003 does to the PSNR, in both packages:
    the two shifts within 2e-2 (four values rounded to 1e-2) plus twice
    the largest render-gap bound of ``test_masked_psnr_matches_jax``."""
    got, ref = evaluated["got"], evaluated["ref"]
    gt, mask = evaluated["gt"], evaluated["mask"]
    bound = 0.0
    for rgb, jrgb in evaluated["renders"].values():
        g = np.sqrt(np.mean((rgb[mask] - jrgb[mask]) ** 2))
        rmse = np.sqrt(np.mean((jrgb[mask] - gt[mask]) ** 2))
        bound = max(bound, -20 * np.log10(1 - g / rmse))
    shift_t = got["masked_psnr_beta3e3"] - got["masked_psnr"]
    shift_j = ref["masked_psnr_beta3e3"] - ref["masked_psnr"]
    assert abs(shift_j) > 2e-2 + 2 * bound, (shift_j, bound)
    assert abs(shift_t - shift_j) <= 2e-2 + 2 * bound, (shift_t, shift_j)


# ---- main: the split run against the JAX script's bookkeeping ----------
FLAGS = ["--steps", "6", "--window", "1", "--kill-at", "2", "--eval-at",
         "3", "6"]


class _StubTrainer:
    """What the JAX script's ``main`` reads of a Trainer, with a step that
    counts and a checkpoint that is a directory named for its step."""

    def __init__(self, cfg, *_):
        self.cfg = cfg
        self.state = SimpleNamespace(step=0, params={"beta": 0.1})

    def run(self, n, window, callback):
        self.state.step += n
        callback(self.state.step, {"loss": 1.0})

    def save_checkpoint(self, path):
        os.makedirs(path, exist_ok=True)

    def restore_checkpoint(self, path):
        self.state.step = int(os.path.basename(path).split("_")[1])


def _jax_events(tmp):
    script = _script("run_100k")
    mp = pytest.MonkeyPatch()
    out = os.path.join(tmp, "jax.json")
    base = ["run_100k.py", "--window", "1", "--kill-at", "2",
            "--eval-at", "3", "6", "--ckpt-dir", os.path.join(tmp, "jck"),
            "--out", out, "train.checkpoint_freq=2"]
    try:
        mp.setattr(script, "build_trainer", _StubTrainer)
        mp.setattr(script, "evaluate", lambda *a, **k: {})
        with contextlib.redirect_stdout(io.StringIO()):
            for extra in (["--steps", "4"], ["--steps", "6", "--resume"]):
                mp.setattr(sys, "argv", base + extra)
                script.main()
    finally:
        mp.undo()
    with open(out) as f:
        return json.load(f)["events"]


@pytest.fixture(scope="module")
def split_run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("run100k"))
    args = FLAGS + ["--device", "cpu", "--ckpt-dir",
                    os.path.join(tmp, "ck"), "--out",
                    os.path.join(tmp, "record.json")]
    ov = OV + ["train.checkpoint_freq=2"]
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(run_100k, "make_dust3r_like_scene", functools.partial(
            tsyn.make_dust3r_like_scene, img_res=IMG))
        mp.setattr(run_100k, "evaluate", functools.partial(
            run_100k.evaluate, resolution=RES))
        with contextlib.redirect_stdout(io.StringIO()):
            stop = run_100k.main(args + ["--stop-at", "4"] + ov)
            stop = json.loads(json.dumps(stop))
            full = run_100k.main(args + ["--resume"] + ov)
    finally:
        mp.undo()
    with open(os.path.join(tmp, "record.json")) as f:
        written = json.load(f)
    return {"stop": stop, "full": full, "written": written,
            "ckpts": sorted(os.listdir(os.path.join(tmp, "ck"))),
            "jax_events": _jax_events(tmp)}


def test_stop_at_stops_with_a_checkpoint(split_run):
    stop = split_run["stop"]
    assert [w["step"] for w in stop["windows"]] == [1, 2, 3, 4]
    assert list(stop["evals"]) == ["3"]
    assert stop["events"][-1] == {"step": 4, "event": "checkpoint"}


def test_resumed_record_holds_the_jax_records_keys(split_run):
    with open(ROOT / "artifacts" / "run100k_default.json") as f:
        ref = json.load(f)
    full = split_run["full"]
    assert full == split_run["written"]
    assert sorted(full) == sorted(ref)
    assert [list(w) for w in full["windows"]] == [list(ref["windows"][0])
                                                  ] * 6
    assert [w["step"] for w in full["windows"]] == list(range(1, 7))
    ref_eval = list(ref["evals"]["30000"])
    assert list(full["evals"]) == ["3", "6"]
    for ev in full["evals"].values():
        assert list(ev) == ref_eval[:4] + ["iso_level", "masked_psnr",
                                            "masked_psnr_beta3e3"]
        assert all(np.isfinite(v) for v in ev.values())
    assert split_run["ckpts"] == ["step_2", "step_4", "step_6"]


def test_events_follow_the_jax_script(split_run):
    events = split_run["full"]["events"]
    assert events == split_run["jax_events"]
    assert [e["event"] for e in events] == [
        "checkpoint", "kill+resume from 2", "checkpoint",
        "host-resume from 4", "checkpoint"]


def test_missing_prior_raises(tmp_path, monkeypatch):
    """A ``--prior`` that names no file stops the run before it trains or
    writes anything (the JAX script would train on a random prior)."""
    monkeypatch.setattr(run_100k, "make_dust3r_like_scene", functools.partial(
        tsyn.make_dust3r_like_scene, img_res=IMG))
    out = tmp_path / "record.json"
    with pytest.raises(FileNotFoundError, match="no_prior.npz"):
        run_100k.main(FLAGS + ["--device", "cpu", "--prior",
                               str(tmp_path / "no_prior.npz"), "--ckpt-dir",
                               str(tmp_path / "ck"), "--out", str(out)] + OV)
    assert not out.exists() and not (tmp_path / "ck").exists()


# ---- vis_scene on the JPEG own-data scene --------------------------------
def test_vis_scene_matches_jax(tmp_path):
    root = tmp_path / "data"
    tsyn.export_synthetic_own_data(str(root), scan=SCENE["scan"],
                                   n_views=SCENE["n_views"],
                                   img_res=tuple(SCENE["img_res"]),
                                   seed=SCENE["seed"])
    image_dir = root / "own_data" / SCENE["scan"] / "image"
    shutil.rmtree(image_dir)
    image_dir.mkdir()
    for name in VIEWS:
        shutil.copy(FIXTURES / name, image_dir / name)
    outs = {}
    for tag, main in (("port", vis_scene.main),
                      ("jax", _script("vis_scene").main)):
        outs[tag] = str(tmp_path / f"{tag}.ply")
        with contextlib.redirect_stdout(io.StringIO()):
            main(["--scan", SCENE["scan"], "--data-root", str(root),
                  "--out", outs[tag]])
    port, ref = (Path(outs[t]).read_bytes() for t in ("port", "jax"))
    assert len(port) > 4000 * 15 and port == ref
