"""The port's acceptance chain (``scripts.acceptance_chain``) on the CPU,
split as the production run splits it.

At 48x64, with ``tests/test_cli_chain.py``'s tiny sampler (its own step
counts and render/checkpoint cadence left out: the chain sets them) and
fewer shaded, coloured and eval samples (the five 48x64 renders take most
of the run), the
chain runs ``--stop-at 2`` of a 4-step run, then ``--resume``: one
experiment directory, continued from ``latest`` at step 2 to step 4, then
the mesh, the NVS of the first view and of the near views, and Chamfer.
The record holds every key of ``artifacts/acceptance_chain_r05.json``.
"""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_cli_chain import TINY_OVERRIDES

from spurfies_tpu_torch.scripts import acceptance_chain
from spurfies_tpu_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parent.parent
OWN = ("train.opt_steps", "train.render_freq", "train.checkpoint_freq")
OV = [o for o in TINY_OVERRIDES if not o.startswith(OWN)] + [
    "model.max_shading_pts=8", "model.color_top_samples=4",
    "model.ray_sampler.n_samples_eval=16",
    "model.ray_sampler.n_samples_extra=4"]
STEPS, STOP = 4, 2


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Both calls of the split chain; the restores they made."""
    work = tmp_path_factory.mktemp("chain")
    args = ["--steps", str(STEPS), "--img-res", "48", "64",
            "--mesh-resolution", "32", "--max-views", "1", "--workdir",
            str(work), "--out", str(work / "record.json"), "--device", "cpu"]
    mp = pytest.MonkeyPatch()
    restores = []

    def spy(restore):
        def f(self, path):
            restores.append((os.path.realpath(path), int(torch.load(
                path, weights_only=True)["step"])))
            return restore(self, path)
        return f
    try:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        mp.setattr(Trainer, "restore_checkpoint",
                   spy(Trainer.restore_checkpoint))
        stop = acceptance_chain.main(args + ["--stop-at", str(STOP)] + OV)
        wrote_at_stop = os.path.exists(work / "record.json")
        full = acceptance_chain.main(args + ["--resume"] + OV)
    finally:
        mp.undo()
    return {"work": work, "stop": stop, "full": full, "restores": restores,
            "wrote_at_stop": wrote_at_stop}


def test_stop_at_trains_and_stops_before_the_evaluation(chain):
    stop = chain["stop"]
    assert not chain["wrote_at_stop"]
    assert "nvs" not in stop and "chamfer" not in stop
    assert [(c["from"], c["to"]) for c in stop["stages"]["train"]["calls"]] \
        == [(0, STOP)]
    assert stop["overrides"][:10] == acceptance_chain.chain_overrides(
        STEPS, (48, 64))


def test_resume_continues_one_experiment_from_latest(chain):
    work, full = chain["work"], chain["full"]
    exps = os.listdir(work / "exps" / "dtu_pn_scan24")
    assert len(exps) == 1
    assert full["stages"]["train"]["experiment"] == os.path.join(
        "exps", "dtu_pn_scan24", exps[0])
    # cli.train restored the stop's latest at STOP; the evaluations each
    # restored the final latest at STEPS
    latest = os.path.realpath(work / "exps" / "dtu_pn_scan24" / exps[0]
                              / "checkpoints" / "latest")
    assert chain["restores"] == [(latest, STOP), (latest, STEPS),
                                 (latest, STEPS)]
    assert [(c["from"], c["to"]) for c in full["stages"]["train"]["calls"]] \
        == [(0, STOP), (STOP, STEPS)]
    ckpts = sorted(os.listdir(work / "exps" / "dtu_pn_scan24" / exps[0]
                              / "checkpoints"))
    assert ckpts == sorted([str(STOP), str(STEPS), "latest"])


def test_record_holds_the_r05_keys(chain):
    full = chain["full"]
    with open(ROOT / "artifacts" / "acceptance_chain_r05.json") as f:
        r05 = json.load(f)
    for key, val in r05.items():
        assert key in full, key
        if isinstance(val, dict):
            assert set(val) - {"note"} <= set(full[key]), key
    with open(chain["work"] / "record.json") as f:
        assert json.load(f) == full
    assert full["device"] == "cpu" and full["nvidia_smi"] is None
    assert set(full["stages"]) == {"fixture", "train", "evaluate",
                                   "evaluate_near", "chamfer"}
    assert full["total_wall_s"] == pytest.approx(
        sum(s["wall_s"] for s in full["stages"].values()))


def test_record_scores_are_finite(chain):
    full = chain["full"]
    assert full["mesh"]["n_faces"] > 0
    assert len(full["nvs"]["psnr"]) == 1
    assert full["nvs_nearviews"]["eval_ids"] == [23, 24, 26, 27]
    scores = (full["nvs"]["psnr"] + full["nvs"]["ssim"]
              + full["nvs_nearviews"]["psnr"] + full["nvs_nearviews"]["ssim"]
              + [full["chamfer"][k] for k in ("acc", "comp", "overall")])
    assert np.all(np.isfinite(scores))
    pb = full["probe_budget"]
    assert 0 < pb["occupied"] <= pb["points"] and 0 < pb["share"] <= 1


def test_chain_budget_reproduces_the_record(chain, tmp_path):
    """``chip_chain_budget.py`` on the finished run: its budgeted mesh is
    the record's (faces, Chamfer to 1e-6, the points dropped), and the mesh
    without the budget is scored too."""
    spec = importlib.util.spec_from_file_location(
        "chip_chain_budget", ROOT / "chip_chain_budget.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = tmp_path / "budget.json"
    assert script.main(["--workdir", str(chain["work"]), "--record",
                        str(chain["work"] / "record.json"), "--out",
                        str(out), "--device", "cpu"]) == 0
    res, full = json.loads(out.read_text()), chain["full"]
    assert res["step"] == STEPS and res["resolution"] == 32
    assert res["budget_0.25"]["n_faces"] == full["mesh"]["n_faces"]
    assert (res["budget_0.25"]["occupied_dropped"]
            == full["probe_budget"]["occupied_dropped"])
    assert res["budget_None"]["occupied_dropped"] == 0
    assert res["budget_None"]["n_faces"] > 0
    assert np.all(np.isfinite([res["budget_None"]["chamfer"][k]
                               for k in ("acc", "comp", "overall")]))


def test_chain_refuses_a_used_workdir_without_resume(chain):
    with pytest.raises(FileExistsError):
        acceptance_chain.main(["--workdir", str(chain["work"]), "--device",
                               "cpu"])


@pytest.mark.parametrize("message, ok", [
    (acceptance_chain.REPO_PRIOR, True),
    ("loaded frozen local-geometry prior (pretrained here)", False),
    ("loaded frozen local-geometry prior (torch ckpt)", False),
    ("no local prior found (ckpt/local_prior.pt or x) — frozen SDF decoder "
     "is randomly initialized", False)])
def test_chain_fails_on_any_other_prior(tmp_path, monkeypatch, message, ok):
    """cli.train loads the reference's torch checkpoint or a prior
    pretrained here when the work directory holds one, and warns when it
    finds none: the chain goes on only with the repo's own prior (here
    into the fake CLI's missing trainer)."""
    from spurfies_tpu_torch.cli import train as cli_train
    from spurfies_tpu_torch.utils.experiment import get_logger

    def fake_main(argv):
        get_logger().info(message)
        return [(None, None)]
    monkeypatch.setattr(cli_train, "main", fake_main)
    with pytest.raises(AttributeError if ok else RuntimeError):
        acceptance_chain.main(["--img-res", "48", "64", "--workdir",
                               str(tmp_path), "--device", "cpu"])
