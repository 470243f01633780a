"""The port's training CLI and the modules it loads, on the CPU.

* ``config.parse_yaml`` against ``yaml.safe_load`` on every file in
  ``configs/`` and on the scalars of YAML 1.1; ``load_yaml`` +
  ``apply_overrides`` equal to the JAX package's ``Config``;
* ``eval.plots.triptych`` within 1e-6 of JAX's (matplotlib's turbo map);
* ``convert_local_prior`` on a state dict with the reference's keys equal
  to the JAX converter's weights;
* the experiment directory, the metric writer without TensorBoard;
* ``cli.train.main`` with ``--device cpu`` on the tiny DTU fixture of
  ``tests/test_cli_chain.py``: 20 steps rendering and saving every 10, then
  ``--resume`` to 30; the same beside the JAX package's CLI (rows,
  checkpoints, run.json, prior, validation pixels and PSNR); and its
  refusal to train a DTU scene without the local loss when
  ``ckpt/vismvsnet.pt`` is there.
"""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from test_cli_chain import TINY_OVERRIDES

from spurfies_tpu.config import apply_overrides as j_apply_overrides
from spurfies_tpu.config import load_yaml as j_load_yaml
from spurfies_tpu.convert import torch2jax
from spurfies_tpu.eval import plots as jplots
from spurfies_tpu_torch.cli import train as cli_train
from spurfies_tpu_torch.config import Config as TConfig
from spurfies_tpu_torch.config import DataConfig as TDataConfig
from spurfies_tpu_torch.config import apply_overrides, load_yaml, parse_yaml
from spurfies_tpu_torch.convert.from_jax import params_from_numpy
from spurfies_tpu_torch.convert.torch_ckpt import convert_local_prior
from spurfies_tpu_torch.data.synthetic import export_synthetic_dtu
from spurfies_tpu_torch.eval import plots
from spurfies_tpu_torch.utils.experiment import ExperimentDir, MetricWriter

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted((ROOT / "configs").glob("*.yaml"))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_yaml_reader_matches_pyyaml_on_the_configs(path):
    text = path.read_text()
    assert parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: 5.0e-4", "a: 5e-4", "a: 1.", "a: .5", "a: -.5", "a: +12",
    "a: 1_000", "a: -0", "a: .inf", "a: -.Inf", "a: yes", "a: No",
    "a: on", "a: TRUE", "a: ~", "a: null", "a:", "a: '24'", 'a: "x\\"y"',
    "a: 'it''s'", "a: [576, 768]", "a: [1, [2, 3], x, 'y', 2.5]",
    "a: []", "a: [a,]", "a: foo bar  # note", "a: x#y", "a: 'a#b' # c",
    "# head\na:\n  b:\n    c: 1\n\n  d: 2   # two\ne: 3\n", "",
])
def test_yaml_reader_matches_pyyaml_on_scalars(text):
    assert parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: 0x10", "a: 010", "a: 1:30", "a: 2024-01-01", "a: &x 1", "a: *x",
    "a: !!str 1", "a: {b: 1}", "- a", "a: |", "a: [1, 2", "a: 'x' y",
    "a:b", "a:\n\tb: 1", "a: 1\n  b: 2", "---\na: 1", "a: - b",
])
def test_yaml_reader_raises_outside_its_subset(text):
    with pytest.raises(ValueError, match="subset"):
        parse_yaml(text)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_load_yaml_and_overrides_match_jax(path):
    """The port's Config and the JAX package's, as dicts, from each config
    file alone and with ``tests/test_cli_chain.py``'s overrides."""
    for ov in ([], TINY_OVERRIDES):
        got = apply_overrides(load_yaml(str(path)), ov)
        ref = j_apply_overrides(j_load_yaml(str(path)), ov)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_triptych_matches_jax():
    rng = np.random.default_rng(0)
    h, w = 36, 48
    rgb = rng.uniform(-0.1, 1.1, (h, w, 3)).astype(np.float32)
    depth = rng.uniform(0.5, 4.0, (h, w)).astype(np.float32)
    normal = rng.normal(size=(h, w, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    for g in (gt, None):
        got = plots.triptych(rgb, depth, normal, gt=g)
        ref = jplots.triptych(rgb, depth, normal, gt=g)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    acc = rng.uniform(0, 1, (h, w))
    np.testing.assert_allclose(plots.visualize_depth(depth, acc),
                               jplots.visualize_depth(depth, acc),
                               rtol=0, atol=1e-6)


def _torch_prior():
    """A local-prior state dict with the reference's key scheme
    (train.py:124-139), as ``tests/test_convert.py`` builds it."""
    torch.manual_seed(0)
    seq = torch.nn.Sequential(
        torch.nn.Linear(35, 256), torch.nn.LeakyReLU(),
        torch.nn.Linear(256, 256), torch.nn.LeakyReLU(),
        torch.nn.Linear(256, 256), torch.nn.LeakyReLU(),
        torch.nn.Linear(256, 256), torch.nn.LeakyReLU(),
        torch.nn.Linear(256, 256))
    t = torch.nn.Linear(256, 1)
    sd = {"sdf_features": torch.zeros(10)}
    for i in (0, 2, 4, 6, 8):
        sd[f"module.decoder.local_sdf_field.{i}.weight"] = seq[i].weight
        sd[f"module.decoder.local_sdf_field.{i}.bias"] = seq[i].bias
    sd["density_branch.weight"] = t.weight
    sd["density_branch.bias"] = t.bias
    return sd


@pytest.mark.parametrize("wrapped", [True, False], ids=["ckpt", "bare"])
def test_convert_local_prior_matches_jax(wrapped):
    sd = _torch_prior()
    state = {"model_state_dict": sd} if wrapped else sd
    got = convert_local_prior(state, device="cpu")
    ref = params_from_numpy(
        {k: [{kk: np.asarray(a) for kk, a in layer.items()} for layer in v]
         for k, v in torch2jax.convert_local_prior(state).items()},
        device="cpu")
    assert [len(got[k]) for k in ("F_geometry", "T")] == [5, 1]
    for k in ("F_geometry", "T"):
        for a, b in zip(got[k], ref[k]):
            for kk in ("w", "b"):
                assert a[kk].dtype == b[kk].dtype == torch.float32
                assert torch.equal(a[kk], b[kk])
    assert got["F_geometry"][0]["w"].shape == (35, 256)


def test_experiment_dir_layout_and_latest(tmp_path):
    root = str(tmp_path)
    assert ExperimentDir.latest(root, "dtu_pn", "scan24") is None
    old = ExperimentDir(root, "dtu_pn", "scan24", timestamp="2026_01_01")
    new = ExperimentDir(root, "dtu_pn", "scan24", timestamp="2026_02_01")
    for d in (old, new):
        assert os.path.isdir(d.ckpt_dir) and os.path.isdir(d.plots_dir)
    # the latest timestamp that holds a checkpoint
    open(old.checkpoint_path("latest"), "w").close()
    assert ExperimentDir.latest(root, "dtu_pn", "scan24").dir == old.dir
    open(new.checkpoint_path(10), "w").close()
    assert ExperimentDir.latest(root, "dtu_pn", "scan24").dir == new.dir
    assert new.checkpoint_path(10) == os.path.abspath(
        os.path.join(root, "dtu_pn_scan24", "2026_02_01", "checkpoints", "10"))
    new.save_config(TConfig())
    with open(os.path.join(new.dir, "run.json")) as f:
        assert json.load(f)["expname"] == TConfig().expname


@pytest.fixture
def no_tensorboard(monkeypatch):
    """The card's machine has no ``tensorboard``: the writer keeps JSONL."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def test_metric_writer_without_tensorboard(tmp_path, no_tensorboard):
    w = MetricWriter(str(tmp_path / "logs"))
    assert w.tb is None
    w.scalars(3, {"loss": np.float32(0.5)})
    w.scalars(3, {"psnr": 21.0}, prefix="val")
    w.image(3, "val/triptych", np.zeros((2, 2, 3), np.float32))
    w.close()
    rows = [json.loads(ln) for ln in
            open(tmp_path / "logs" / "metrics.jsonl")]
    assert rows == [{"step": 3, "loss": 0.5}, {"step": 3, "psnr": 21.0}]


CLI_ARGS = ["--scans", "scan24", "--device", "cpu"] + TINY_OVERRIDES


@pytest.fixture(scope="module")
def dtu_fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    export_synthetic_dtu(str(root / "data"), scan_id=24, n_views=49,
                         img_res=(48, 64), n_points=2000)
    return root


def test_cli_trains_and_resumes_on_the_cpu(dtu_fixture, tmp_path,
                                           monkeypatch, no_tensorboard):
    monkeypatch.chdir(tmp_path)
    args = CLI_ARGS + [f"dataset.data_dir_root={dtu_fixture / 'data'}",
                       "train.render_freq=10", "train.checkpoint_freq=10"]
    [(trainer, exp)] = cli_train.main(args + ["train.opt_steps=20"])
    assert int(trainer.state.step) == 20
    assert trainer.scene.points.device.type == "cpu"
    saved = torch.load(exp.checkpoint_path("latest"), weights_only=True)
    assert saved["step"] == 20

    restored = {}
    real_restore = cli_train.Trainer.restore_checkpoint

    def spy(self, path):
        real_restore(self, path)
        restored["step"] = int(self.state.step)
        restored["params"] = {k: (v.detach().clone() if torch.is_tensor(v)
                                  else [{kk: t.detach().clone()
                                         for kk, t in layer.items()}
                                        for layer in v])
                              for k, v in self.state.params.items()}

    monkeypatch.setattr(cli_train.Trainer, "restore_checkpoint", spy)
    [(resumed, exp2)] = cli_train.main(["--resume"] + args
                                       + ["train.opt_steps=30"])
    assert exp2.dir == exp.dir and int(resumed.state.step) == 30
    # the restored state is the saved one, bit for bit, before any step
    assert restored["step"] == 20
    for k, v in saved["params"].items():
        if torch.is_tensor(v):
            assert torch.equal(restored["params"][k], v), k
        else:
            for a, b in zip(restored["params"][k], v):
                for kk in b:
                    assert torch.equal(a[kk], b[kk]), k

    rows = [json.loads(ln) for ln in
            open(os.path.join(exp.plots_dir, "logs", "metrics.jsonl"))]
    train_rows = [r for r in rows if "rgb_loss" in r]
    val_rows = [r for r in rows if "psnr" in r and "rgb_loss" not in r]
    assert [r["step"] for r in train_rows] == [10, 20, 30]
    assert [r["step"] for r in val_rows] == [10, 20, 30]
    assert all(np.isfinite(r["loss"]) for r in train_rows)
    assert all(np.isfinite(r["psnr"]) for r in val_rows)
    assert train_rows[-1]["rgb_loss"] < train_rows[0]["rgb_loss"]
    assert sorted(os.listdir(exp.ckpt_dir)) == ["10", "20", "30", "latest"]
    with open(os.path.join(exp.dir, "run.json")) as f:
        assert json.load(f)["train"]["opt_steps"] == 30


def _params_np(tree):
    """A params or frozen tree (either package) as numpy leaves, in order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, (list, tuple)):
            out += [np.asarray(layer[kk].detach().cpu() if torch.is_tensor(
                layer[kk]) else layer[kk]) for layer in v for kk in ("w", "b")]
        else:
            out.append(np.asarray(v.detach().cpu() if torch.is_tensor(v)
                                  else v))
    return out


def test_cli_matches_jax_train_scene(dtu_fixture, tmp_path, monkeypatch,
                                     no_tensorboard):
    """The JAX package's CLI and the port's on the same fixture and
    overrides, 20 steps rendering and saving every 10, then ``--resume`` to
    30, each in a directory of its own that holds the repo's ``artifacts``.
    Equal: the metrics.jsonl rows (steps and keys, train and val), the
    checkpoint names, run.json, the frozen prior, the validation pixels
    (``uv`` of each render, bit-equal), and the validation PSNR of the
    same render: the port's render call returns JAX's render of that step,
    so the port's logged PSNR must be JAX's to 1e-5 dB (JAX takes the
    squared error in its own float32 ops) -- which holds the 1/4-resolution
    ``val_gt`` and ``val_mask`` and the PSNR formula.  The two runs' own
    PSNRs are not compared: each trainer draws its rays and initialises its
    fields from its own generator (JAX's PRNG keys, torch's), so after 10
    steps they are two different fits of the scene."""
    from spurfies_tpu.cli import train as j_train
    from spurfies_tpu.train.trainer import Trainer as JTrainer

    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    args = ["--scans", "scan24"] + TINY_OVERRIDES + [
        f"dataset.data_dir_root={dtu_fixture / 'data'}", "exps_folder=exps",
        "train.render_freq=10", "train.checkpoint_freq=10"]
    runs = {"jax": {"uv": [], "out": [], "trainer": None},
            "torch": {"uv": [], "real": []}}
    j_render = JTrainer.render_image

    def jax_spy(self, tp, uv, pose, intrinsics, key):
        out = j_render(self, tp, uv, pose, intrinsics, key)
        runs["jax"]["uv"].append(np.array(uv))
        runs["jax"]["out"].append({k: np.array(v) for k, v in out.items()})
        runs["jax"]["trainer"] = self
        return out

    t_render = cli_train.Trainer.render_image

    def torch_spy(self, uv, pose, intrinsics):
        real = t_render(self, uv, pose, intrinsics)
        i = len(runs["torch"]["uv"])
        runs["torch"]["uv"].append(np.array(uv))
        runs["torch"]["real"].append(real)
        return runs["jax"]["out"][i]

    monkeypatch.setattr(JTrainer, "render_image", jax_spy)
    monkeypatch.setattr(cli_train.Trainer, "render_image", torch_spy)
    dirs = {}
    for name, main in (("jax", j_train.main), ("torch", cli_train.main)):
        d = tmp_path / name
        d.mkdir()
        (d / "artifacts").symlink_to(ROOT / "artifacts")
        monkeypatch.chdir(d)
        extra = ["--device", "cpu"] if name == "torch" else []
        main(extra + args + ["train.opt_steps=20"])
        got = main(["--resume"] + extra + args + ["train.opt_steps=30"])
        if name == "torch":
            [(runs["torch"]["trainer"], _)] = got
        [stamp] = os.listdir(d / "exps" / "dtu_pn_scan24")
        dirs[name] = d / "exps" / "dtu_pn_scan24" / stamp

    rows = {}
    for name, d in dirs.items():
        with open(d / "plots" / "logs" / "metrics.jsonl") as f:
            rows[name] = [json.loads(ln) for ln in f]
    assert ([(r["step"], sorted(r)) for r in rows["torch"]]
            == [(r["step"], sorted(r)) for r in rows["jax"]])
    val = {name: [r["psnr"] for r in rs if "rgb_loss" not in r]
           for name, rs in rows.items()}
    assert len(val["jax"]) == 3
    np.testing.assert_allclose(val["torch"], val["jax"], rtol=0, atol=1e-5)
    assert (sorted(os.listdir(dirs["torch"] / "checkpoints"))
            == sorted(os.listdir(dirs["jax"] / "checkpoints"))
            == ["10", "20", "30", "latest"])
    with open(dirs["torch"] / "run.json") as f, \
            open(dirs["jax"] / "run.json") as g:
        assert json.load(f) == json.load(g)

    assert len(runs["torch"]["uv"]) == len(runs["jax"]["uv"]) == 3
    for a, b in zip(runs["torch"]["uv"], runs["jax"]["uv"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for real, ref in zip(runs["torch"]["real"], runs["jax"]["out"]):
        for k in ("rgb_values", "depth_values", "normal_map"):
            assert real[k].shape == ref[k].shape, k
            assert np.isfinite(real[k]).all(), k
    for a, b in zip(_params_np(runs["torch"]["trainer"].frozen),
                    _params_np(runs["jax"]["trainer"].frozen)):
        assert a.shape == b.shape and np.array_equal(a, b)


def test_cli_prefers_the_reference_prior_checkpoint(dtu_fixture, tmp_path,
                                                    monkeypatch,
                                                    no_tensorboard):
    """With ``ckpt/local_prior.pt`` there, the frozen prior is its
    conversion (the JAX CLI's order: reference checkpoint, repo prior)."""
    monkeypatch.chdir(tmp_path)
    os.makedirs("ckpt")
    torch.save({"model_state_dict": _torch_prior()}, "ckpt/local_prior.pt")
    [(trainer, _)] = cli_train.main(
        CLI_ARGS + [f"dataset.data_dir_root={dtu_fixture / 'data'}",
                    "train.opt_steps=0"])
    want = convert_local_prior("ckpt/local_prior.pt", device="cpu")
    for k in ("F_geometry", "T"):
        for a, b in zip(trainer.frozen[k], want[k]):
            assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])


def test_cli_raises_without_the_local_loss(dtu_fixture, tmp_path,
                                           monkeypatch):
    """A DTU scene with ``ckpt/vismvsnet.pt`` present and
    ``loss.local_weight > 0`` asks for the local loss: the CLI reads the
    checkpoint and builds the bundle before it builds a Trainer, so an
    unreadable (empty) checkpoint raises instead of training without the
    loss.  (With a readable one it trains with the loss:
    ``tests/test_torch_local_loss.py``.)"""
    monkeypatch.chdir(tmp_path)
    os.makedirs("ckpt")
    open("ckpt/vismvsnet.pt", "wb").close()
    built = []
    monkeypatch.setattr(cli_train, "Trainer",
                        lambda *a, **k: built.append(a))
    with pytest.raises(EOFError):
        cli_train.main(CLI_ARGS + [
            f"dataset.data_dir_root={dtu_fixture / 'data'}",
            "loss.local_weight=0.5"])
    assert not built


def test_scene_overrides_match_jax():
    from spurfies_tpu.cli.train import apply_scene_overrides as j_over
    from spurfies_tpu.config import Config, DataConfig

    for data_dir, scan in (("mipnerf", "garden"), ("mipnerf", "stump"),
                           ("dtu", "scan24")):
        got = cli_train.apply_scene_overrides(
            TConfig(dataset=TDataConfig(data_dir=data_dir)), scan)
        ref = j_over(Config(dataset=DataConfig(data_dir=data_dir)), scan)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
