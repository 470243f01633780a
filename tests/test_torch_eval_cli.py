"""The port's evaluation CLIs against the JAX package's, on the CPU.

On the tiny DTU fixture of ``tests/test_torch_cli.py`` (with its GT cloud)
the JAX package's ``train_scene`` trains 20 steps; its parameters and prior
go into a port checkpoint (``convert.from_jax.params_from_numpy``) over the
port's own scene, which holds the same points.  Then both ``evaluate`` CLIs
run with ``--mesh --rendering --resolution 48 --max-views 2`` (the port
with ``--device cpu`` and its K1 on the exact variant, which the JAX
package's CPU path computes), and both ``eval_dtu`` CLIs on one mesh.

Tolerances: the probe grid as ``test_field_matches_jax_plain_xla_path``
holds the field (1e-4 relative + 1e-5), the same points at 1000; the two
meshes within 1e-3 of a grid step (symmetric mean vertex distance); each
view's PSNR within the bound that ``tests/test_torch_render.py``'s render
tolerance implies (below) and SSIM within 2e-2; ``chamfer.json`` equal to
1e-9 relative.  A last test, marked slow like ``tests/test_cli_chain.py``,
runs the port's chain train -> evaluate -> eval_dtu alone.
"""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import json
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree
from test_cli_chain import TINY_OVERRIDES

from spurfies_tpu.cli import eval_dtu as j_eval_dtu
from spurfies_tpu.cli import evaluate as j_eval
from spurfies_tpu.cli import train as j_train
from spurfies_tpu.config import Config as JConfig
from spurfies_tpu.config import apply_overrides as j_apply_overrides
from spurfies_tpu.eval import mesh_extract as jmesh
from spurfies_tpu_torch.cli import eval_dtu as t_eval_dtu
from spurfies_tpu_torch.cli import evaluate as t_eval
from spurfies_tpu_torch.cli import train as t_train
from spurfies_tpu_torch.config import Config as TConfig
from spurfies_tpu_torch.config import apply_overrides as t_apply_overrides
from spurfies_tpu_torch.convert.from_jax import params_from_numpy
from spurfies_tpu_torch.data.synthetic import export_synthetic_dtu
from spurfies_tpu_torch.eval import mesh_extract
from spurfies_tpu_torch.ops import select_knn as sk
from spurfies_tpu_torch.ops import voxel_grid

ROOT = Path(__file__).resolve().parent.parent
RES = 48
EVAL_ARGS = ["--scans", "scan24", "--mesh", "--rendering", "--resolution",
             str(RES), "--max-views", "2"]
OV = TINY_OVERRIDES + ["dataset.data_dir_root=data", "train.opt_steps=20",
                       "train.render_freq=20", "train.checkpoint_freq=20"]


def _exact_k1(*args, packed, **kwargs):
    return sk.select_knn(*args, packed=False, **kwargs)


def _recording(extract, grids):
    """``extract_mesh`` with its ``sdf_fn`` outputs appended to ``grids``."""
    def f(sdf_fn, *args, **kwargs):
        def rec(x):
            v = sdf_fn(x)
            grids.append(np.array(v.detach().cpu() if torch.is_tensor(v)
                                  else v))
            return v
        return extract(rec, *args, **kwargs)
    return f


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_cli")
    mp = pytest.MonkeyPatch()
    out = {"grid": {"jax": [], "torch": []}}
    try:
        mp.chdir(root)
        mp.setitem(sys.modules, "tensorboardX", None)
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        (root / "artifacts").symlink_to(ROOT / "artifacts")
        export_synthetic_dtu("data", scan_id=24, n_views=49, img_res=(48, 64),
                             n_points=2000, gt_root="data/dtu_eval")

        jtr, _ = j_train.train_scene(
            j_apply_overrides(JConfig(), OV + ["exps_folder=exps_jax"]),
            "scan24")
        ttr, exp = t_train.train_scene(
            t_apply_overrides(TConfig(), OV + ["exps_folder=exps_torch",
                                               "train.opt_steps=0"]),
            "scan24", device="cpu")
        out["same_points"] = np.array_equal(ttr.scene.points.numpy(),
                                            np.asarray(jtr.scene.points))
        ttr.state.params = params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jtr.state.params), "cpu")
        ttr.state.step = torch.tensor(int(jtr.state.step), dtype=torch.int32)
        ttr.load_frozen(params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jtr.frozen), "cpu"))
        ttr.save_checkpoint(exp.checkpoint_path("latest"))
        del jtr, ttr

        mp.setattr(jmesh, "extract_mesh",
                   _recording(jmesh.extract_mesh, out["grid"]["jax"]))
        mp.setattr(mesh_extract, "extract_mesh",
                   _recording(mesh_extract.extract_mesh,
                              out["grid"]["torch"]))
        mp.setattr(voxel_grid, "select_knn", _exact_k1)
        j_eval.main(EVAL_ARGS + ["--out", "results_jax"] + OV
                    + ["exps_folder=exps_jax"])
        t_eval.main(EVAL_ARGS + ["--device", "cpu", "--out", "results_torch"]
                    + OV + ["exps_folder=exps_torch"])
        for name in ("jax", "torch"):
            with open(root / f"results_{name}" / "dtu_pn_scan24" /
                      "summary.json") as f:
                out[name] = json.load(f)
        # both eval_dtu CLIs on the JAX package's mesh
        mp.undo()
        mp.chdir(root)
        mesh = root / "results_jax" / "dtu_pn_scan24"
        dtu = ["--scans", "24", "--meshes", str(mesh), "--data-root", "data",
               "--gt-root", "data/dtu_eval"]
        j_eval_dtu.main(dtu + ["--out", "chamfer/jax.json"])
        t_eval_dtu.main(dtu + ["--device", "cpu", "--out",
                               "chamfer/torch.json"])
        for name in ("jax", "torch"):
            with open(root / "chamfer" / f"{name}.json") as f:
                out[f"chamfer_{name}"] = json.load(f)
        out["root"] = root
        yield out
    finally:
        mp.undo()


def test_probe_grid_matches_jax(evaluated):
    """The same scene, the same grid points read 1000 (empty space, or an
    occupied point past the probe budget), the rest within the field's
    stated tolerance."""
    assert evaluated["same_points"]
    got = np.concatenate(evaluated["grid"]["torch"])
    ref = np.concatenate(evaluated["grid"]["jax"])
    assert got.shape == ref.shape and len(evaluated["grid"]["jax"]) >= 1
    empty = ref == 1000.0
    np.testing.assert_array_equal(got == 1000.0, empty)
    assert 0 < (~empty).sum() < len(ref)
    np.testing.assert_allclose(got[~empty], ref[~empty], rtol=1e-4,
                               atol=1e-5)


def test_mesh_matches_jax(evaluated):
    """The symmetric mean vertex distance of the two meshes is under 1e-3
    of the grid's step (world units: the export's scale_mat scales by 2)."""
    root = evaluated["root"]
    va, _ = mesh_extract.load_mesh_ply(
        evaluated["torch"]["mesh"]["path"].replace(
            "results_torch", str(root / "results_torch")))
    vb, _ = jmesh.load_mesh_ply(str(root / evaluated["jax"]["mesh"]["path"]))
    assert len(va) > 100 and len(vb) > 100
    d = (cKDTree(vb).query(va)[0].mean() + cKDTree(va).query(vb)[0].mean()) / 2
    lo, hi = mesh_extract.grid_bounds_dtu(
        str(root / "data" / "dtu" / "bbs.npz"), 24,
        np.diag([2.0, 2.0, 2.0, 1.0]))
    steps, axes = mesh_extract.grid_axes(lo, hi, RES)
    step = 2.0 * min(a[1] - a[0] for a in axes)
    assert d < 1e-3 * step, (d, step)


def test_nvs_matches_jax(evaluated):
    """PSNR: test_torch_render.py holds each ray's rgb within 1e-2 on 99 %
    of the rays (any value on the rest) and the 8-bit PNG rounding may move
    a channel by one more level, so the two predictions' RMS difference on
    the masked pixels is at most d = sqrt(0.99 (1e-2 + 1/255)^2 + 0.01),
    and each view's RMSE against the GT moves by at most d:
    |PSNR_t - PSNR_j| <= 20 log10(1 + d / RMSE_j).  SSIM has no bound as
    simple: it is held within 2e-2, twice the render's per-ray rgb
    tolerance."""
    got, ref = evaluated["torch"]["nvs"], evaluated["jax"]["nvs"]
    assert evaluated["torch"]["eval_ids"] == evaluated["jax"]["eval_ids"]
    d = np.sqrt(0.99 * (1e-2 + 1 / 255) ** 2 + 0.01)
    for pt, pj in zip(got["psnr"], ref["psnr"]):
        rmse = 10 ** (-pj / 20)
        assert abs(pt - pj) <= 20 * np.log10(1 + d / rmse), (pt, pj)
    np.testing.assert_allclose(got["ssim"], ref["ssim"], rtol=0, atol=2e-2)


def test_summary_keys_match_jax(evaluated):
    """The same keys, apart from the port's ``lpips: null`` and its
    reason (a difference by design)."""
    got, ref = evaluated["torch"], evaluated["jax"]
    assert sorted(got) == sorted(ref)
    assert sorted(got["mesh"]) == sorted(ref["mesh"])
    assert got["mesh"]["n_faces"] > 0 and got["step"] == ref["step"] == 20
    assert sorted(set(got["nvs"]) - {"lpips", "lpips_skipped_reason"}) == \
        sorted(ref["nvs"])
    assert got["nvs"]["lpips"] is None and got["nvs"]["lpips_skipped_reason"]


def test_eval_dtu_matches_jax(evaluated):
    """Both eval_dtu CLIs on one mesh: the same scans, acc / comp / overall
    within 1e-9 relative."""
    got, ref = evaluated["chamfer_torch"], evaluated["chamfer_jax"]
    assert sorted(got["per_scan"]) == sorted(ref["per_scan"]) == ["24"]
    for k in ("acc", "comp", "overall"):
        np.testing.assert_allclose(got["per_scan"]["24"][k],
                                   ref["per_scan"]["24"][k], rtol=1e-9,
                                   atol=0)
    np.testing.assert_allclose(got["mean_overall"], ref["mean_overall"],
                               rtol=1e-9, atol=0)


@pytest.mark.slow
def test_cpu_chain(tmp_path, monkeypatch):
    """The port's chain on the CPU, as ``tests/test_cli_chain.py`` runs the
    JAX package's: train -> evaluate --mesh --rendering -> eval_dtu."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    export_synthetic_dtu("data", scan_id=24, n_views=49, img_res=(48, 64),
                         n_points=2000, gt_root="data/dtu_eval")
    ov = TINY_OVERRIDES + ["dataset.data_dir_root=data"]
    t_train.main(["--scans", "scan24", "--device", "cpu"] + ov)
    [summary] = t_eval.main(EVAL_ARGS + ["--device", "cpu"] + ov)
    assert summary["mesh"]["n_verts"] > 0
    assert np.isfinite(summary["nvs"]["mean_psnr"])
    assert 0.0 <= summary["nvs"]["mean_ssim"] <= 1.0
    assert len(summary["nvs"]["psnr"]) == 2
    pngs = [p for p in os.listdir(os.path.join("results", "dtu_pn_scan24"))
            if p.startswith("eval_")]
    assert len(pngs) == 2
    res = t_eval_dtu.main(["--scans", "24", "--meshes", "results",
                           "--data-root", "data", "--gt-root",
                           "data/dtu_eval", "--device", "cpu"])
    assert np.isfinite(res[24]["overall"])
    with open(os.path.join("results", "chamfer.json")) as f:
        assert "24" in json.load(f)["per_scan"]
