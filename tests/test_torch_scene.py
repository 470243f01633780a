"""Scene building and the synthetic data of the port against the JAX
package: the same cloud in gives the same points, query table (after the
qcap shrink), TV graph and occupancy bitmap out."""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import jax
import numpy as np
import pytest
import torch

from spurfies_tpu.config import ModelConfig
from spurfies_tpu.data import scene_data as j_scene_data
from spurfies_tpu.data import synthetic as jsyn
from spurfies_tpu.model import neural_points as jnp_pts
from spurfies_tpu.prep.pointcloud import greedy_spacing_subsample as j_gss
from spurfies_tpu_torch.config import ModelConfig as TModelConfig
from spurfies_tpu_torch.data import scene_data as t_scene_data
from spurfies_tpu_torch.data import synthetic as tsyn
from spurfies_tpu_torch.device import resolve_device
from spurfies_tpu_torch.model import neural_points as tnp_pts
from spurfies_tpu_torch.prep.pointcloud import greedy_spacing_subsample


def test_synthetic_scenes_equal():
    for j, t in ((jsyn.make_synthetic_scene(n_points=500, img_res=(16, 24)),
                  tsyn.make_synthetic_scene(n_points=500, img_res=(16, 24))),
                 (jsyn.make_dust3r_like_scene(n_points=600, img_res=(16, 24)),
                  tsyn.make_dust3r_like_scene(n_points=600,
                                              img_res=(16, 24)))):
        np.testing.assert_array_equal(t[0], j[0])
        np.testing.assert_array_equal(t[1], j[1])
        for k in j[2]:
            np.testing.assert_array_equal(t[2][k], j[2][k])
    np.testing.assert_array_equal(t_scene_data.make_uv(5, 7),
                                  j_scene_data.make_uv(5, 7))


@pytest.mark.parametrize("spacing", [0.02, 0.05])
def test_greedy_spacing_subsample_equal(spacing):
    pts = np.random.default_rng(0).normal(size=(3000, 3)) * 0.3
    np.testing.assert_array_equal(greedy_spacing_subsample(pts, spacing),
                                  j_gss(pts, spacing))


@pytest.fixture(scope="module")
def scenes():
    pts, cols, _ = jsyn.make_synthetic_scene(n_points=1500, img_res=(8, 8))
    js, _ = jnp_pts.build_scene(jax.random.PRNGKey(0), pts, ModelConfig(),
                                cols)
    ts, lat = tnp_pts.build_scene(pts, TModelConfig(), cols,
                                  generator=torch.Generator().manual_seed(0),
                                  device="cpu")
    return js, ts, lat


def test_build_scene_tables_equal(scenes):
    js, ts, _ = scenes
    assert ts.spec == ts.spec.__class__(**{
        f: getattr(js.spec, f) for f in ("voxel_size", "voxel_scale", "lo",
                                         "hi", "max_pts_per_cell", "kernel",
                                         "qcap")})
    np.testing.assert_array_equal(ts.points.numpy(), np.asarray(js.points))
    np.testing.assert_array_equal(ts.table.idx.numpy(),
                                  np.asarray(js.table.idx))
    np.testing.assert_array_equal(ts.table.pos.numpy(),
                                  np.asarray(js.table.pos))
    assert ts.table.idx.is_contiguous() and ts.table.pos.is_contiguous()
    np.testing.assert_array_equal(ts.occ_fine.numpy(),
                                  np.asarray(js.occ_fine))


def test_tv_graph_matches(scenes):
    """The TV graph: the JAX package's CPU query is the exact select, the
    port's is the packed one (N <= 2**15), which may swap near-tied
    neighbours -- so the edge SETS match per point."""
    js, ts, _ = scenes
    ti, tv = ts.tv_idx.numpy(), ts.tv_valid.numpy()
    ji, jv = np.asarray(js.tv_idx), np.asarray(js.tv_valid)
    np.testing.assert_array_equal(tv.sum(1), jv.sum(1))
    for a, va, b, vb in zip(ti, tv, ji, jv):
        assert set(a[va].tolist()) == set(b[vb].tolist())


def test_latent_init(scenes):
    _, ts, lat = scenes
    n = ts.points.shape[0]
    assert tuple(lat["feats_color"].shape) == (n, 64)
    assert tuple(lat["feats_geometry"].shape) == (n, 32)
    assert float(lat["feats_color"][:, 3:].abs().max()) <= 1e-4
    assert float(lat["feats_color"][:, :3].abs().max()) <= 1.0
    assert float(torch.linalg.norm(lat["feats_geometry"], dim=-1).max()) <= 1


def test_shrink_query_table_is_exact():
    from spurfies_tpu_torch.ops import voxel_grid as tvg
    rng = np.random.default_rng(1)
    pts = torch.from_numpy(rng.uniform(-0.3, 0.3, (800, 3)).astype(
        np.float32))
    spec = tvg.VoxelGridSpec()
    qt = tvg.build_query_table(pts, spec, r=2.0)
    qt_s, spec_s = tnp_pts.shrink_query_table(qt, spec)
    assert spec_s.qcap < spec.qcap
    q = torch.from_numpy(rng.uniform(-0.35, 0.35, (300, 3)).astype(
        np.float32))
    i0, d0 = tvg.query_grid(q, qt, spec, k=8)
    i1, d1 = tvg.query_grid(q, qt_s, spec_s, k=8)
    assert torch.equal(i0, i1) and torch.equal(d0, d1)


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
