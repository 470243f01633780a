"""K1 and the voxel-grid query of the port against the JAX package.

Inputs come from numpy (seeded) and go to both packages.  The Pallas
select runs as the JAX package's own tests run it on the CPU
(``interpret=True``).
"""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spurfies_tpu.ops import knn_brute as j_knn_brute
from spurfies_tpu.ops import voxel_grid as jvg
from spurfies_tpu.ops.pallas_select import select_knn_pallas
from spurfies_tpu_torch.ops import select_knn as sk
from spurfies_tpu_torch.ops import voxel_grid as tvg
from spurfies_tpu_torch.ops.knn_brute import knn_brute

JSPEC = jvg.VoxelGridSpec()
TSPEC = tvg.VoxelGridSpec()


def _cloud(rng, n, scale=0.8):
    return rng.uniform(-scale, scale, size=(n, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(0)
    pts = _cloud(rng, 3000)
    x = rng.uniform(-0.9, 0.9, (1024, 3)).astype(np.float32)
    qj = jvg.build_query_table(jnp.asarray(pts), JSPEC, r=2.0)
    qt = tvg.build_query_table(torch.from_numpy(pts), TSPEC, r=2.0)
    return pts, x, qj, qt


def test_build_query_table_bit_equal(tables):
    _, _, qj, qt = tables
    np.testing.assert_array_equal(qt.idx.numpy(), np.asarray(qj.idx))
    np.testing.assert_array_equal(qt.pos.numpy(), np.asarray(qj.pos))
    assert qt.n_points == qj.n_points and qt.r == qj.r


@pytest.mark.parametrize("r", [2.0, 3.0])
def test_build_occupancy_bitmap_bit_equal(r):
    pts = _cloud(np.random.default_rng(1), 800, scale=0.5)
    oj = jvg.build_occupancy_bitmap(jnp.asarray(pts), JSPEC, r=r)
    ot = tvg.build_occupancy_bitmap(torch.from_numpy(pts), TSPEC, r=r)
    assert ot.dtype == torch.int8
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))


def test_build_grid_and_cell_ids_equal():
    rng = np.random.default_rng(2)
    pts = np.concatenate([_cloud(rng, 500),
                          np.full((40, 3), 0.01, np.float32)
                          + rng.uniform(0, 1e-3, (40, 3)).astype(np.float32),
                          np.array([[5.0, 5.0, 5.0]], np.float32)])
    np.testing.assert_array_equal(
        tvg.build_grid(torch.from_numpy(pts), TSPEC).numpy(),
        np.asarray(jvg.build_grid(jnp.asarray(pts), JSPEC)))
    np.testing.assert_array_equal(
        tvg._cell_ids(torch.from_numpy(pts), TSPEC).numpy(),
        np.asarray(jvg._cell_ids(jnp.asarray(pts), JSPEC)))


def test_exact_ref_matches_jax_query_grid(tables):
    """The JAX package's CPU query (lax.top_k over the gathered candidates)
    against the exact plain version: ids equal; d2 within 2 ulps (XLA may
    contract the distance into FMAs)."""
    _, x, qj, qt = tables
    gi, gd = jvg.query_grid(jnp.asarray(x), qj, JSPEC, k=8)
    exact = tvg.QueryTable(qt.idx, qt.pos, qt.r, n_points=0)
    ti, td = tvg.query_grid(torch.from_numpy(x), exact, TSPEC, k=8)
    gi, gd = np.asarray(gi), np.asarray(gd)
    np.testing.assert_array_equal(ti.numpy(), gi)
    fin = np.isfinite(gd)
    np.testing.assert_array_equal(np.isfinite(td.numpy()), fin)
    ulp = np.spacing(np.abs(gd[fin]))
    assert np.all(np.abs(td.numpy()[fin] - gd[fin]) <= 2 * ulp)


@pytest.mark.parametrize("packed", [False, True])
def test_ref_matches_pallas_interpret(tables, packed):
    """Both variants against the TPU kernel in interpret mode on the same
    gathered inputs: ids equal (the same order rule); d2 equal up to 1 ulp
    (exact) / exactly (packed: the rounded key)."""
    _, x, qj, qt = tables
    xi = jnp.asarray(x)
    cid = jvg._cell_ids(xi, JSPEC)
    in_grid = cid < JSPEC.num_cells
    cidc = jnp.where(in_grid, cid, 0)
    cand = jnp.where(in_grid[:, None], qj.idx[cidc], -1)
    pi, pd = select_knn_pallas(
        xi, cand, qj.pos[cidc], k=8, radius2=float(JSPEC.radius(2.0)) ** 2,
        tile=512, interpret=True, packed=packed)
    tcid = torch.from_numpy(np.where(np.asarray(in_grid), np.asarray(cid),
                                     -1).astype(np.int32))
    r2 = float(np.float32(TSPEC.radius(2.0) ** 2))
    ti, td = sk.select_knn(torch.from_numpy(x), tcid, qt.idx, qt.pos, r2,
                           k=8, packed=packed)
    pi, pd = np.asarray(pi), np.asarray(pd)
    np.testing.assert_array_equal(ti.numpy(), pi)
    fin = np.isfinite(pd)
    np.testing.assert_array_equal(np.isfinite(td.numpy()), fin)
    ulp = 0 if packed else np.spacing(np.abs(pd[fin]))
    assert np.all(np.abs(td.numpy()[fin] - pd[fin]) <= ulp)


@pytest.fixture(scope="module", params=[2.0, 4.0], ids=["r2", "r4"])
def brute_case(request):
    r = request.param
    rng = np.random.default_rng(0)
    pts = _cloud(rng, 3000)
    x = rng.uniform(-0.9, 0.9, size=(512, 3)).astype(np.float32)
    qt = tvg.build_query_table(torch.from_numpy(pts), TSPEC, r=r)
    bi, bd = knn_brute(torch.from_numpy(x), torch.from_numpy(pts), k=8,
                       radius=TSPEC.radius(r))
    return r, pts, x, qt, bi.numpy(), bd.numpy()


@pytest.mark.parametrize("n_points", [0, 3000])
def test_query_matches_bruteforce(brute_case, n_points):
    """The tests/test_voxel_grid.py oracle cases (r = 2, 4), for both K1
    variants (n_points gates packing): same validity, same distances
    (packed: d2 rounded to ~2**-8 relative)."""
    r, pts, x, qt, bi, bd = brute_case
    qt = tvg.QueryTable(qt.idx, qt.pos, qt.r, n_points=n_points)
    gi, gd = tvg.query_grid(torch.from_numpy(x), qt, TSPEC, k=8)
    gi, gd = gi.numpy(), gd.numpy()
    np.testing.assert_array_equal(gi >= 0, bi >= 0)
    rtol = 5e-3 if n_points else 1e-6
    np.testing.assert_allclose(np.where(np.isfinite(gd), gd, 0),
                               np.where(np.isfinite(bd), bd, 0),
                               rtol=rtol, atol=1e-9)
    if n_points:
        # the port's oracle against the JAX package's
        ji, _ = j_knn_brute(jnp.asarray(x), jnp.asarray(pts), k=8,
                            radius=JSPEC.radius(r))
        np.testing.assert_array_equal(np.asarray(ji) >= 0, bi >= 0)


def test_isolated_and_out_of_grid_queries():
    pts = torch.zeros((10, 3))
    qt = tvg.build_query_table(pts, TSPEC, r=2.0)
    x = torch.tensor([[0.9, 0.9, 0.9], [3.0, 3.0, 3.0]])
    gi, gd = tvg.query_grid(x, qt, TSPEC, k=8)
    assert (gi == -1).all() and torch.isinf(gd).all()


def test_plain_select_treats_cells_outside_the_table_as_empty():
    """A cell id outside [0, C) has no neighbours, as -1 has (the kernel
    guards its table reads the same way)."""
    rng = np.random.default_rng(6)
    pts = torch.from_numpy(_cloud(rng, 500, scale=0.3))
    qt = tvg.build_query_table(pts, TSPEC, r=2.0)
    x = pts[:4] + 0.001
    cid = tvg._cell_ids(x, TSPEC)
    r2 = float(np.float32(TSPEC.radius(2.0) ** 2))
    for packed in (False, True):
        gi, _ = sk.select_knn(x, cid, qt.idx, qt.pos, r2, 8, packed)
        assert bool((gi[:, 0] >= 0).all())
        bad = torch.tensor([-1, -9, TSPEC.num_cells, TSPEC.num_cells + 3],
                           dtype=torch.int32)
        bi, bd = sk.select_knn(x, bad, qt.idx, qt.pos, r2, 8, packed)
        assert bool((bi == -1).all()) and bool(torch.isinf(bd).all())


def test_fine_occupancy_and_compact_rays_equal():
    rng = np.random.default_rng(4)
    pts = _cloud(rng, 800, scale=0.5)
    occ_j = jvg.build_occupancy_bitmap(jnp.asarray(pts), JSPEC, r=2.0)
    occ_t = tvg.build_occupancy_bitmap(torch.from_numpy(pts), TSPEC, r=2.0)
    x = np.concatenate([_cloud(rng, 4000, scale=0.9),
                        [[5.0, 5.0, 5.0], [-3.0, 0.0, 0.0]]]).astype(
        np.float32)
    np.testing.assert_array_equal(
        tvg.fine_occupancy(torch.from_numpy(x), occ_t, TSPEC).numpy(),
        np.asarray(jvg.fine_occupancy(jnp.asarray(x), occ_j, JSPEC)))
    valid = rng.uniform(size=(64, 98)) > 0.6
    sj, okj = jvg.compact_rays(jnp.asarray(valid), 80)
    st, okt = tvg.compact_rays(torch.from_numpy(valid), 80)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_select_knn_rejects_other_devices():
    x = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError):
        sk.select_knn(x, torch.zeros(4, dtype=torch.int32, device="meta"),
                      torch.zeros((1, 32), dtype=torch.int32, device="meta"),
                      torch.zeros((1, 3, 32), device="meta"), 0.0025)


def test_jax_is_on_cpu():
    assert jax.default_backend() == "cpu"
