"""The port's CUDA kernels on the card, against their plain versions.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch and a card (``tests/conftest.py`` sets JAX up, and
``--noconftest`` leaves it out):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Without a card every test skips.  Inputs are made with numpy from a seed.
"""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from spurfies_tpu_torch.config import Config, apply_overrides
from spurfies_tpu_torch.convert.from_jax import load_prior_npz
from spurfies_tpu_torch.data.synthetic import make_synthetic_scene
from spurfies_tpu_torch.model import field
from spurfies_tpu_torch.model.networks import init_model_params
from spurfies_tpu_torch.model.neural_points import build_scene
from spurfies_tpu_torch.ops import pair_mlp
from spurfies_tpu_torch.ops import scatter_rows as sr
from spurfies_tpu_torch.ops import select_knn as sk
from spurfies_tpu_torch.ops import voxel_grid as vg
from spurfies_tpu_torch.train.trainer import make_render_fn

SPEC = vg.VoxelGridSpec()
RBF = 45.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False    # plain versions in f32
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
def test_select_knn_matches_plain(cuda, packed):
    """K1 against its plain version: ids and d2 bit-equal (the kernel does
    the plain version's f32 operations, without FMA contraction)."""
    rng = np.random.default_rng(5)
    pts = torch.from_numpy(
        rng.uniform(-0.8, 0.8, (3000, 3)).astype(np.float32)).to(cuda)
    x = torch.from_numpy(
        rng.uniform(-0.9, 0.9, (4096, 3)).astype(np.float32)).to(cuda)
    qt = vg.build_query_table(pts, SPEC, r=2.0)
    cid = vg._cell_ids(x, SPEC)
    cid[:8] = -7                       # outside the table: no neighbours
    cid[8:16] = SPEC.num_cells + 5
    r2 = float(np.float32(SPEC.radius(2.0) ** 2))
    before = dict(sk.LAUNCHES)
    ki, kd = sk.select_knn(x, cid, qt.idx, qt.pos, r2, 8, packed)
    ri, rd = sk.select_knn_ref(x, cid, qt.idx, qt.pos, r2, 8, packed)
    torch.cuda.synchronize()
    key = "select_knn_packed" if packed else "select_knn_exact"
    assert sk.LAUNCHES[key] == before[key] + 1
    assert torch.equal(ki, ri)
    assert bool((ki[:16] == -1).all())
    assert torch.equal(torch.isinf(kd), torch.isinf(rd))
    fin = torch.isfinite(rd)
    assert torch.equal(kd[fin], rd[fin])


def _knn_lists(dev, q, m, seed, k=8):
    """K1's edges: a table whose lists hold 0, 1, k - 1, k and q
    candidates (front-first, unique ids < 2**15, positions inf where
    empty) and random lengths; m queries near their cells' candidates, the
    first five on those five lists, a tenth of the rest with a cell outside
    the grid (-7, -1, C, C + 5)."""
    rng = np.random.default_rng(seed)
    lengths = [0, 1, k - 1, k, q] + list(rng.integers(0, q + 1, 27))
    lengths = [min(n, q) for n in lengths]
    c = len(lengths)
    qidx = np.full((c, q), -1, np.int32)
    qpos = np.full((c, 3, q), np.inf, np.float32)
    centre = rng.uniform(-0.5, 0.5, (c, 3)).astype(np.float32)
    for i, n in enumerate(lengths):
        qidx[i, :n] = rng.choice(2 ** 15, n, replace=False)
        qpos[i, :, :n] = centre[i][:, None] + rng.normal(0, 0.02, (3, n))
    cid = rng.integers(0, c, m).astype(np.int32)
    cid[:5] = np.arange(min(5, m))[:m]
    x = (centre[cid] + rng.normal(0, 0.01, (m, 3))).astype(np.float32)
    out = rng.uniform(size=m) < 0.1
    out[:5] = False
    cid[out] = rng.choice([-7, -1, c, c + 5], int(out.sum()))
    return tuple(torch.from_numpy(a).to(dev) for a in (x, cid, qidx, qpos))


@pytest.mark.cuda
@pytest.mark.parametrize("q,m", [(64, 1), (64, 63), (64, 65), (64, 1001),
                                 (64, 40000), (128, 1001), (20, 1001),
                                 (4, 1001)])
@pytest.mark.parametrize("k", [8, 1, 16])
def test_select_knn_packed_edges(cuda, q, m, k):
    """K1 packed (a group of 4 lanes a query) against its plain version:
    ids and d2 bit-equal on lists of 0, 1, k - 1, k and qcap candidates, a
    qcap below k, cells outside the grid, and query counts that fill no
    whole block of 64 queries (1, 63, 65, 1001) or many blocks."""
    args = _knn_lists(cuda, q, m, seed=q + m + k, k=k)
    r2 = float(np.float32(0.04 ** 2))
    before = sk.LAUNCHES["select_knn_packed"]
    ki, kd = sk.select_knn(*args, r2, k, True)
    ri, rd = sk.select_knn_ref(*args, r2, k, True)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["select_knn_packed"] == before + 1
    assert torch.equal(ki, ri)
    assert torch.equal(kd, rd)


@pytest.mark.cuda
@pytest.mark.parametrize("q,m", [(128, 1), (128, 31), (128, 33),
                                 (128, 1001), (128, 40000), (20, 1001),
                                 (4, 1001)])
@pytest.mark.parametrize("k", [8, 1, 16])
def test_select_knn_exact_edges(cuda, q, m, k):
    """K1 exact (a group of lanes a query, 64-bit keys) against its plain
    version: ids and d2 bit-equal on lists of 0, 1, k - 1, k and qcap
    candidates, a qcap below k, cells outside the grid, query counts that
    fill no whole block (1, 31, 33, 1001) or many blocks, ids up to
    2**31 - 32768 (id 0 kept) and exact d2 ties: in every list of two or
    more, the second candidate sits on the first (the larger id first)."""
    x, cid, qidx, qpos = _knn_lists(cuda, q, m, seed=q + m + k + 1, k=k)
    qidx = torch.where(qidx >= 0, qidx * 65537, -1)
    qidx[0, :1] = torch.where(qidx[0, :1] >= 0, 0, -1)
    two = (qidx[:, 1] >= 0).nonzero()[:, 0]
    qpos[two, :, 1] = qpos[two, :, 0]
    r2 = float(np.float32(0.04 ** 2))
    before = sk.LAUNCHES["select_knn_exact"]
    ki, kd = sk.select_knn(x, cid, qidx, qpos, r2, k, False)
    ri, rd = sk.select_knn_ref(x, cid, qidx, qpos, r2, k, False)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["select_knn_exact"] == before + 1
    assert torch.equal(ki, ri)
    assert torch.equal(kd, rd)
    if m >= 1001 and k > 1:
        tie = (rd[:, 1:] == rd[:, :-1]) & torch.isfinite(rd[:, 1:])
        assert bool(tie.any()) and int(ri.max()) >= 2 ** 15


def _pair_inputs(dev, m=1000, k=8):
    """m points (not a whole number of 128-row tiles), each with k
    neighbours scattered around it; 30 % of the pairs and the
    first 5 points' pairs invalid (the dump row); two pairs each of points
    5 and 6 index outside the table, which reads the dump row too."""
    rng = np.random.default_rng(0)
    n = m * k
    lat = (0.1 * rng.normal(size=(n, 32))).astype(np.float32)
    x = rng.uniform(-0.5, 0.5, (m, 3)).astype(np.float32)
    perm = rng.permutation(n)
    pts = np.empty((n, 3), np.float32)
    pts[perm] = np.repeat(x, k, 0) + rng.normal(0, 0.03, (n, 3))
    valid = rng.uniform(size=(m, k)) > 0.3
    valid[:5] = False
    idx_ext = np.where(valid, perm.reshape(m, k), n).astype(np.int32)
    idx_ext[5, :2] = -3
    idx_ext[6, :2] = n + 7
    table = field.pair_table(torch.from_numpy(lat).to(dev),
                             torch.from_numpy(pts).to(dev))
    prior = pair_mlp._prep_layers(load_prior_npz(device=dev), torch.bfloat16)
    return (table, torch.from_numpy(idx_ext).to(dev),
            torch.from_numpy(x).to(dev), prior)


def _within(out, ref, share):
    """Per column: |out - ref| <= 2**-6 |ref| + 1e-3 of the column's max
    |ref| on all but ``share`` of the entries, and <= 0.05 of it on all.
    Both sides round to bf16 at the same points; only the f32 sums inside
    each product run in another order, which can move one bf16 rounding by
    an ulp (2**-8), and a LeakyReLU gate that flips on a kink carries it."""
    out = out.float().reshape(out.shape[0], -1)
    ref = ref.float().reshape(ref.shape[0], -1)
    scale = ref.abs().amax(0, keepdim=True) + 1e-30
    d = (out - ref).abs()
    assert float((d > 2.0 ** -6 * ref.abs() + 1e-3 * scale).float().mean()) \
        <= share
    assert float((d / scale).max()) <= 0.05


@pytest.mark.cuda
def test_pair_sdf_value_agg_matches_plain(cuda):
    table, idx_ext, x, prior = _pair_inputs(cuda)
    before = pair_mlp.LAUNCHES["pair_sdf_value_agg"]
    with torch.no_grad():
        pt = pair_mlp.pair_sdf_value_agg(table, idx_ext, x, prior, RBF)
        ref = pair_mlp.pair_sdf_value_agg_ref(table, idx_ext, x, prior, RBF)
    torch.cuda.synchronize()
    assert pair_mlp.LAUNCHES["pair_sdf_value_agg"] == before + 1
    assert pt.shape == ref.shape == (x.shape[0], 2)
    assert bool(torch.isfinite(pt).all())
    assert bool((pt[:5] == 0).all())          # all-dump points: w == 0
    _within(pt, ref, 1e-3)


@pytest.mark.cuda
def test_pair_sdf_aggregate_matches_plain(cuda):
    table, idx_ext, x, prior = _pair_inputs(cuda)
    before = pair_mlp.LAUNCHES["pair_sdf_aggregate"]
    with torch.no_grad():
        pt, w, r_lat = pair_mlp.pair_sdf_aggregate(table, idx_ext, x, prior,
                                                   RBF)
        pt_r, w_r, r_r = pair_mlp.pair_sdf_aggregate_ref(table, idx_ext, x,
                                                         prior, RBF)
    torch.cuda.synchronize()
    assert pair_mlp.LAUNCHES["pair_sdf_aggregate"] == before + 1
    assert pt.shape == (x.shape[0], 5) and w.shape == w_r.shape
    assert r_lat.shape == r_r.shape and r_lat.dtype == torch.bfloat16
    assert bool(torch.isfinite(pt).all())
    # expf against torch.exp: a few ulps
    assert float((w - w_r).abs().max()) <= 1e-6
    _within(pt, pt_r, 1e-3)
    real = ((idx_ext >= 0) & (idx_ext < table.shape[0] - 1)).reshape(-1)
    _within(r_lat[real], r_r[real], 1e-3)
    assert bool((w[~real] == 0).all()) and bool((r_lat[~real] == 0).all())


def _mixed_pairs(dev, m, k=8):
    """m points with 0..k real pairs each (cycling, so every count occurs
    and a run of all-dump points spans a tile), the rest the dump row N or
    an index outside [0, N]; neighbours scattered around their point."""
    rng = np.random.default_rng(m)
    n = m * k
    lat = (0.1 * rng.normal(size=(n, 32))).astype(np.float32)
    x = rng.uniform(-0.5, 0.5, (m, 3)).astype(np.float32)
    perm = rng.permutation(n)
    pts = np.empty((n, 3), np.float32)
    pts[perm] = np.repeat(x, k, 0) + rng.normal(0, 0.03, (n, 3))
    count = np.arange(m) % (k + 1)
    count[100:300] = 0
    slot = rng.permuted(np.tile(np.arange(k), (m, 1)), axis=1)
    valid = slot < count[:, None]
    junk = rng.choice(np.array([n, -1, -5, n + 1, n + 99], np.int32), (m, k))
    idx_ext = np.where(valid, perm.reshape(m, k), junk).astype(np.int32)
    table = field.pair_table(torch.from_numpy(lat).to(dev),
                             torch.from_numpy(pts).to(dev))
    prior = pair_mlp._prep_layers(load_prior_npz(device=dev), torch.bfloat16)
    return (table, torch.from_numpy(idx_ext).to(dev),
            torch.from_numpy(x).to(dev), prior)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2999, 5, 1])
def test_pair_sdf_aggregate_skips_dump_pairs(cuda, m):
    """K3 on points with 0..8 real pairs, indices outside the table and a P
    that fills no whole tile: pt and the real pairs' r_lat by ``_within``,
    w within 1e-6, and w == 0 and r_lat == 0 exactly on every dump pair
    (the kernel computes none of them)."""
    table, idx_ext, x, prior = _mixed_pairs(cuda, m)
    with torch.no_grad():
        pt, w, r_lat = pair_mlp.pair_sdf_aggregate(table, idx_ext, x, prior,
                                                   RBF)
        pt_r, w_r, r_r = pair_mlp.pair_sdf_aggregate_ref(table, idx_ext, x,
                                                         prior, RBF)
    torch.cuda.synchronize()
    real = ((idx_ext >= 0) & (idx_ext < table.shape[0] - 1)).reshape(-1)
    assert pt.shape == pt_r.shape and bool(torch.isfinite(pt).all())
    assert float((w - w_r).abs().max()) <= 1e-6
    assert bool((w[~real] == 0).all()) and bool((r_lat[~real] == 0).all())
    empty = ~real.view(m, -1).any(1)
    assert bool((pt[empty] == 0).all())
    _within(pt, pt_r, 1e-3)
    if bool(real.any()):
        _within(r_lat[real], r_r[real], 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2999, 5, 1])
def test_pair_sdf_value_agg_skips_dump_pairs(cuda, m):
    """K2 on points with 0..8 real pairs, indices outside the table and a P
    that fills no whole tile: pt by ``_within``, and exactly (0, 0) on every
    point with no real pair (the kernel computes no dump pair)."""
    table, idx_ext, x, prior = _mixed_pairs(cuda, m)
    before = pair_mlp.LAUNCHES["pair_sdf_value_agg"]
    with torch.no_grad():
        pt = pair_mlp.pair_sdf_value_agg(table, idx_ext, x, prior, RBF)
        ref = pair_mlp.pair_sdf_value_agg_ref(table, idx_ext, x, prior, RBF)
    torch.cuda.synchronize()
    assert pair_mlp.LAUNCHES["pair_sdf_value_agg"] == before + 1
    assert pt.shape == ref.shape == (m, 2) and bool(torch.isfinite(pt).all())
    real = ((idx_ext >= 0) & (idx_ext < table.shape[0] - 1))
    assert bool((pt[~real.any(1)] == 0).all())
    _within(pt, ref, 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["mixed", "pairs"])
def test_pair_sdf_value_agg_is_the_aggregate_without_its_down_sweep(
        cuda, inputs):
    """K2 and K3 run the same up-sweep instructions on the same tiles and
    sum in the same order, so K2's pt is K3's pt[:, :2] bit for bit."""
    table, idx_ext, x, prior = (_mixed_pairs(cuda, 2999) if inputs == "mixed"
                                else _pair_inputs(cuda))
    with torch.no_grad():
        pt2 = pair_mlp.pair_sdf_value_agg(table, idx_ext, x, prior, RBF)
        pt3 = pair_mlp.pair_sdf_aggregate(table, idx_ext, x, prior, RBF)[0]
    torch.cuda.synchronize()
    assert bool((pt2[:, 1] > 0).any())
    assert torch.equal(pt2, pt3[:, :2])


@pytest.mark.cuda
def test_render_through_kernels_matches_plain_render(cuda):
    """A small render through ``make_render_fn`` on the card launches every
    kernel, and agrees with the same render on the CPU (plain versions,
    bf16 too).  The SDFs agree to a bf16 ulp, but the sampler's bisection
    makes discrete choices on them, so a few rays move their samples:
    ray_mask may flip on 1 % of the rays and depth may move by more than
    2e-3 on 5 % of the rays that hit on both sides."""
    pts, cols, views = make_synthetic_scene(n_points=1500, img_res=(24, 40))
    cfg = apply_overrides(Config(), ["model.ray_sampler.n_samples_eval=32",
                                     "model.ray_sampler.max_total_iters=2"])
    outs = {}
    before = {**sk.LAUNCHES, **pair_mlp.LAUNCHES}
    for dev in ("cpu", cuda):
        gen = torch.Generator().manual_seed(0)
        scene, latents = build_scene(pts, cfg.model, cols, generator=gen,
                                     device=dev)
        tp = dict(init_model_params(cfg.model, gen, device=dev)["train"],
                  **latents)
        render = make_render_fn(cfg, device=dev)
        outs[str(dev)] = render(tp, scene, load_prior_npz(device=dev),
                                views["uv"], views["pose"][0],
                                views["intrinsics"][0])
    after = {**sk.LAUNCHES, **pair_mlp.LAUNCHES}
    for key in ("select_knn_packed", "pair_sdf_value_agg",
                "pair_sdf_aggregate"):
        assert after[key] > before[key], key
    a, b = outs["cpu"], outs["cuda"]
    for key, v in b.items():
        assert v.shape == a[key].shape
        assert np.isfinite(v.astype(np.float64)).all()
    assert (a["ray_mask"] != b["ray_mask"]).mean() <= 0.01
    both = a["ray_mask"] & b["ray_mask"]
    assert both.mean() > 0.2
    err = np.abs(a["depth_values"] - b["depth_values"])[both]
    assert (err > 2e-3).mean() <= 0.05


_ROWS = ("pair_sdf_rows_grad", "pair_sdf_rows_value",
         "pair_sdf_value_and_input_grad", "pair_sdf_value")


def _rows_kernel_matches_plain(dev, kernel, m):
    """One per-row kernel against its plain version on m seeded rows: the
    launch counter +1, x_pi bit-equal (the same f32 subtraction), s and r
    by ``_within``; K7b's s also bit-equal to K7a's on the same u (one
    kernel body, K7a's without the down sweep)."""
    rng = np.random.default_rng(m)
    lat = rng.normal(0, 0.3, (m, 32))
    xpi = rng.normal(0, 0.03, (m, 3))
    x = rng.uniform(-0.5, 0.5, (m, 3))
    g = np.concatenate([lat, x - xpi], 1)
    u = np.concatenate([lat, xpi], 1)
    args = [torch.from_numpy(a.astype(np.float32)).to(dev)
            for a in ((g, x) if "rows" in kernel else (u,))]
    prior = pair_mlp._prep_layers(load_prior_npz(device=dev), torch.bfloat16)
    fn = getattr(pair_mlp, kernel)
    ref = getattr(pair_mlp, kernel + "_ref")
    before = pair_mlp.LAUNCHES[kernel]
    with torch.no_grad():
        outs, refs = fn(*args, prior), ref(*args, prior)
    torch.cuda.synchronize()
    assert pair_mlp.LAUNCHES[kernel] == before + 1
    if not isinstance(outs, tuple):
        outs, refs = (outs,), (refs,)
    assert len(outs) == len(refs)
    for i, (a, b) in enumerate(zip(outs, refs)):
        assert a.shape == b.shape and a.shape[0] == m
        assert a.dtype == torch.float32 and bool(torch.isfinite(a).all())
        if "rows" in kernel and i == len(outs) - 1:       # x_pi
            assert torch.equal(a, b)
        else:
            _within(a, b, 1e-3)
    if kernel == "pair_sdf_value":
        with torch.no_grad():
            s7a = pair_mlp.pair_sdf_value_and_input_grad(*args, prior)[0]
        assert torch.equal(outs[0], s7a)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1000, 1], ids=["ragged", "one-row"])
@pytest.mark.parametrize("kernel", _ROWS)
def test_pair_rows_kernels_match_plain(cuda, kernel, m):
    """K6a / K6b / K7a / K7b against their plain versions, for a row count
    that is not a whole number of 128-row blocks and for one row."""
    _rows_kernel_matches_plain(cuda, kernel, m)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [127, 128, 129, 40000])
def test_pair_sdf_rows_grad_tile_edges(cuda, m):
    """K6a's tiles of 128 contiguous rows: one row short of a tile, one
    tile, one row past it (a second tile whose second warpgroup has no
    row), and more tiles than the card has SMs, so that each block walks
    several."""
    _rows_kernel_matches_plain(cuda, "pair_sdf_rows_grad", m)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [127, 128, 129, 40000])
def test_pair_sdf_rows_value_tile_edges(cuda, m):
    """K6b on K6a's tiles of 128 contiguous rows, at the same edges."""
    _rows_kernel_matches_plain(cuda, "pair_sdf_rows_value", m)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [127, 128, 129, 40000])
def test_pair_sdf_value_and_input_grad_tile_edges(cuda, m):
    """K7a on K6a's tiles of 128 contiguous rows, at the same edges."""
    _rows_kernel_matches_plain(cuda, "pair_sdf_value_and_input_grad", m)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [127, 128, 129, 40000])
def test_pair_sdf_value_tile_edges(cuda, m):
    """K7b on K6a's tiles of 128 contiguous rows, at the same edges, its s
    bit-equal to K7a's."""
    _rows_kernel_matches_plain(cuda, "pair_sdf_value", m)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1000, 40000])
def test_pair_sdf_value_and_input_grad_is_rows_grad_on_its_rows(cuda, m):
    """K7a runs K6a's kernel with a gather that reads x_pi from u: on
    ``u = [g_lat | K6a's x_pi]`` its s and r are K6a's bit for bit, here on
    rows of which a third are gathered row 0 (masked slots)."""
    rng = np.random.default_rng(m + 2)
    table = np.concatenate([rng.normal(0, 0.3, (50, 32)),
                            rng.uniform(-0.5, 0.5, (50, 3))], 1)
    rows = rng.integers(0, 50, m)
    rows[rng.uniform(size=m) < 0.3] = 0
    g = table[rows]
    x = g[:, 32:] + rng.normal(0, 0.03, (m, 3))
    g, x = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (g, x))
    prior = pair_mlp._prep_layers(load_prior_npz(device=cuda), torch.bfloat16)
    with torch.no_grad():
        s6, r6, xpi = pair_mlp.pair_sdf_rows_grad(g, x, prior)
        s7, r7 = pair_mlp.pair_sdf_value_and_input_grad(
            torch.cat([g[:, :32], xpi], 1), prior)
    torch.cuda.synchronize()
    assert torch.equal(s7, s6)
    assert torch.equal(r7, r6)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1000, 40000])
def test_pair_sdf_rows_value_is_rows_grad_without_its_down_sweep(cuda, m):
    """K6b runs K6a's tiles and up-sweep instructions without the down
    sweep: its s and x_pi are K6a's bit for bit, here on rows of which a
    third are gathered row 0 (masked slots), as the probe has them."""
    rng = np.random.default_rng(m + 1)
    table = np.concatenate([rng.normal(0, 0.3, (50, 32)),
                            rng.uniform(-0.5, 0.5, (50, 3))], 1)
    rows = rng.integers(0, 50, m)
    rows[rng.uniform(size=m) < 0.3] = 0
    g = table[rows]
    x = g[:, 32:] + rng.normal(0, 0.03, (m, 3))
    g, x = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (g, x))
    prior = pair_mlp._prep_layers(load_prior_npz(device=cuda), torch.bfloat16)
    with torch.no_grad():
        s_b, xpi_b = pair_mlp.pair_sdf_rows_value(g, x, prior)
        s_a, _, xpi_a = pair_mlp.pair_sdf_rows_grad(g, x, prior)
    torch.cuda.synchronize()
    assert torch.equal(s_b, s_a)
    assert torch.equal(xpi_b, xpi_a)


def _sum_order_close(what, out, ref, abs_sum, count):
    """Atomic sums against index_add_: the same f32 terms summed in another
    order, held to ``chip_smoke.sum_order_within``'s limit (2 c 2**-24
    sum|terms| for c terms; it exits on a breach)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.sum_order_within(what, out, ref, abs_sum, count)


def _scatter_inputs(kind, m, d, n, stride):
    """K5's inputs: ``random`` indices in [-n/8, n + n/8) with a quarter of
    the rows on one index; ``step`` as a training step has them (40 % of
    the rows all zero at index 0, the rest random, one NaN); ``one-index``
    every row on one index; ``ragged`` (m not a multiple of a tile) random,
    with indices below 0 and at or above n; ``one-row`` one kept row;
    ``outside`` only indices outside [0, n), down to -2**31 and up to
    2**31 - 1."""
    rng = np.random.default_rng(m)
    wide = rng.normal(size=(m, stride)).astype(np.float32)
    idx = rng.integers(-n // 8, n + n // 8, m).astype(np.int32)
    if kind == "random":
        idx[: m // 4] = 3                              # heavy duplicates
    elif kind == "step":
        zero = rng.uniform(size=m) < 0.4
        wide[zero, :d] = 0.0
        idx[zero] = 0
        wide[m // 2, d // 2] = np.nan
        idx[m // 2] = 5
    elif kind == "one-index":
        idx[:] = 3
    elif kind == "one-row":
        idx[:] = n // 2
    elif kind == "outside":
        idx[:] = np.array([-2 ** 31, -1, n, 2 ** 31 - 1], np.int32)[:m]
    return torch.from_numpy(wide), torch.from_numpy(idx)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,m,d,n,stride", [
    ("random", 4096, 32, 512, 32), ("random", 2048, 64, 96, 64),
    ("random", 212992, 64, 6040, 67), ("step", 212992, 64, 6040, 67),
    ("step", 532480, 32, 6040, 35), ("one-index", 5000, 32, 50, 35),
    ("random", 3000, 35, 100, 35), ("random", 3000, 8, 100, 9),
    ("ragged", 257, 64, 96, 67), ("one-row", 1, 32, 10, 35),
    ("outside", 4, 64, 9, 67)])
def test_scatter_add_rows_matches_plain(cuda, kind, m, d, n, stride):
    """K5 against its plain version: duplicates, a hot row of zeros as a
    step has it, every row on one index, tile edges, indices outside
    [0, n) dropped, a NaN that must reach its output entry, widths that
    are and are not a multiple of 4, and a strided ct (the colour
    cotangent's 64 of 67 columns)."""
    wide, idx = _scatter_inputs(kind, m, d, n, stride)
    ct = wide.to(cuda)[:, :d]
    idx = idx.to(cuda)
    before = sr.LAUNCHES["scatter_add_rows"]
    out = sr.scatter_add_rows(ct, idx, n)
    ref = sr.scatter_add_rows_ref(ct, idx, n)
    torch.cuda.synchronize()
    assert sr.LAUNCHES["scatter_add_rows"] == before + 1
    assert out.shape == (n, d)
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    assert int(torch.isnan(ref).sum()) == (1 if kind == "step" else 0)
    ct = torch.nan_to_num(ct, nan=0.0)
    out, ref = (torch.nan_to_num(t, nan=0.0) for t in (out, ref))
    keep = (idx >= 0) & (idx < n)
    count = torch.bincount(idx[keep].long(), minlength=n)
    _sum_order_close("K5", out, ref,
                     sr.scatter_add_rows_ref(ct.abs(), idx, n), count)


@pytest.mark.cuda
def test_pair_sdf_aggregate_bwd_matches_plain(cuda):
    """K4 against its plain version on K3's own residuals: dump rows,
    fully empty points and indices outside the table add nothing."""
    table, idx_ext, x, prior = _pair_inputs(cuda)
    n = table.shape[0] - 1
    with torch.no_grad():
        _, w, r_lat = pair_mlp.pair_sdf_aggregate(table, idx_ext, x, prior,
                                                  RBF)
    num_bar = torch.from_numpy(np.random.default_rng(2).normal(
        size=x.shape[0]).astype(np.float32)).to(cuda)
    before = pair_mlp.LAUNCHES["pair_sdf_aggregate_bwd"]
    out = pair_mlp.pair_sdf_aggregate_bwd(num_bar, w, r_lat, idx_ext, n)
    ref = pair_mlp.pair_sdf_aggregate_bwd_ref(num_bar, w, r_lat, idx_ext, n)
    torch.cuda.synchronize()
    assert pair_mlp.LAUNCHES["pair_sdf_aggregate_bwd"] == before + 1
    assert out.shape == (n, 32) and bool(torch.isfinite(out).all())
    flat = idx_ext.reshape(-1).long()
    keep = (flat >= 0) & (flat < n) & (w != 0)
    abs_sum = pair_mlp.pair_sdf_aggregate_bwd_ref(
        num_bar.abs(), w.abs(), r_lat.abs(), idx_ext, n)
    _sum_order_close("K4", out, ref, abs_sum,
                     torch.bincount(flat[keep], minlength=n))


def _bwd_case(kind, dev):
    """K4's inputs as a training step has them: ``step`` 66,560 points x 8
    (532,480 rows, a launch 1) or ``pseudo`` 1,024 x 8 (a launch 2), about
    half the rows dump rows (index n, w 0) and a few w == 0 rows on real
    indices, into n = 6,040 latent rows; ``hot`` the step with a quarter of
    its rows on one latent row; ``all-dump`` no kept row; ``wide`` the step
    into n = 40,000 > 2**15 latent rows, with indices outside [0, n] too."""
    p, n = (1024, 6040) if kind == "pseudo" else (66560, 6040)
    if kind == "wide":
        n = 40000
    rng = np.random.default_rng(len(kind))
    idx = rng.integers(0, n, (p, 8)).astype(np.int32)
    dump = rng.uniform(size=(p, 8)) < 0.5
    idx[dump] = n
    w = np.where(dump, 0.0, rng.uniform(0.0, 1.0, (p, 8))).astype(np.float32)
    w[~dump & (rng.uniform(size=(p, 8)) < 0.01)] = 0.0
    if kind == "hot":
        hot = rng.uniform(size=(p, 8)) < 0.25
        idx[hot & ~dump] = 17
    elif kind == "all-dump":
        idx[:] = n
        w[:] = 0.0
    elif kind == "wide":
        idx[:5, :2] = np.array([-2 ** 31, -1], np.int32)
        idx[5:10, :2] = np.array([n + 1, 2 ** 31 - 1], np.int32)
    r = torch.from_numpy(rng.normal(0, 0.1, (p * 8, 32)).astype(np.float32))
    num_bar = rng.normal(size=p).astype(np.float32)
    return (torch.from_numpy(num_bar).to(dev),
            torch.from_numpy(w.reshape(-1)).to(dev),
            r.to(torch.bfloat16).to(dev), torch.from_numpy(idx).to(dev), n)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["step", "pseudo", "hot", "all-dump",
                                  "wide"])
def test_pair_sdf_aggregate_bwd_training_shapes(cuda, kind):
    """K4 against its plain version at a training step's two launch sizes,
    with one latent row hit by thousands of rows, with no row kept, and
    into more than 2**15 latent rows: within the f32 sum-order limit, and
    two launches within it of each other (the atomics' order changes)."""
    num_bar, w, r_lat, idx_ext, n = _bwd_case(kind, cuda)
    before = pair_mlp.LAUNCHES["pair_sdf_aggregate_bwd"]
    out = pair_mlp.pair_sdf_aggregate_bwd(num_bar, w, r_lat, idx_ext, n)
    again = pair_mlp.pair_sdf_aggregate_bwd(num_bar, w, r_lat, idx_ext, n)
    ref = pair_mlp.pair_sdf_aggregate_bwd_ref(num_bar, w, r_lat, idx_ext, n)
    torch.cuda.synchronize()
    assert pair_mlp.LAUNCHES["pair_sdf_aggregate_bwd"] == before + 2
    assert out.shape == (n, 32) and bool(torch.isfinite(out).all())
    flat = idx_ext.reshape(-1).long()
    keep = (flat >= 0) & (flat < n) & (w != 0)
    count = torch.bincount(flat[keep], minlength=n)
    if kind == "hot":
        assert int(count.max()) > 1000
    if kind == "all-dump":
        assert not bool(keep.any()) and bool((out == 0).all())
    abs_sum = pair_mlp.pair_sdf_aggregate_bwd_ref(
        num_bar.abs(), w.abs(), r_lat.abs(), idx_ext, n)
    _sum_order_close("K4", out, ref, abs_sum, count)
    _sum_order_close("K4, two launches", again, out, abs_sum, count)


@pytest.mark.cuda
def test_train_steps_through_kernels(cuda):
    """A few Trainer steps on the card launch K1-K5, keep the loss finite
    and skip no step."""
    from spurfies_tpu_torch.train.trainer import Trainer
    pts, cols, views = make_synthetic_scene(n_points=1500, img_res=(24, 40))
    cfg = apply_overrides(Config(), ["model.ray_sampler.n_samples_eval=32",
                                     "train.num_pixels=256"])
    before = {**sk.LAUNCHES, **pair_mlp.LAUNCHES, **sr.LAUNCHES}
    trainer = Trainer(cfg, pts, cols, views, device=cuda)
    trainer.load_frozen(load_prior_npz(device=cuda))
    metrics = []
    trainer.run(4, window=2, callback=lambda s, m: metrics.append(m))
    after = {**sk.LAUNCHES, **pair_mlp.LAUNCHES, **sr.LAUNCHES}
    for key in ("select_knn_packed", "pair_sdf_value_agg",
                "pair_sdf_aggregate", "pair_sdf_aggregate_bwd",
                "scatter_add_rows"):
        assert after[key] > before[key], key
    assert all(np.isfinite(m["loss"]) and m["notfinite"] == 0
               for m in metrics)


@pytest.mark.cuda
@pytest.mark.parametrize("overrides,keys", [
    (["model.fused_agg=false"],
     ("pair_sdf_rows_value", "pair_sdf_rows_grad", "scatter_add_rows")),
    (["model.pair_budget_frac=0.625", "model.color_pair_frac=0.75"],
     ("pair_sdf_value_and_input_grad", "pair_sdf_aggregate_bwd",
      "scatter_add_rows"))], ids=["unfused", "pairs"])
def test_train_steps_under_options_through_kernels(cuda, overrides, keys):
    """A few Trainer steps under ``model.fused_agg=false`` (K6a/K6b, no
    K2/K3/K4) and under the pair-compacted SDF and colour (K7a) launch
    their kernels, keep the loss finite and skip no step."""
    from spurfies_tpu_torch.train.trainer import Trainer
    pts, cols, views = make_synthetic_scene(n_points=1500, img_res=(24, 40))
    cfg = apply_overrides(Config(), ["model.ray_sampler.n_samples_eval=32",
                                     "train.num_pixels=256"] + overrides)
    before = {**pair_mlp.LAUNCHES, **sr.LAUNCHES}
    trainer = Trainer(cfg, pts, cols, views, device=cuda)
    trainer.load_frozen(load_prior_npz(device=cuda))
    metrics = []
    trainer.run(4, window=2, callback=lambda s, m: metrics.append(m))
    after = {**pair_mlp.LAUNCHES, **sr.LAUNCHES}
    for key in keys:
        assert after[key] > before[key], key
    if "model.fused_agg=false" in overrides:
        for key in ("pair_sdf_value_agg", "pair_sdf_aggregate",
                    "pair_sdf_aggregate_bwd"):
            assert after[key] == before[key], key
    assert all(np.isfinite(m["loss"]) and m["notfinite"] == 0
               for m in metrics)


def _colour_inputs(dev, p):
    """K8's inputs for p points: 30 % of the pair slots invalid (wn = 0,
    x_pi of a far row-0 neighbour) and point 0 without any valid
    neighbour; the colour nets of ModelConfig's defaults, seeded."""
    from spurfies_tpu_torch.core.embedder import positional_encoding

    rng = np.random.default_rng(p)
    valid = rng.uniform(size=(p, 8)) > 0.3
    valid[0] = False
    x_pi = rng.normal(0, 0.03, (p, 8, 3))
    x_pi[~valid] = rng.uniform(-1, 1, (int((~valid).sum()), 3))
    w = rng.uniform(0.05, 1.0, (p, 8)) * valid
    den = w.sum(1, keepdims=True)
    dirs = rng.normal(size=(p, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    arr = [x_pi.reshape(-1, 3), rng.normal(0, 0.3, (p * 8, 64)),
           (w / np.where(den > 0, den, 1.0)).reshape(-1), dirs,
           rng.normal(size=(p, 3))]
    x_pi, lat, wn, dirs, rgb_bar = [
        torch.from_numpy(a.astype(np.float32)).to(dev) for a in arr]
    nets = init_model_params(Config().model, torch.Generator().manual_seed(3),
                             device=dev)["train"]
    ins = (x_pi, lat, wn, positional_encoding(dirs, 3).contiguous())
    return ins, nets["F_color"], nets["R"], rgb_bar


def _rel_l2(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1000, 4099, 1],
                         ids=["ragged", "ragged-tiles", "one-point"])
def test_fused_color_kernels_match_plain(cuda, p):
    """K8a and K8b against their plain versions in bf16, for point counts
    that are not a whole number of the kernels' tiles (128 pair rows, 128
    points; 4099 also gives more tiles than SMs) and for one point (which
    has no valid neighbour).  rgb by ``_within``; dlat and every dW/db
    within 4e-2 relative L2: each delta is rounded to bf16 before each
    product, so a rounding that the f32 sums' order moves by one ulp can
    flip a gate and change its row's delta from there down, and at a few
    thousand pairs such rows dominate (the plain version with f64 sums
    reads 1.5e-2 against itself on the CPU, tests/test_torch_fused_color.py;
    chip_smoke.py holds a training step's 212,992 pairs to 1e-2).
    A point without a valid neighbour gets no latent gradient."""
    from spurfies_tpu_torch.ops import fused_color as fc

    ins, f_color, r, rgb_bar = _colour_inputs(cuda, p)
    before = dict(fc.LAUNCHES)
    rgb = fc.fused_color_fwd(*ins, f_color, r, torch.bfloat16)
    rgb_r = fc.fused_color_fwd_ref(*ins, f_color, r, torch.bfloat16)
    dlat, dws, dbs = fc.fused_color_bwd(*ins, f_color, r, rgb_bar,
                                        torch.bfloat16)
    ref = fc.fused_color_bwd_ref(*ins, f_color, r, rgb_bar, torch.bfloat16)
    torch.cuda.synchronize()
    assert fc.LAUNCHES["fused_color_fwd"] == before["fused_color_fwd"] + 1
    assert fc.LAUNCHES["fused_color_bwd"] == before["fused_color_bwd"] + 1
    assert rgb.shape == (p, 3) and bool(torch.isfinite(rgb).all())
    _within(rgb, rgb_r, 1e-3)
    assert dlat.shape == (8 * p, 64) and bool(torch.isfinite(dlat).all())
    assert float(dlat[:8].abs().max()) == 0.0
    assert _rel_l2(dlat, ref[0]) < 4e-2
    for i, (a, b) in enumerate(zip(dws + dbs, ref[1] + ref[2])):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), i
        assert _rel_l2(a, b) < 4e-2, i
    with pytest.raises(ValueError, match="bf16"):
        fc.fused_color_fwd(*ins, f_color, r, torch.float32)


@pytest.mark.cuda
def test_fused_color_bwd_is_deterministic(cuda):
    """K8b sums dW/db in a fixed order (split-K partials, then the splits
    and tiles in order; no atomics): two launches on the same inputs give
    the same bits in dlat and in every dW and db."""
    from spurfies_tpu_torch.ops import fused_color as fc

    ins, f_color, r, rgb_bar = _colour_inputs(cuda, 26624)
    first = fc.fused_color_bwd(*ins, f_color, r, rgb_bar, torch.bfloat16)
    first = [first[0].clone()] + [t.clone() for t in first[1] + first[2]]
    again = fc.fused_color_bwd(*ins, f_color, r, rgb_bar, torch.bfloat16)
    again = [again[0]] + again[1] + again[2]
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(first, again)):
        assert torch.equal(a, b), i


@pytest.mark.cuda
def test_pack_color_weights_matches_plain(cuda):
    """The pack kernel gives the plain pack's bits (the same bf16 rounding
    of each weight, the same swizzled places, zeros elsewhere)."""
    from spurfies_tpu_torch.ops import fused_color as fc

    _, f_color, r, _ = _colour_inputs(cuda, 1)
    before = fc.LAUNCHES["pack_color_weights"]
    out = fc.pack_color_weights(f_color, r)
    ref = fc.pack_color_weights_ref(f_color, r)
    torch.cuda.synchronize()
    assert fc.LAUNCHES["pack_color_weights"] == before + 1
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_train_steps_under_fused_color_through_kernels(cuda):
    """A few Trainer steps with ``field.FUSED_COLOR`` on launch K8a and
    K8b once a step each (and the colour latents' K5), keep the loss
    finite and skip no step."""
    from spurfies_tpu_torch.ops import fused_color as fc
    from spurfies_tpu_torch.train.trainer import Trainer
    pts, cols, views = make_synthetic_scene(n_points=1500, img_res=(24, 40))
    cfg = apply_overrides(Config(), ["model.ray_sampler.n_samples_eval=32",
                                     "train.num_pixels=256"])
    trainer = Trainer(cfg, pts, cols, views, device=cuda)
    trainer.load_frozen(load_prior_npz(device=cuda))
    before = {**fc.LAUNCHES, **sr.LAUNCHES}
    metrics = []
    saved = field.FUSED_COLOR
    try:
        field.FUSED_COLOR = True
        trainer.run(4, window=2, callback=lambda s, m: metrics.append(m))
    finally:
        field.FUSED_COLOR = saved
    after = {**fc.LAUNCHES, **sr.LAUNCHES}
    assert after["fused_color_fwd"] == before["fused_color_fwd"] + 4
    assert after["fused_color_bwd"] == before["fused_color_bwd"] + 4
    assert after["scatter_add_rows"] == before["scatter_add_rows"] + 4
    assert all(np.isfinite(m["loss"]) and m["notfinite"] == 0
               for m in metrics)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,d,rpb", [(655360, 6144, 40, 32), (1, 7, 40, 8),
                                       (1001, 300, 40, 64), (999, 50, 7, 16),
                                       (0, 5, 4, 32)])
def test_gather_rows_matches_plain(cuda, m, n, d, rpb):
    """K9 bit-equal to ``table[idx]`` (float4 rows and scalar rows, a
    ragged last block, no row), one launch a call."""
    from spurfies_tpu_torch.ops import gather_rows as gr

    rng = np.random.default_rng(9)
    table = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)) \
        .to(cuda)
    idx = torch.from_numpy(rng.integers(0, n, m).astype(np.int32)).to(cuda)
    before = gr.LAUNCHES["gather_rows"]
    got = gr.gather_rows(table, idx, rows_per_block=rpb)
    torch.cuda.synchronize()
    assert gr.LAUNCHES["gather_rows"] == before + 1
    assert torch.equal(got, gr.gather_rows_ref(table, idx))


@pytest.mark.cuda
def test_marching_on_the_card_is_the_cpus(cuda):
    """The device marching gives the CPU's faces and vertices bit for bit
    (float64 vertex ops one at a time), with slabs smaller than the grid."""
    from spurfies_tpu_torch.eval.marching import marching_tetrahedra

    rng = np.random.default_rng(2)
    g = np.linspace(-1, 1, 41)
    X, Y, Z = np.meshgrid(g, g[:33], g[:29], indexing="ij")
    sdf = (np.sqrt(X ** 2 + Y ** 2 + Z ** 2) - 0.6
           + 0.01 * rng.normal(size=X.shape)).astype(np.float32)
    for level in (0.0, 0.05):
        vc, fc = marching_tetrahedra(torch.from_numpy(sdf), level,
                                     (0.05, 0.05, 0.05), (-1.0, -1.0, -1.0),
                                     slab_cubes=4000)
        vd, fd = marching_tetrahedra(torch.from_numpy(sdf).to(cuda), level,
                                     (0.05, 0.05, 0.05), (-1.0, -1.0, -1.0),
                                     slab_cubes=4000)
        assert len(fc) > 0
        np.testing.assert_array_equal(fd, fc)
        np.testing.assert_array_equal(vd, vc)


@pytest.mark.cuda
def test_featext_on_the_card_is_the_cpus(cuda):
    """The Vis-MVSNet extractor (random weights in the reference's key
    layout) on the card against the CPU on the same 2x3x192x256 batch:
    f32 with TF32 off on both, so every head within 1e-4 of its scale
    (cuDNN's sum order), and the same on a second call."""
    from spurfies_tpu_torch.convert.torch_ckpt import convert_vismvsnet
    from spurfies_tpu_torch.data.synthetic import random_vismvsnet_state

    state = random_vismvsnet_state(0)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 3, 192, 256)).astype(np.float32))
    with torch.no_grad():
        cpu = convert_vismvsnet(state, "cpu")(x)
        fx = convert_vismvsnet(state, cuda)
        dev = fx(x.to(cuda))
        again = fx(x.to(cuda))
    for a, b, c in zip(dev, cpu, again):
        scale = float(b.abs().max())
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * scale
        assert float((a - c).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_pretraining_step_on_the_card(cuda, monkeypatch):
    """One pretraining step on the card (K1 packed on a shape's table, the
    decoder's double backward in f32) against the same step with K1's
    plain version: the same ids, so the loss within 1e-6 relative and
    every gradient within 1e-5 relative L2 (the latents' gather adds in
    another order on the card); K1 launched once."""
    from spurfies_tpu_torch.prior import pretrain as tpre
    from spurfies_tpu_torch.train.optim import flatten

    cfg = tpre.PriorConfig(n_shapes=2, n_surface_cap=4096, n_query=8192,
                           batch_queries=4096)
    corpus, spec = tpre.build_corpus(cfg, device=cuda)
    params = tpre.init_prior_params(cfg, torch.Generator().manual_seed(0),
                                    cuda)
    qidx = torch.randperm(cfg.n_query, device=cuda)[:cfg.batch_queries]
    before = sk.LAUNCHES["select_knn_packed"]
    loss, _ = tpre.prior_loss(params, corpus, spec, cfg, 1, qidx)
    grads = torch.autograd.grad(loss, flatten(params))
    assert sk.LAUNCHES["select_knn_packed"] == before + 1
    monkeypatch.setattr(vg, "select_knn", sk.select_knn_ref)
    loss_p, _ = tpre.prior_loss(params, corpus, spec, cfg, 1, qidx)
    grads_p = torch.autograd.grad(loss_p, flatten(params))
    assert abs(float(loss) - float(loss_p)) <= 1e-6 * abs(float(loss_p))
    for a, b in zip(grads, grads_p):
        assert torch.isfinite(a).all()
        assert float(torch.linalg.vector_norm(a - b)) <= 1e-5 * float(
            torch.linalg.vector_norm(b)) + 1e-30


@pytest.mark.cuda
def test_prep_cli_on_the_card_is_the_cpus(cuda, tmp_path, monkeypatch):
    """The prep CLI at a tiny DUSt3R (64x64 images, encoder 64 x 2, decoder
    32 x 2) on three random PNGs, on the card and on the CPU: f32 with TF32
    off on both, 20 alignment iterations, so the same number of exported
    points, within 1e-4 of the cloud's scale (the sum orders differ)."""
    import functools

    from spurfies_tpu_torch.cli import prep_pointcloud as cli
    from spurfies_tpu_torch.data.ply import load_ply
    from spurfies_tpu_torch.data.png import write_png
    from spurfies_tpu_torch.prep import dust3r_net as d

    tiny = d.Dust3rConfig(img_size=(64, 64), enc_dim=64, enc_depth=2,
                          enc_heads=4, dec_dim=32, dec_depth=2, dec_heads=2)
    rng = np.random.default_rng(3)
    (tmp_path / "imgs").mkdir()
    for i in range(3):
        write_png(str(tmp_path / "imgs" / f"{i}.png"),
                  rng.integers(0, 255, (64, 64, 3)).astype(np.uint8))
    torch.save(d.random_dust3r_state(tiny), str(tmp_path / "d.pth"))
    monkeypatch.setattr(cli, "Dust3rConfig", lambda img_size: tiny)
    monkeypatch.setattr(cli, "run_inference", functools.partial(
        cli.run_inference, img_size=(64, 64)))
    pts = {}
    for dev in ("cuda", "cpu"):
        cli.main(["--scan", "s", "--images", str(tmp_path / "imgs"),
                  "--ckpt", str(tmp_path / "d.pth"), "--conf", "2.0",
                  "--align-iters", "20", "--device", dev,
                  "--out-root", str(tmp_path / dev)])
        pts[dev], _ = load_ply(str(tmp_path / dev / "own_data" / "s" /
                                   "s.ply"))
    assert len(pts["cuda"]) == len(pts["cpu"]) > 0
    assert np.abs(pts["cuda"] - pts["cpu"]).max() <= 1e-4 * np.abs(
        pts["cpu"]).max()


@pytest.mark.cuda
def test_two_ranks_on_one_card_match_one_rank(cuda):
    """``train.data_parallel=2`` with both ranks on the card over gloo (NCCL
    refuses two ranks on one device), against one unsharded ``Trainer`` on
    the card: two steps of ``tests/test_torch_parallel.py``'s TINY scene,
    by that file's limits (loss parts 1e-5 relative on the first step,
    ``feats_color`` within 5e-4 and every leaf within 2 lr a step after
    the second), the ranks' parameters bit-equal."""
    from _torch_parallel_ranks import STEPS, card_steps, trainer

    from spurfies_tpu_torch.parallel.launch import launch
    from spurfies_tpu_torch.train.optim import flatten

    r0, r1 = launch(card_steps, 2, devices=("cuda:0", "cuda:0"))
    assert r0["backend"] == "gloo"
    tr, _ = trainer([], 1, device="cuda")
    hist = []
    tr.run(STEPS, window=1, callback=lambda s, m: hist.append(m))
    for k, v in hist[0].items():
        assert abs(r0["hist"][0][k] - v) <= 1e-5 * abs(v) + 1e-12, k
    assert r0["hist"] == r1["hist"]
    assert all(np.array_equal(p, q) for p, q in zip(r0["params"],
                                                    r1["params"]))
    tp = tr.state.params
    names = [f"{k}[{i}]" for k in tp for i in range(len(flatten(tp[k])))]
    diff = {n: float(np.abs(p.detach().cpu().numpy() - q).max())
            for n, p, q in zip(names, flatten(tp), r0["params"])}
    assert diff["feats_color[0]"] <= 5e-4, diff
    assert max(diff.values()) <= 2 * tr.cfg.train.learning_rate * STEPS


@pytest.mark.cuda
def test_one_rank_over_nccl_waits_on_nothing(cuda):
    """One rank over NCCL runs the sharded step with its collectives on the
    card: finite, not skipped, and no host sync in a step."""
    from _torch_parallel_ranks import card_steps

    from spurfies_tpu_torch.parallel.launch import launch

    [r] = launch(card_steps, 1, devices=("cuda:0",))
    assert r["backend"] == "nccl"
    assert all(np.isfinite(m["loss"]) and m["notfinite"] == 0
               for m in r["hist"])
    assert r["syncs"] == []
