"""The port's CUDA kernels on the card, against their plain versions.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch and a card (``tests/conftest.py`` sets JAX up, and
``--noconftest`` leaves it out):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Without a card every test skips.  Inputs are made with numpy from a seed.
"""

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


def _pair_inputs(dev, m=1000, k=8):
    """m points (not a whole number of CUDA blocks, so the wrapper pads),
    each with k neighbours scattered around it; 30 % of the pairs and the
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
    _within(r_lat, r_r, 1e-3)


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


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1000, 1], ids=["ragged", "one-row"])
@pytest.mark.parametrize("kernel", _ROWS)
def test_pair_rows_kernels_match_plain(cuda, kernel, m):
    """K6a / K6b / K7a / K7b against their plain versions, for a row count
    that is not a whole number of 128-row blocks and for one row: x_pi
    bit-equal (the same f32 subtraction), s and r by ``_within``."""
    rng = np.random.default_rng(m)
    lat = rng.normal(0, 0.3, (m, 32))
    xpi = rng.normal(0, 0.03, (m, 3))
    x = rng.uniform(-0.5, 0.5, (m, 3))
    g = np.concatenate([lat, x - xpi], 1)
    u = np.concatenate([lat, xpi], 1)
    args = [torch.from_numpy(a.astype(np.float32)).to(cuda)
            for a in ((g, x) if "rows" in kernel else (u,))]
    prior = pair_mlp._prep_layers(load_prior_npz(device=cuda), torch.bfloat16)
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


def _sum_order_close(what, out, ref, abs_sum, count):
    """Atomic sums against index_add_: the same f32 terms summed in another
    order, held to ``chip_smoke.sum_order_within``'s limit (2 c 2**-24
    sum|terms| for c terms; it exits on a breach)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.sum_order_within(what, out, ref, abs_sum, count)


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,n,stride", [(4096, 32, 512, 32),
                                          (2048, 64, 96, 64),
                                          (212992, 64, 6040, 67)])
def test_scatter_add_rows_matches_plain(cuda, m, d, n, stride):
    """K5 against its plain version: duplicates, indices outside [0, n)
    dropped, and a strided ct (the colour cotangent's 64 of 67 columns)."""
    rng = np.random.default_rng(m)
    wide = torch.from_numpy(rng.normal(size=(m, stride)).astype(np.float32))
    ct = wide.to(cuda)[:, :d]
    idx = rng.integers(-n // 8, n + n // 8, m).astype(np.int32)
    idx[: m // 4] = 3                                  # heavy duplicates
    idx = torch.from_numpy(idx).to(cuda)
    before = sr.LAUNCHES["scatter_add_rows"]
    out = sr.scatter_add_rows(ct, idx, n)
    ref = sr.scatter_add_rows_ref(ct, idx, n)
    torch.cuda.synchronize()
    assert sr.LAUNCHES["scatter_add_rows"] == before + 1
    assert out.shape == (n, d)
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
@pytest.mark.parametrize("p", [1000, 1], ids=["ragged", "one-point"])
def test_fused_color_kernels_match_plain(cuda, p):
    """K8a and K8b against their plain versions in bf16, for a point count
    that is not a whole number of 16-point blocks and for one point (which
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
