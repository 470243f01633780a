"""The tolerance gates of ``chip_smoke.py``, on the CPU.

The smoke test holds each pair-MLP kernel against its plain version with
``within``, a rendered chunk against the plain render with
``compare_chunk``, K4/K5 against their plain versions with
``sum_order_within`` and one training batch's loss and gradients against
the plain versions' with ``compare_grads``.  These tests show that the
gates pass equal inputs and reject a breach, so that a limit which can
never fail is caught here.
"""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(smoke)


def _ref(seed=0, n=4096, cols=5):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((n, cols)).astype(np.float32))


def test_within_passes_one_ulp_and_rejects_a_rounding_change():
    ref = _ref()
    # one bf16 ulp (2**-8 relative) on every entry stays inside 2**-6
    assert smoke.within("ulp", ref * (1 + 2.0 ** -8), ref) > 0
    # a 2**-5 relative change on every entry breaches the 99.9% share
    with pytest.raises(SystemExit):
        smoke.within("rounding", ref * (1 + 2.0 ** -5), ref)
    # a single entry off by a tenth of its column's scale breaches the max
    bad = ref.clone()
    bad[7, 2] += 0.1 * float(ref[:, 2].abs().max())
    with pytest.raises(SystemExit):
        smoke.within("one entry", bad, ref)
    # a control reading is printed and never held to the limits
    assert smoke.within("control", ref * (1 + 2.0 ** -5), ref,
                        hold=False) > 0


def test_within_holds_the_max_on_the_kept_rows():
    """With ``keep``, a masked row's large error reads beside the limit and
    passes; the same error on a kept row breaches; the share rule counts
    every row either way."""
    ref = _ref(cols=3)
    keep = torch.ones(ref.shape[0], dtype=torch.bool)
    keep[11] = False
    bad = ref.clone()
    bad[11, 1] += 0.1 * float(ref[:, 1].abs().max())
    assert smoke.within("masked row", bad, ref, keep=keep) > 0
    keep[11] = True
    with pytest.raises(SystemExit):
        smoke.within("kept row", bad, ref, keep=keep)
    keep[:] = False
    keep[:100] = True
    with pytest.raises(SystemExit):            # the share counts every row
        smoke.within("share", ref * (1 + 2.0 ** -5), ref, keep=keep)


def _chunk(seed=0, n=2048):
    rng = np.random.default_rng(seed)
    return {"ray_mask": torch.as_tensor(rng.random(n) < 0.7),
            "depth_values": torch.as_tensor(rng.random((n, 1)) * 4),
            "acc": torch.as_tensor(rng.random((n, 1))),
            "normal_map": torch.as_tensor(rng.standard_normal((n, 3))),
            "rgb_values": torch.as_tensor(rng.random((n, 3)))}


@pytest.mark.parametrize("key,shift", [("depth_values", 1e-2),
                                       ("normal_map", 5e-2)])
def test_compare_chunk_passes_equal_renders_and_rejects_a_shift(key, shift):
    a = _chunk()
    stats = smoke.compare_chunk(a, {k: v.clone() for k, v in a.items()})
    assert stats["same_sample_share"] == 1.0
    # the same shift on every ray: depth beyond 2e-3 on all rays breaches
    # its 5% share; normals beyond 1e-2 on all same-sample rays, its 1%
    b = {k: v.clone() for k, v in a.items()}
    b[key] = b[key] + shift
    with pytest.raises(SystemExit):
        smoke.compare_chunk(a, b)


def test_sum_order_within_passes_a_reordered_sum_and_rejects_more():
    """A sum of the same terms in another order stays inside the limit;
    one entry moved by 1e-5 of its scale (far beyond f32 reordering of a
    few terms) does not."""
    rng = np.random.default_rng(4)
    terms = torch.as_tensor(rng.standard_normal((3000, 16)).astype(
        np.float32))
    idx = torch.as_tensor(rng.integers(0, 50, 3000))
    ref = torch.zeros(50, 16).index_add_(0, idx, terms)
    perm = torch.as_tensor(rng.permutation(3000))
    other = torch.zeros(50, 16).index_add_(0, idx[perm], terms[perm])
    abs_sum = torch.zeros(50, 16).index_add_(0, idx, terms.abs())
    count = torch.bincount(idx, minlength=50)
    assert smoke.sum_order_within("reordered", other, ref, abs_sum,
                                  count) >= 0
    bad = other.clone()
    bad[3, 5] += 1e-5 * float(abs_sum[3, 5])
    with pytest.raises(SystemExit):
        smoke.sum_order_within("moved", bad, ref, abs_sum, count)
    assert smoke.sum_order_within("control", bad, ref, abs_sum, count,
                                  hold=False) > 0


def _grads(seed=0):
    rng = np.random.default_rng(seed)
    parts = {"loss": 0.3, "rgb_loss": 0.1, "tv_loss": 0.2}
    grads = {f"g{i}": torch.as_tensor(rng.standard_normal((40, 8)).astype(
        np.float32)) for i in range(3)}
    return parts, grads


@pytest.mark.parametrize("what", ["part", "grad", "nan"])
def test_compare_grads_passes_equal_and_rejects_a_breach(what):
    parts, grads = _grads()
    assert smoke.compare_grads(parts, grads, dict(parts),
                               {k: v.clone() for k, v in grads.items()}) \
        == (0.0, 0.0)
    parts_k = dict(parts)
    grads_k = {k: v.clone() for k, v in grads.items()}
    if what == "part":                      # 2e-3 relative on one part
        parts_k["rgb_loss"] *= 1 + 2e-3
    elif what == "grad":                    # 2e-2 relative L2 on one leaf
        grads_k["g1"] = grads_k["g1"] * (1 + 2e-2)
    else:
        grads_k["g2"][0, 0] = float("nan")
    with pytest.raises(SystemExit):
        smoke.compare_grads(parts_k, grads_k, parts, grads)


def test_rel_l2_within_passes_inside_and_rejects_beyond():
    """K8b's dW/db gate: a 0.5 % relative change passes the 1e-2 limit, a
    2 % one breaches it; a control reading is printed and never held."""
    ref = _ref(cols=8)
    assert smoke.rel_l2_within("inside", ref * 1.005, ref, 1e-2) > 0
    with pytest.raises(SystemExit):
        smoke.rel_l2_within("beyond", ref * 1.02, ref, 1e-2)
    assert smoke.rel_l2_within("control", ref * 1.02, ref, 1e-2,
                               hold=False) > 0


def test_ptxas_report_names_each_entry_function():
    """Phase 2 reads each kernel's registers and spills from the build's
    ``-Xptxas -v`` log by entry function: K3, K2 and K6a share one source,
    so a spill must be pinned on the kernel that has it."""
    from spurfies_tpu_torch.ops import cuda_build

    k3 = "_ZN12_GLOBAL__N_114sdf_agg_kernelEPKfiPKiS2_ii"
    k2 = "_ZN12_GLOBAL__N_116value_agg_kernelEPKfiPKiS2_ii"
    note = ("ptxas info    : (C7519) warpgroup.arrive is injected in around "
            f"line 1878 by compiler to allow use of registers in GMMA in "
            f"function '{k3}'")
    log = "\n".join([
        note,
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{k3}' for 'sm_90a'",
        f"ptxas info    : Function properties for {k3}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, 452 bytes cmem[0]",
        f"ptxas info    : Compiling entry function '{k2}' for 'sm_90a'",
        f"ptxas info    : Function properties for {k2}",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 168 registers, 452 bytes cmem[0]"])
    report = cuda_build.ptxas_report(log)
    assert list(report) == [k3, k2]
    assert report[k3] == [
        note,
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, 452 bytes cmem[0]"]
    assert "4 bytes spill stores" in report[k2][0]
    assert cuda_build.ptxas_report("ptxas info    : 0 bytes gmem") == {}


def test_profile_summary_sums_the_device_kernels_of_a_label():
    """A kernels-line label with several device kernels (K8a: the pair and
    point kernels; K8b: each piece of its backward) gets the sum of their
    device times, each of them listed in ``kernel_parts_ms``, and a kernel
    of no label adds to the busy time only."""
    from torch.autograd import DeviceType

    class Evt:
        def __init__(self, key, us, dev=DeviceType.CUDA):
            self.key, self.self_device_time_total = key, us
            self.device_type, self.is_user_annotation = dev, False

    class Prof:
        def key_averages(self):
            return [Evt("void wg::color_pair_fwd_kernel(float const*)", 700.0),
                    Evt("void wg::color_point_fwd_kernel(bf16 const*)", 300.0),
                    Evt("void wg::color_pack_kernel(PackSegs)", 5.0),
                    Evt("void other_kernel()", 1000.0),
                    Evt("aten::mm", 1000.0, DeviceType.CPU)]

    labels = {lb for lb, _ in smoke.KERNEL_NAMES}
    assert sum(lb == "K8a fused_color_fwd" for lb, _ in
               smoke.KERNEL_NAMES) >= 2
    out = smoke.profile_summary(Prof(), 10.0)
    assert out["kernel_ms"]["K8a fused_color_fwd"] == 1.0
    assert out["kernel_parts_ms"]["color_pair_fwd_kernel"] == 0.7
    assert out["kernel_parts_ms"]["color_point_fwd_kernel"] == 0.3
    assert out["kernel_parts_ms"]["color_dw_kernel"] == 0.0
    assert "color_pack_kernel" not in out["kernel_parts_ms"]
    assert out["kernel_ms"]["K8p pack_color_weights"] == 0.005
    assert set(out["kernel_ms"]) == labels
    assert out["device_busy_ms"] == 2.005
    assert out["pytorch_ops_ms"] == {"aten::mm": 1.0}


def test_k5_inputs_study_counts_what_k5_depends_on():
    """``k5_inputs_study`` on a hand-made launch of 10 rows, n = 4: rows
    0-2 are zero at index 0 (one of them -0), row 3 is non-zero at index
    0, rows 4-6 share index 2, row 7 lies outside [0, n), rows 8-9 sit at
    index 1 and 2 in the second 8-row tile."""
    ct = torch.ones(10, 3)
    ct[:3] = 0.0
    ct[1, 1] = -0.0
    idx = torch.tensor([0, 0, 0, 0, 2, 2, 2, 4, 1, 2], dtype=torch.int32)
    got = smoke.k5_inputs_study(ct, idx, 4, tiles=(8, 16))
    assert got["kept"] == 9 and got["nonzero_kept"] == 6
    assert got["zero_rows_share"] == pytest.approx(0.3)
    assert got["hottest_index"] == 0 and got["rows_at_hottest"] == 4
    assert got["nonzero_rows_at_hottest"] == 1
    # tile 0 holds indices {0, 2} (4 at n dropped), tile 1 {1, 2}
    assert got["distinct_T8"] == 4 and got["distinct_nonzero_T8"] == 4
    assert got["distinct_T16"] == 3 and got["distinct_nonzero_T16"] == 3


def test_k1_inputs_study_counts_what_k1_depends_on():
    """``k1_inputs_study`` on a hand-made launch: 40 queries (a warp of 32
    and a ragged one of 8) over three cells whose lists hold 4, 2 and 0
    candidates; queries 0-15 in cell 0, 16-31 in cell 1, 32-35 in cell 2
    and 36-39 outside the grid.  Every candidate of cell 0 lies inside the
    radius of its queries, none of cell 1's."""
    qidx = torch.full((3, 6), -1, dtype=torch.int32)
    qidx[0, :4] = torch.tensor([5, 6, 7, 8])
    qidx[1, :2] = torch.tensor([1, 2])
    qpos = torch.full((3, 3, 6), float("inf"))
    qpos[0, :, :4] = 0.0
    qpos[1, :, :2] = 1.0
    x = torch.zeros(40, 3)
    cid = torch.tensor([0] * 16 + [1] * 16 + [2] * 4 + [-1, 3, 9, -5],
                       dtype=torch.int32)
    got = smoke.k1_inputs_study(x, cid, qidx, qpos, 0.01, 8)
    assert got["queries"] == 40 and got["qcap"] == 6
    assert got["in_grid_share"] == pytest.approx(0.9)
    assert got["list_mean"] == pytest.approx((16 * 4 + 16 * 2) / 40)
    # warp 0's longest list is 4, warp 1's (cell 2 and outside) 0
    assert got["warp_max_mean"] == pytest.approx(2.0)
    assert got["list_max"] == 4
    # 96 candidates walked in 32 lanes x (4 + 0) steps
    assert got["idle_lane_share"] == pytest.approx(1 - 96 / (32 * 4))
    assert got["inside_radius_mean"] == pytest.approx(16 * 4 / 40)
    assert got["inside_radius_ge_k_share"] == 0.0
    assert got["cells_per_warp_mean"] == pytest.approx(1.5)
    assert got["cells_per_warp_max"] == 2


@pytest.mark.parametrize("key,first", [("ms", "K1"), ("kernel_ms", "K3")])
def test_redesign_order_ranks_by_the_chosen_time(key, first):
    """``redesign_order`` scores launches x (time - bound) with the render
    and microbenchmark launches at the row's shape, the training ones at
    its ``train_shape`` and the evaluation's at its ``eval_shape``;
    ``key="kernel_ms"`` takes the C entry's time where a row has one (here
    K1: its wrapper's host time drops out)."""
    rows = [{"name": "K1", "launches_render": 10, "launches_microbench": 0,
             "launches_train": 100, "launches_eval": 5, "ms": 0.06,
             "kernel_ms": 0.02, "bound_ms": 0.01,
             "train_shape": {"ms": 0.05, "kernel_ms": 0.006,
                             "bound_ms": 0.004},
             "eval_shape": {"ms": 0.04, "kernel_ms": 0.01,
                            "bound_ms": 0.005}},
            {"name": "K3", "launches_render": 10, "launches_microbench": 0,
             "launches_train": 0, "ms": 0.5, "bound_ms": 0.2}]
    order = smoke.redesign_order(rows, key)
    assert order[0][0] == first
    scores = dict(order)
    assert scores["K3"] == pytest.approx(3.0)
    want = (10 * 0.05 + 100 * 0.046 + 5 * 0.035) if key == "ms" else \
        (10 * 0.01 + 100 * 0.002 + 5 * 0.005)
    assert scores["K1"] == pytest.approx(want)


def _kink_case(m=2000, seed=0):
    """A small random prior (35 -> 16 x 4 -> 1, bf16), ``m`` random pair
    rows u and their plain r; and rows whose plain r, recomputed alone with
    the gate of their nearest-kink unit flipped (a unit with margin below
    2**-5), moves some entry by more than 0.05 of its column's scale."""
    from spurfies_tpu_torch.ops import pair_mlp as pm

    rng = np.random.default_rng(seed)
    widths = [35, 16, 16, 16, 16, 1]
    ws = [torch.as_tensor(rng.normal(size=(a, b)) / np.sqrt(a),
                          dtype=torch.bfloat16)
          for a, b in zip(widths[:-1], widths[1:])]
    bs = [torch.as_tensor(rng.normal(size=(1, b)) * 0.1, dtype=torch.float32)
          for b in widths[1:]]
    layers = pm.PriorLayers(ws, bs, 4, torch.bfloat16)
    u = torch.as_tensor(rng.normal(size=(m, 35)), dtype=torch.float32)
    ref = pm.pair_sdf_value_and_input_grad_ref(u, layers)[1]
    scale = ref.abs().amax(0, keepdim=True) + 1e-30
    flips = []
    for row in range(m):
        gates, margins = smoke.gate_margins(u[row:row + 1, :32],
                                            u[row:row + 1, 32:], layers)
        unit = int(margins.argmin())
        if float(margins[unit]) >= smoke.KINK_MARGIN:
            continue
        r = smoke.flipped_r(layers, gates, unit)
        if float(((r - ref[row]).abs() / scale).max()) > 0.1:
            flips.append((row, r[0]))
        if len(flips) == 4:
            break
    assert len(flips) == 4
    return layers, u, ref, scale, flips


def _rows_of(u):
    return lambda rows: (u[rows, :32], u[rows, 32:])


def test_within_passes_a_row_flipped_on_its_kink():
    """A row of r that is its plain row with one near-kink gate flipped
    breaches the 0.05 rule alone, and passes as a kink flip."""
    layers, u, ref, _, flips = _kink_case()
    out = ref.clone()
    out[flips[0][0]] = flips[0][1]
    with pytest.raises(SystemExit):
        smoke.within("no kink rule", out, ref)
    assert smoke.within("one kink flip", out, ref,
                        kink=(layers, _rows_of(u))) > 0
    stats = smoke.explain_kinks("stats", out, ref,
                                ref.abs().amax(0, keepdim=True) + 1e-30,
                                layers, _rows_of(u))
    assert stats["rows"] == 1 and stats["worst_residual"] == 0.0
    assert stats["worst_margin"] < smoke.KINK_MARGIN


def test_within_rejects_a_kink_row_off_by_a_tenth():
    """The same flipped row with one entry moved by 0.1 of its column's
    scale is no kink flip: it fails."""
    layers, u, ref, scale, flips = _kink_case()
    out = ref.clone()
    out[flips[0][0]] = flips[0][1]
    out[flips[0][0], 3] += 0.1 * float(scale[0, 3])
    with pytest.raises(SystemExit, match="not one gate flipped"):
        smoke.within("kink row + 0.1", out, ref, kink=(layers, _rows_of(u)))


def test_within_rejects_kink_flips_above_their_share():
    """More flipped rows than 0.1 % of the rows fail, each one explained or
    not (2,000 rows: at most 2)."""
    layers, u, ref, _, flips = _kink_case()
    out = ref.clone()
    for row, r in flips[:2]:
        out[row] = r
    assert smoke.within("two kink flips", out, ref,
                        kink=(layers, _rows_of(u))) > 0
    for row, r in flips[2:3]:
        out[row] = r
    with pytest.raises(SystemExit, match="kink flips may be at most"):
        smoke.within("three kink flips", out, ref,
                     kink=(layers, _rows_of(u)))


@pytest.mark.parametrize("psnr, err, ok", [
    (17.0, 0.0299, True),          # on the PSNR margin, inside the radius's
    (25.0, 0.001, True),           # better than JAX on both
    (16.99, 0.02, False),          # 3.01 dB below JAX
    (20.0, 0.0301, False),         # 0.0101 above JAX
    (float("nan"), 0.02, False),   # no PSNR
    (20.0, float("nan"), False),   # an empty mesh
])
def test_validate_gate_holds_phase_24s_margins(psnr, err, ok):
    """Phase 24 passes the port's sphere at JAX's masked PSNR less 3 dB
    and JAX's mean radius error plus 0.01, and rejects a breach of either
    or a NaN (the script reports an empty mesh as NaN)."""
    ref = {"masked_psnr": 20.0, "mesh_mean_radius_err": 0.02}
    got = {"masked_psnr": psnr, "mesh_mean_radius_err": err}
    if ok:
        smoke.validate_gate(got, ref)
    else:
        with pytest.raises(SystemExit):
            smoke.validate_gate(got, ref)


def test_validate_gate_reference_is_the_jax_scripts_cpu_run():
    """The default reference is filled with finite numbers: the JAX
    script's JSON at VALIDATE_STEPS steps, as PERF.md records it."""
    ref = smoke.JAX_VALIDATE
    assert smoke.VALIDATE_STEPS == 1000
    assert np.isfinite(ref["masked_psnr"]) and ref["masked_psnr"] > 10
    assert 0 < ref["mesh_mean_radius_err"] < 0.1
