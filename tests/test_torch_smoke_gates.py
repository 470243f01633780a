"""The tolerance gates of ``chip_smoke.py``, on the CPU.

The smoke test holds each pair-MLP kernel against its plain version with
``within``, a rendered chunk against the plain render with
``compare_chunk``, K4/K5 against their plain versions with
``sum_order_within`` and one training batch's loss and gradients against
the plain versions' with ``compare_grads``.  These tests show that the
gates pass equal inputs and reject a breach, so that a limit which can
never fail is caught here.
"""

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
