"""The tolerance gates of ``chip_smoke.py``, on the CPU.

The smoke test holds each pair-MLP kernel against its plain version with
``within`` and a rendered chunk against the plain render with
``compare_chunk``.  These tests show that the gates pass equal inputs and
reject a breach, so that a limit which can never fail is caught here.
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
