"""K9, the row gather of ``scripts/micro_gather.py``, on the CPU.

The JAX script's Pallas kernel (``gather_rows_pallas``, run in interpret
mode as the JAX package runs Pallas on the CPU) against the port's plain
version ``gather_rows_ref``, on the same seeded table and indices: a gather
moves bits, so they must be bit-equal, with a row count that is not a
multiple of the kernel's tile.  The CUDA kernel is held against the plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase 17).
"""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spurfies_tpu_torch.ops import gather_rows as gr
from spurfies_tpu_torch.scripts import micro_gather
from spurfies_tpu_torch.utils.profiling import COUNTS

ROOT = Path(__file__).resolve().parent.parent
_SPEC = importlib.util.spec_from_file_location(
    "jax_micro_gather", ROOT / "scripts" / "micro_gather.py")
jmg = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(jmg)


def _inputs(m, n, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.integers(0, n, m).astype(np.int32))


@pytest.mark.parametrize("m,n,d,tile,unroll", [
    (1000, 300, 40, 256, 8),      # m not a multiple of the tile
    (517, 64, 7, 128, 4),         # d not a multiple of 4
])
def test_gather_rows_matches_the_tpu_kernel(m, n, d, tile, unroll):
    table, idx = _inputs(m, n, d)
    ref = np.asarray(jmg.gather_rows_pallas(jnp.asarray(table),
                                            jnp.asarray(idx), tile=tile,
                                            unroll=unroll, interpret=True))
    got = gr.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.float32 and got.shape == (m, d)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_gather_rows_checks_its_inputs():
    table, idx = _inputs(10, 5, 4)
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    with pytest.raises(ValueError, match=r"table \[n, d\]"):
        gr.gather_rows(t[0], i)
    with pytest.raises(ValueError, match=r"idx \[m\]"):
        gr.gather_rows(t, i[:, None])
    before = COUNTS["gather_rows"]
    gr.gather_rows(t, i)                 # the plain version: no launch
    assert COUNTS["gather_rows"] == before


def test_micro_gather_needs_a_card(monkeypatch, capsys):
    """The microbenchmark times the kernel, so without a card it refuses
    (exit code 2) and prints no timing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert micro_gather.main(["--rows", "64"]) == 2
    assert "ms" not in capsys.readouterr().out
