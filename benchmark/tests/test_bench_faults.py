"""The check catches a broken timed path: the program is broken
underneath a rehearsal of the cell and ``correct`` must come out false,
once for each fault the cell can have."""

import contextlib

import pytest

from benchmark import harness


@contextlib.contextmanager
def state_unchanged():
    from spurfies_tpu_torch.train import optim
    saved = optim.Optimizer.step
    optim.Optimizer.step = lambda self, params, grads, state: state
    try:
        yield
    finally:
        optim.Optimizer.step = saved


@contextlib.contextmanager
def half_batch():
    from spurfies_tpu_torch.train import trainer
    saved = trainer.total_loss

    def half(out, gt, cfg, step=None, count_fn=None):
        n = gt["rgb"].shape[0]
        out = {k: (v[:n // 2] if hasattr(v, "ndim") and v.ndim and
                   v.shape[0] == n else v) for k, v in out.items()}
        gt = {k: v[:n // 2] for k, v in gt.items()}
        return saved(out, gt, cfg, step=step, count_fn=count_fn)

    trainer.total_loss = half
    try:
        yield
    finally:
        trainer.total_loss = saved


@contextlib.contextmanager
def sdf_altered():
    from spurfies_tpu_torch.ops import pair_mlp
    saved = pair_mlp.pair_sdf_aggregate

    def altered(table, idx_ext, x, layers, rbf):
        pt, w, r = saved(table, idx_ext, x, layers, rbf)
        pt = pt.clone()
        pt[:, 0] += 5e-2 * pt[:, 1]          # every SDF + 0.05
        return pt, w, r

    pair_mlp.pair_sdf_aggregate = altered
    try:
        yield
    finally:
        pair_mlp.pair_sdf_aggregate = saved


@contextlib.contextmanager
def color_altered():
    from spurfies_tpu_torch.model import field
    saved = field.aggregate_color

    def altered(*args, **kwargs):
        return saved(*args, **kwargs) + 5e-2   # every colour + 0.05

    field.aggregate_color = altered
    try:
        yield
    finally:
        field.aggregate_color = saved


@pytest.mark.parametrize("cell,fault", [
    (cell, fault) for cell in ("own_data.train", "dtu_pn.train")
    for fault in (state_unchanged, half_batch, sdf_altered)]
    + [("dtu_pn.render", sdf_altered), ("dtu_pn.render", color_altered)])
def test_fault_is_caught(cell, fault, spec_of):
    spec = spec_of(cell)
    with fault():
        run, result = harness.run_cell(spec, 2**31 + 11, 0.2, False, "cpu")
    assert not result["correct"], run.compared
