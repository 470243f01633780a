"""The control, the reference in scaled fp8 in the program's place, fails
the cell's limits (at a size a test run holds; on the card it runs at the
cell's size through ``python -m benchmark.control``)."""

import numpy as np
import pytest

from benchmark import harness


@pytest.mark.parametrize("cell", ["own_data.train", "dtu_pn.train"])
def test_train_control_fails(cell, spec_of):
    from benchmark.entries import train
    from benchmark.plain.check_train import compare, reference_train

    spec = spec_of(cell)
    spec["mix"] = dict(spec["mix"], warmup_steps=0)
    run = harness.Run(spec, 2**31 + 3, "cpu", 0.0)
    train.setup(run)
    inputs, prog = run.state["inputs"], run.state["program"]
    ref = reference_train(inputs, "cpu", prog["width"])
    ctl = reference_train(inputs, "cpu", prog["width"], mode="fp8")
    gaps = dict(compare(ctl, ref))
    assert any(gaps[k] > v for k, v in spec["limits"].items()), gaps
    sound = dict(compare(prog, ref))
    assert all(sound[k] <= v for k, v in spec["limits"].items()), sound


@pytest.mark.parametrize("cell", ["dtu_pn.render"])
def test_render_control_fails(cell, spec_of):
    from benchmark.control import base_as_full
    from benchmark.entries import render
    from benchmark.plain.check_render import compare, reference_render

    spec = spec_of(cell)
    run = harness.Run(spec, 2**31 + 5, "cpu", 0.0)
    render.setup(run)
    v, prog = render._render(run, 1)
    inputs = dict(run.state["inputs"], eval=run.state["eval"], view=v)
    rays, ref = reference_render(inputs, "cpu", np.random.default_rng(1), 3)
    _, ctl = reference_render(inputs, "cpu", np.random.default_rng(1), 3,
                              mode="fp8")
    gaps = dict(compare(base_as_full(ref, rays, prog), rays, ctl))
    assert any(gaps[k] > v for k, v in spec["limits"].items()), gaps
