"""The yardstick's counts: the dense training-step FLOPs, the real pairs a
pair-MLP launch is handed, the roofline bound and the trace reduction."""

import torch

from benchmark import flops, roofline, trace
from benchmark.tests.conftest import bench


def test_dense_train_step_flops():
    b = bench()
    for c in b["configs"]:
        from benchmark.harness import HERE, load_json
        conf = load_json(HERE.parent / c["file"])["config"]
        n = flops.dense_train_step_flops(conf["model"], conf["train"])
        # by hand: 1024 rays; probe 1024 * 128 points * 8 pairs * up;
        # shading 1024 * 80 * 8 pairs * (up + down); colour on the top 32
        # samples: 3 x (8 pairs * F_color 103->256x4 + R 277->256->256->3)
        up = 2 * (35 * 256 + 3 * 256 * 256 + 256)
        down = 2 * (3 * 256 * 256 + 256 * 35)
        fc = 2 * (103 * 256 + 3 * 256 * 256)
        r = 2 * (277 * 256 + 256 * 256 + 256 * 3)
        hand = (1024 * 128 * 8 * up + 1024 * 80 * 8 * (up + down)
                + 3 * 1024 * 32 * (8 * fc + r))
        assert n == hand == 1_348_552_622_080
    assert flops.prior_up_flops() + flops.prior_down_flops() == 822_784
    assert flops.peak_tflops("NVIDIA H100 80GB HBM3") == 989.0


def test_real_pairs_of_a_toy_launch():
    counter = trace.PairCounter()
    idx = torch.tensor([[0, 3, 4, -1], [4, 4, 1, 2]], dtype=torch.int32)
    counter.held["k3"].append((idx, 4))      # N = 4: row 4 is the dump row
    counter.held["k2"].append((idx[:1], 4))
    got = counter.launches()
    assert got == {"k3": [(4, 2, 4, 4)], "k2": [(2, 1, 4, 4)]}
    assert counter.held == {"k3": [], "k2": []}


def test_roofline_bound_counts_real_pairs_only():
    peak = 989e12
    real = roofline.launch_bound_s("k3", 1000, 64, 8, 4000, peak)
    dumps = roofline.launch_bound_s("k3", 0, 64, 8, 4000, peak)
    assert real > dumps
    assert real == 1000 * 822_784 / peak


def test_trace_reduce():
    dev = [("k_a", 0.0, 10.0), ("k_b", 5.0, 20.0), ("Memcpy HtoD", 30.0,
                                                    35.0),
           ("k_a", 50.0, 60.0)]
    host = [("aten::mm", 18.0, 45.0), ("aten::add", 46.0, 55.0)]
    r = trace.reduce(dev, host, 100e-6)
    assert abs(r["busy_s"] - 35e-6) < 1e-12
    assert r["kernels"] == 3
    name, sec = r["breakdown"]["device_ops"][0]
    assert name == "k_a" and abs(sec - 20e-6) < 1e-12
    # gaps 20-30 and 35-50; both middles (25, 42.5) fall in aten::mm
    (name, sec), = r["breakdown"]["idle_gaps"]
    assert name == "aten::mm" and abs(sec - 25e-6) < 1e-12


def test_idle_share_of_the_measured_window():
    class Run:
        trace = {"busy_s": 0.4, "units": 20}     # 20 ms busy a step
        units, window_s = 500, 20.0              # 40 ms a step unprofiled
    assert abs(trace.idle_pct(Run) - 50.0) < 1e-9
    Run.trace = None
    assert trace.idle_pct(Run) is None


def test_precision_modes():
    from benchmark.plain import precision
    x = torch.tensor([0.5 + 2.0 ** -10, 1.0 / 3.0, -7.3])
    try:
        assert torch.equal(precision.q(x), x)
        precision.set_mode("bf16")
        assert torch.equal(precision.q(x), x.to(torch.bfloat16).float())
        precision.set_mode("fp8")
        f8 = precision.q(x)
        assert not torch.equal(f8, x.to(torch.bfloat16).float())
        assert float((f8 - x).abs().max()) < 7.3 / 16
    finally:
        precision.set_mode("f32")
    with __import__("pytest").raises(ValueError):
        precision.set_mode("int4")
