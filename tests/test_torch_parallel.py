"""``train.data_parallel`` on the CPU: the port's ray sharding
(``spurfies_tpu_torch.parallel``) against the unsharded port and against
the JAX package's sharded step (``make_train_step(..., mesh=make_mesh(2))``
on conftest's virtual devices).

The two-rank cases run in one spawn of two gloo ranks
(``_torch_parallel_ranks.cases``), which the module fixture starts once;
before it, ``cli.train.main`` starts two ranks of its own for a tiny run
that the spawned ranks then resume.  Everything else runs in this process,
while the ranks run.
"""

import _torch_threads  # noqa: F401  (caps torch's threads under xdist)

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import _torch_parallel_ranks as ranks
from test_torch_pair_mlp import jax_fused
from test_torch_render import scene_to_numpy
from test_torch_train import (  # noqa: F401  (world: the fixture)
    BUDGET,
    OVERRIDES,
    TRAINED,
    _configs,
    _leaf_names,
    _ordered,
    jax_batch_draws,
    jax_render_draws,
    world,
)

from spurfies_tpu.parallel.mesh import make_mesh
from spurfies_tpu.train import trainer as jtrainer
from spurfies_tpu.train.optim import build_optimizer
from spurfies_tpu_torch.cli import train as cli_train
from spurfies_tpu_torch.config import Config, apply_overrides
from spurfies_tpu_torch.data.synthetic import export_synthetic_own_data
from spurfies_tpu_torch.model import renderer as tren
from spurfies_tpu_torch.model import sampler as tsampler
from spurfies_tpu_torch.model.losses import eikonal_loss
from spurfies_tpu_torch.parallel import launch as tlaunch
from spurfies_tpu_torch.parallel import mesh as tmesh
from spurfies_tpu_torch.train.optim import flatten

CPU2 = ("cpu", "cpu")
# a tiny own-data scene through the CLI (tests/test_torch_utils.py's fleet
# overrides), 32 rays a step split over two ranks
CLI = ["dataset.data_dir=own_data", "model.max_shading_pts=8",
       "model.ray_sampler.near=0.5", "model.ray_sampler.far=3.0",
       "model.ray_sampler.n_samples=8", "model.ray_sampler.n_samples_eval=16",
       "model.ray_sampler.n_samples_extra=4", "train.num_pixels=32",
       "train.render_freq=2", "train.checkpoint_freq=1000",
       "train.data_parallel=2"]


def _quiet_launch(fn, n, *args, **kwargs):
    """``parallel.launch.launch`` with the ranks' tensorboard import
    blocked (it would load TensorFlow into each)."""
    return tlaunch.launch(ranks.with_no_tensorboard, n, fn, *args, **kwargs)


# one rank of a run as ``torchrun`` starts it: ``RANK``, ``WORLD_SIZE``,
# ``MASTER_ADDR`` and ``MASTER_PORT`` set, the CLI run in a process of its
# own; it prints the group that ``parallel.launch`` joined and what
# ``cli.train.main`` returned
TORCHRUN_RANK = """
import json, sys
sys.modules["torch.utils.tensorboard"] = None
import torch
torch.set_num_threads(1)
from spurfies_tpu_torch.cli import train
from spurfies_tpu_torch.parallel import mesh
seen = []
join = mesh.set_current
mesh.set_current = lambda g: (seen.append(g), join(g))
(trainer, exp), = train.main(sys.argv[1:])
g = seen[0]
print(json.dumps({"rank": g.rank, "world": g.world, "device": str(g.device),
                  "backend": g.backend, "trainer": trainer is None,
                  "dir": exp.dir, "left": mesh.current() is None}))
"""


def _torchrun(argv, n, cwd):
    """``n`` processes of :data:`TORCHRUN_RANK` on ``argv``, started."""
    env = dict(os.environ, WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(tlaunch._free_port()), OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    return [subprocess.Popen(
        [sys.executable, "-c", TORCHRUN_RANK] + argv, cwd=cwd,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]


def _listing(exps, scan):
    root = os.path.join(exps, f"ours_{scan}")
    stamps = sorted(os.listdir(root))
    return stamps, sorted(os.listdir(os.path.join(root, stamps[0],
                                                  "checkpoints")))


@pytest.fixture(scope="module")
def spawned(request, tmp_path_factory):
    """A two-rank CLI run started by ``cli.train.main`` itself, then one
    spawn of the two-rank cases (which resume that run and run the fleet);
    meanwhile, here, ``tests/test_torch_train.py``'s world, the JAX dp=2
    step on it and the unsharded port's runs."""
    root = tmp_path_factory.mktemp("dp")
    data, exps = str(root / "data"), str(root / "exps")
    for scan in ("s0", "s1"):
        export_synthetic_own_data(data, scan, n_points=800, n_views=3,
                                  img_res=(16, 16))
    cli_argv = ["--scans", "s0", "--device", "cpu",
                f"dataset.data_dir_root={data}", f"exps_folder={exps}"] + CLI
    fleet_argv = ["--scans", "s0,s1", "--num-hosts", "2", "--device", "cpu",
                  f"dataset.data_dir_root={data}",
                  f"exps_folder={root / 'fleet'}", "train.opt_steps=2"] + CLI
    torchrun = _torchrun(["--scans", "s0", "--device", "cpu",
                          f"dataset.data_dir_root={data}",
                          f"exps_folder={root / 'torchrun'}",
                          "train.opt_steps=2"] + CLI, 2, str(root))
    request.addfinalizer(lambda: [p.kill() for p in torchrun
                                  if p.poll() is None])
    pool = ThreadPoolExecutor(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli_train, "launch", _quiet_launch)
        first = pool.submit(cli_train.main, cli_argv + ["train.opt_steps=2"])
        world = request.getfixturevalue("world")
        cfg, tcfg = _configs(BUDGET)
        key = jax.random.PRNGKey(21)
        views = world["views"]
        v, pix = jax_batch_draws(jax.random.fold_in(key, 0), views,
                                 cfg.train.num_pixels)
        draws = jax_render_draws(jax.random.fold_in(key, 1),
                                 cfg.train.num_pixels, tcfg.model)
        first = first.result()
    first_listing = _listing(exps, "s0")
    world_np = {"views": views, "tp": _ordered(world["tp"], world["tp"]),
                "scene": scene_to_numpy(world["scene"], n_points=0)}
    res = pool.submit(
        tlaunch.launch, ranks.cases, 2, world_np,
        {k: d.numpy() for k, d in draws.items()}, v.numpy(), pix.numpy(),
        OVERRIDES + BUDGET, cli_argv + ["train.opt_steps=4"], fleet_argv,
        devices=CPU2)

    # the JAX package's sharded step on the same world, batch and draws
    tx = build_optimizer(cfg.train)
    mesh = make_mesh(2)
    _, j_step = jtrainer.make_train_step(cfg, tx, mesh=mesh)
    rep = NamedSharding(mesh, P())
    bundle = jax.device_put(
        {"scene": world["scene"], "frozen": world["frozen"],
         "views": {k: jnp.asarray(v) for k, v in views.items()}}, rep)
    state = jax.device_put(jtrainer.TrainState(
        world["tp"], tx.init(world["tp"]), jnp.asarray(0, jnp.int32)), rep)
    j_state, pj = jax_fused(lambda: jax.jit(j_step)(bundle, state, key),
                            cfg.model.fused_agg)
    tp = world["tp"]
    jax_params = (flatten({k: _ordered(tp[k], tp[k]) for k in TRAINED}),
                  flatten({k: _ordered(j_state.params[k], tp[k])
                           for k in TRAINED}), _leaf_names(tp))

    # the unsharded port
    tr1, views1 = ranks.trainer([], 1)
    dp1 = ranks.steps_and_render(tr1, views1,
                                 overflow=ranks.trainer(ranks.OVERFLOW, 1)[0])
    res = res.result()
    pool.shutdown()
    joined = []
    for p in torchrun:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
        joined.append(json.loads(out.strip().splitlines()[-1]))
    return {"torchrun": (joined, _listing(str(root / "torchrun"), "s0")),
            "dp1": dp1, "ranks": res, "jax": (cfg, j_state, pj),
            "jax_params": jax_params, "first": first,
            "first_listing": first_listing, "exps": exps,
            "fleet": str(root / "fleet")}


def test_training_draws_are_the_samplers_own():
    """Every training render takes its sampler's draws from
    ``sampler.training_draws``, which a rank calls ahead at the whole
    batch's width: ``error_bound_z_vals`` left to draw for itself gives the
    same z-values and leaves the generator where drawing ahead does; the
    entangled model's uniform grid draws its jitter ``[R, n_samples]``
    alone; a given draw is not drawn again."""
    scfg = apply_overrides(Config(), ranks.TINY).model.ray_sampler
    n = 40
    rng = np.random.default_rng(0)
    cam = torch.from_numpy(rng.normal(0, 0.1, (n, 3)).astype(np.float32))
    cam[:, 2] -= 2.0
    dirs = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(0, 0.2, (n, 3)).astype(np.float32)) + torch.tensor(
        [0.0, 0.0, 1.0]), dim=-1)

    def sdf_fn(x, first=False):
        return torch.linalg.norm(x, dim=-1) - 0.8, torch.tensor(False)

    for iters in (0, 1, 2):
        z, tail = [], []
        for ahead in (False, True):
            g = torch.Generator().manual_seed(5)
            draws = (tsampler.training_draws(scfg, n, iters, "cpu", g)
                     if ahead else None)
            z.append(tsampler.error_bound_z_vals(
                sdf_fn, cam, dirs, scfg, torch.tensor(0.1), iters,
                train=True, generator=g, draws=draws)[0])
            tail.append(torch.rand(3, generator=g))
        assert torch.equal(z[0], z[1]) and torch.equal(tail[0], tail[1])
    g, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    ahead = tsampler.training_draws(scfg, n, 1, "cpu", g2, entangled=True)
    assert list(ahead) == ["u_z"] and torch.equal(
        ahead["u_z"], torch.rand((n, scfg.n_samples), generator=g))
    given = {"u_z": torch.zeros(n, scfg.n_samples_eval)}
    g3, g4 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    a = tsampler.training_draws(scfg, n, 1, "cpu", g3, given=given)
    assert a["u_z"] is given["u_z"] and torch.equal(
        a["u_pdf"], torch.rand((n, scfg.n_samples), generator=g4))


def test_sharded_steps_match_unsharded(spawned):
    """dp=2 against dp=1, same seed, two steps with the ray budget dropping
    rays (192 of 256): each step's loss parts within 1e-5 relative (the
    first step's differ by the order of sums only; the second's also by
    the first update's), and the two ranks' parameters bit-equal.  After
    the two steps ``feats_color`` is within 5e-4 of dp=1's, the bound that
    ``tests/test_parallel.py:84`` holds JAX's dp=8 to (measured: 2.5e-4).
    Adam's first steps move an entry by about lr whatever its gradient's
    size, so an entry whose summed gradient is within rounding of 0 may
    step the other way: every leaf is within 2 lr a step (measured: one
    entry of ``F_color`` at 5.3e-4, all else within 4.3e-4)."""
    cfg = apply_overrides(Config(), ranks.TINY)
    assert tren.ray_budget(cfg.train.num_pixels, cfg.model) == 192
    dp1, (r0, r1) = spawned["dp1"], spawned["ranks"]
    assert [r0["rank"], r1["rank"]] == [0, 1]
    for step, (a, b) in enumerate(zip(dp1["hist"], r0["hist"])):
        assert set(a) == set(b)
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-5 * abs(a[k]) + 1e-12, (step, k,
                                                                  a[k], b[k])
        assert a["notfinite"] == b["notfinite"] == 0
        assert a["ray_overflow"] == a["probe_overflow"] == 0
    assert r0["hist"] == r1["hist"]
    assert all(np.array_equal(p, q) for p, q in zip(r0["params"],
                                                    r1["params"]))
    diff = {n: float(np.abs(p.numpy() - q).max())
            for n, p, q in zip(dp1["names"], dp1["params"], r0["params"])}
    assert diff["feats_color[0]"] <= 5e-4, diff
    lr = cfg.train.learning_rate
    assert max(diff.values()) <= 2 * lr * ranks.STEPS, diff


def test_sharded_step_matches_jax_dp2(spawned):
    """One ray-sharded step of the port (two ranks) against one of the JAX
    package's on a two-device mesh, the same world, batch and draws, by
    ``tests/test_torch_train.py``'s ``_one_step_matches_jax`` limits: loss
    parts within 1e-3 relative; the geometry and beta updates within 1e-2
    lr on 99.8 % of the entries, each colour leaf's update at cosine >=
    0.95 (the colour MLPs run in bf16 on both sides with other rounding
    points); the step count and notfinite exactly."""
    cfg, j_state, pj = spawned["jax"]
    r0, r1 = spawned["ranks"]
    pt = r0["jax_world"]["parts"]
    assert pt == r1["jax_world"]["parts"]
    for name in ("loss", "rgb_loss", "eikonal_loss", "mask_loss",
                 "pseudo_loss", "tv_loss", "psnr"):
        np.testing.assert_allclose(pt[name], float(pj[name]), rtol=1e-3,
                                   err_msg=name)
    assert pt["notfinite"] == float(pj["notfinite"]) == 0
    assert r0["jax_world"]["step"] == int(j_state.step) == 1
    lr = cfg.train.learning_rate
    p0, p1j, names = spawned["jax_params"]
    p1t = [p for k in TRAINED for p in r0["jax_world"]["params"][k]]
    geo, colour = {}, {}
    for a, b, c, name in zip(p1t, p1j, p0, names):
        dt, dj = (a - c).ravel(), (b - c).ravel()
        if name.startswith(("feats_geometry", "beta")):
            geo[name] = float((np.abs(dt - dj) > 1e-2 * lr).mean())
        else:
            colour[name] = float(dt @ dj / max(np.linalg.norm(dt)
                                               * np.linalg.norm(dj), 1e-30))
    assert all(v <= 0.002 for v in geo.values()), geo
    assert all(v >= 0.95 for v in colour.values()), colour


def test_data_parallel_errors_are_jaxs():
    """JAX's two ``ValueError``s, in its wording: too few devices (here, a
    process in no group of ranks has one; ``launch`` counts the cards) and
    a batch that does not split (raised in the ranks, read in the fixture's
    results by :func:`test_indivisible_batch_raises_on_the_ranks`)."""
    with pytest.raises(ValueError, match=r"^train\.data_parallel=2 but only "
                       r"1 devices visible$"):
        ranks.trainer([], 2)
    with pytest.raises(ValueError, match=r"^train\.data_parallel=2 but only "
                       rf"{torch.cuda.device_count()} devices visible$"):
        tlaunch.launch(ranks.cases, 2)
    assert tmesh.current() is None and tmesh.visible_devices() == 1


def test_indivisible_batch_raises_on_the_ranks(spawned):
    for r in spawned["ranks"]:
        assert r["indivisible"] == ("train.num_pixels=255 must be a "
                                    "multiple of data_parallel=2")


def test_sharded_render_matches_unsharded(spawned):
    """View 0 rendered at the initial parameters by two ranks (every other
    chunk each, then one all-gather) is the one-rank render: the same ray
    mask, the floats within 1e-6 (a rank's CPU ops may run on fewer
    threads, so their sums may round in another order), in one chunk
    (``train.render_chunk``'s 1024: rank 1 renders none) and in chunks of
    128 rays (measured: bit-equal)."""
    for key in ("render", "render_128"):
        a = spawned["dp1"][key]
        for r in spawned["ranks"]:
            b = r[key]
            assert set(a) == set(b)
            assert np.array_equal(a["ray_mask"], b["ray_mask"])
            assert a["ray_mask"].mean() > 0.2
            for k in a:
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
                np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-6,
                                           err_msg=(key, k))
    # at least two chunks of 128 (the rays that hit are a subset of those
    # rendered), so that each rank renders one
    assert (spawned["dp1"]["render"]["acc"] > 0).sum() >= 2 * 128


def test_masked_means_need_the_summed_count(spawned):
    """The eikonal term on two shards that hold 1 and 3 of its 4 valid
    rows: each rank's term over the count summed over the ranks adds up to
    the whole batch's masked mean, and so do its gradients; the mean of
    the ranks' own masked means does not."""
    g = torch.tensor(np.linspace(0.2, 1.9, 24, dtype=np.float32).reshape(
        8, 3), requires_grad=True)
    valid = torch.tensor([True, False, False, False, True, True, True,
                          False])
    whole = eikonal_loss(g, valid)
    grad = torch.autograd.grad(whole, g)[0].numpy()
    whole = float(whole.detach())
    for r in spawned["ranks"]:
        m = r["masked_mean"]
        np.testing.assert_allclose(float(m["share"]), whole, rtol=1e-6)
        np.testing.assert_allclose(m["grad"], grad, rtol=1e-6, atol=1e-8)
        assert abs(float(m["mean_of_means"]) - whole) > 0.05


def test_rank_budget_overflow_is_summed(spawned):
    """Budgets that overflow (``_torch_parallel_ranks.OVERFLOW``): the ray
    budget's flag is the whole batch's, the same on both ranks and counted
    once (dp=1's 1); the probe budget acts within each rank's render, so
    its flag is each rank's own and the window's sums them: 2 at dp=2,
    where dp=1 reads 1 (ROADMAP Queue 3, the per-rank budget rule)."""
    a = spawned["dp1"]["overflow"]
    assert a["ray_overflow"] == 1 and a["probe_overflow"] == 1
    for r in spawned["ranks"]:
        b = r["overflow"]
        assert b["ray_overflow"] == 1 and b["probe_overflow"] == 2
        assert np.isfinite(b["loss"])


def test_cli_trains_and_resumes_on_two_ranks(spawned):
    """``cli.train.main`` at ``train.data_parallel=2`` starts two CPU ranks
    itself: one experiment directory, one checkpoint (``latest`` and step
    2), written by rank 0; ranks that join a group (as under ``torchrun``)
    resume it from step 2 to 4, both from the same file, with bit-equal
    parameters, and rank 0 appends each window's metrics once."""
    (trainer, exp), = spawned["first"]
    assert trainer is None
    stamps, ckpts = spawned["first_listing"]
    assert len(stamps) == 1 and ckpts == ["2", "latest"]
    assert exp.timestamp == stamps[0]
    r0, r1 = spawned["ranks"]
    assert r0["cli"]["step"] == r1["cli"]["step"] == 4
    assert r0["cli"]["dir"] == r1["cli"]["dir"] == exp.dir
    assert all(np.array_equal(p, q) for p, q in zip(r0["cli"]["params"],
                                                    r1["cli"]["params"]))
    stamps, ckpts = _listing(spawned["exps"], "s0")
    assert len(stamps) == 1 and ckpts == ["2", "4", "latest"]
    with open(os.path.join(exp.plots_dir, "logs", "metrics.jsonl")) as f:
        steps = [int(line.split('"step": ')[1].split(",")[0].rstrip("}"))
                 for line in f]
    assert steps == [2, 2, 4, 4]          # train and val, per window


def test_fleet_passes_data_parallel_through(spawned):
    """The fleet under ``train.data_parallel=2`` on a host's two ranks:
    both take host 0's shard (the process group's rank divided by the
    ranks of a host), train ``s0`` on both ranks, and rank 0 alone writes
    the manifest."""
    fleet = spawned["fleet"]
    assert sorted(os.listdir(fleet)) == ["fleet_host0.json", "ours_s0"]
    _, ckpts = _listing(fleet, "s0")
    assert ckpts == ["2", "latest"]


def test_cli_joins_the_ranks_torchrun_started(spawned):
    """Two processes started as ``torchrun`` starts them (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), each running
    ``cli.train.main --device cpu`` at ``train.data_parallel=2``: each
    joins the group through ``env://`` as its rank, on the CPU over gloo,
    trains there, returns ``(None, exp)`` with rank 0's experiment
    directory and leaves the group; rank 0 alone wrote one experiment
    with its checkpoint."""
    joined, (stamps, ckpts) = spawned["torchrun"]
    assert [j["rank"] for j in joined] == [0, 1]
    for j in joined:
        assert (j["world"], j["device"], j["backend"]) == (2, "cpu", "gloo")
        assert j["trainer"] and j["left"]
        assert j["dir"] == joined[0]["dir"]
    assert len(stamps) == 1 and joined[0]["dir"].endswith(stamps[0])
    assert ckpts == ["2", "latest"]


def test_torchrun_group_must_be_the_settings(monkeypatch):
    """Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) ``launch``
    joins the group it finds: one of another size than
    ``train.data_parallel`` raises, and without ``devices`` rank r needs
    ``cuda:r`` (JAX's wording for too few devices); neither joins."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(ValueError, match=r"^train\.data_parallel=2 but "
                       r"torchrun started 1 ranks$"):
        tlaunch.launch(ranks.cases, 2, devices=CPU2)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", str(torch.cuda.device_count()))
    with pytest.raises(ValueError, match=r"^train\.data_parallel=2 but only "
                       rf"{torch.cuda.device_count()} devices visible$"):
        tlaunch.launch(ranks.cases, 2)
    assert tmesh.current() is None
