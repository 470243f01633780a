"""What the ranks of ``tests/test_torch_parallel.py`` run (``parallel.launch``
spawns them, and a spawned rank imports this module by name, so it imports
torch and the port only: no JAX, no test module).  Each function takes the
rank's ``RankGroup`` first and returns plain Python and numpy values."""

import dataclasses
import os
import sys

import numpy as np
import torch

from spurfies_tpu_torch.cli import fleet, train as cli_train
from spurfies_tpu_torch.config import Config, apply_overrides
from spurfies_tpu_torch.convert.from_jax import (
    load_prior_npz,
    params_from_numpy,
    scene_from_numpy,
)
from spurfies_tpu_torch.data.synthetic import make_synthetic_scene
from spurfies_tpu_torch.model.losses import eikonal_loss
from spurfies_tpu_torch.ops.pair_mlp import _prep_layers
from spurfies_tpu_torch.train import trainer as ttrainer
from spurfies_tpu_torch.train.optim import Optimizer, flatten

# tests/test_parallel.py's TINY, with a batch wide enough for the ray
# budget to drop rays (256 rays, a budget of 192) and a probe budget that
# no rank overflows
TINY = ["model.max_shading_pts=8", "model.ray_sampler.near=0.5",
        "model.ray_sampler.far=3.0", "model.ray_sampler.n_samples=8",
        "model.ray_sampler.n_samples_eval=16",
        "model.ray_sampler.n_samples_extra=4", "train.num_pixels=256",
        "train.fast_iters=1", "train.eval_iters=1", "train.render_chunk=1024",
        "model.ray_budget_frac=0.6", "model.probe_budget_frac=0.6"]
# budgets that overflow: the ray budget's 128 of 256 rays, and a probe
# budget of 5 % of each rank's points
OVERFLOW = ["model.ray_budget_frac=0.3", "model.probe_budget_frac=0.05"]
STEPS = 2


def scene():
    return make_synthetic_scene(n_points=1500, n_views=2, img_res=(24, 24))


def trainer(overrides, dp, group=None, device="cpu"):
    """The TINY trainer at ``train.data_parallel=dp`` on ``device`` (a
    rank's: its group's), its prior in f32 on the CPU and in the kernels'
    bf16 on the card."""
    cfg = apply_overrides(Config(), TINY + overrides
                          + [f"train.data_parallel={dp}"])
    pts, cols, views = scene()
    on_card = (group.device if group else torch.device(device)).type == "cuda"
    return ttrainer.Trainer(
        cfg, pts, cols, views, device=device, group=group,
        compute_dtype=torch.bfloat16 if on_card else torch.float32), views


def steps_and_render(tr, views, steps=STEPS, overflow=None):
    """View 0 rendered at the initial parameters in one chunk and in
    chunks of 128 rays, ``steps`` steps read back one by one, the
    parameters after them, and one step of the ``overflow`` trainer."""
    view = (views["uv"], views["pose"][0], views["intrinsics"][0])
    cfg = tr.cfg
    small = ttrainer.make_render_fn(dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, render_chunk=128)),
        tr.device, tr.compute_dtype, tr.group)
    out = {"render": tr.render_image(*view),
           "render_128": small(tr.state.params, tr.scene, tr.frozen, *view)}
    hist = []
    tr.run(steps, window=1, callback=lambda s, m: hist.append(m))
    out["hist"] = hist
    tp = tr.state.params
    out["params"] = [p.detach().clone() for p in flatten(tp)]
    out["names"] = [f"{k}[{i}]" for k in tp for i in range(len(flatten(
        tp[k])))]
    if overflow is not None:
        seen = []
        overflow.run(1, window=1, callback=lambda s, m: seen.append(m))
        out["overflow"] = seen[0]
    return out


def card_steps(group, steps=STEPS):
    """The TINY trainer on this rank's card: ``steps`` steps, their whole
    batch's metrics, the parameters after them, and the host syncs that
    ``torch.cuda.set_sync_debug_mode`` reports in one more step."""
    import warnings

    tr, _ = trainer([], group.world, group=group)
    hist = []
    tr.run(steps, window=1, callback=lambda s, m: hist.append(m))
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            tr.train_step(tr.bundle, tr.state, tr.generator)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught
             if "synchroniz" in str(w.message).lower()
             and "prototype" not in str(w.message)]
    return {"hist": hist, "syncs": syncs, "backend": group.backend,
            "params": [p.detach() for p in flatten(tr.state.params)]}


def _no_tensorboard():
    # the metric writer keeps JSONL only (torch.utils.tensorboard would
    # load TensorFlow into the rank)
    sys.modules["torch.utils.tensorboard"] = None


def with_no_tensorboard(group, fn, *args):
    """``fn(group, *args)`` without ``torch.utils.tensorboard``."""
    _no_tensorboard()
    return fn(group, *args)


def jax_world_step(group, world, draws, v, pix, overrides):
    """One ray-sharded ``train_step`` on ``tests/test_torch_train.py``'s
    world (its scene, parameters and prior), with the whole batch's view,
    pixels and draws given: the whole batch's parts and the parameters
    after the step."""
    cfg = apply_overrides(Config(), overrides + ["train.data_parallel=2"])
    opt = Optimizer(cfg.train)
    _, sample_batch, step = ttrainer.make_train_step(cfg, opt, "cpu",
                                                     group=group)
    views = {k: torch.from_numpy(v_) for k, v_ in world["views"].items()}
    tp = params_from_numpy(world["tp"], device="cpu")
    for leaf in flatten(tp):
        leaf.requires_grad_(True)
    state = ttrainer.TrainState(tp, opt.init(tp),
                                torch.zeros((), dtype=torch.int32))
    bundle = {"scene": scene_from_numpy(world["scene"], device="cpu"),
              "prior": _prep_layers(load_prior_npz(device="cpu"),
                                    torch.float32), "views": views}
    draws = {k: torch.from_numpy(d) for k, d in draws.items()}
    parts = step(bundle, state, None, draws=draws, batch=sample_batch(
        views, None, v=torch.from_numpy(v), pix=torch.from_numpy(pix)))
    keys = list(parts)
    keys, vals = ttrainer.whole_batch_metrics(
        group, keys, torch.stack([parts[k].float() for k in keys]))
    return {"parts": dict(zip(keys, vals.tolist())),
            "step": int(state.step),
            "params": {k: [p.detach() for p in flatten(tp[k])] for k in tp}}


def masked_mean(group):
    """The eikonal term on shards that hold 1 and 3 of the 4 valid rows:
    the rank's term over the summed count and over its own count, and its
    gradient, summed over the ranks."""
    g = torch.tensor(np.linspace(0.2, 1.9, 24, dtype=np.float32).reshape(
        8, 3))
    valid = torch.tensor([True, False, False, False, True, True, True,
                          False])
    rows = slice(4 * group.rank, 4 * group.rank + 4)
    mine = g[rows].clone().requires_grad_(True)
    share = eikonal_loss(mine, valid[rows], count_fn=group.sum)
    alone = eikonal_loss(mine.detach(), valid[rows])
    grad = torch.autograd.grad(share, mine)[0]
    return {"share": group.sum(share.detach()),
            "mean_of_means": group.sum(alone) / group.world,
            "grad": group.all_gather_rows(grad).reshape(8, 3)}


def cases(group, world, draws, v, pix, jax_overrides, cli_argv, fleet_argv):
    """Every two-rank case of the test file in one spawn."""
    _no_tensorboard()
    out = {"rank": group.rank}
    tr, views = trainer([], group.world)
    ovf, _ = trainer(OVERFLOW, group.world)
    out.update(steps_and_render(tr, views, overflow=ovf))
    out["jax_world"] = jax_world_step(group, world, draws, v, pix,
                                      jax_overrides)
    try:
        trainer(["train.num_pixels=255"], group.world)
    except ValueError as e:
        out["indivisible"] = str(e)
    out["masked_mean"] = masked_mean(group)
    # the training CLI joins this group: it resumes the run that
    # cli.train.main started on two ranks of its own, in the same exps
    (trainer_, exp), = cli_train.main(["--resume"] + cli_argv)
    out["cli"] = {"step": int(trainer_.state.step), "dir": exp.dir,
                  "params": [p.detach() for p in
                             flatten(trainer_.state.params)]}
    fleet.main(fleet_argv)
    out["cwd"] = os.getcwd()
    return out
