"""The readings that the limits of a cell's compared numbers are set from
(not run by the benchmark's own runs):

    python -m benchmark.control --workload <cell> --seeds <n> ... \
        --control-seeds <n> ... [--witness-seeds <n> ...] \
        [--set config.loss.local_weight=0 ...]

For each of ``--seeds`` it sets the cell up as a run does (the program's
checked first steps, or one image) and compares with the reference: the
lower readings.  For each of ``--control-seeds`` it puts the reference in
the program's place, once in scaled fp8 (the control, the precision below
the bf16 that the configuration states), once with half of each batch left
out (training) and once with every pair's SDF offset by 5e-2 where the pair
MLP produces it, and compares those with the f32 reference: the upper
readings.  For each of ``--witness-seeds`` it does the same with the
reference in bf16, the configurations' own precision: a second witness of
what rounding alone does.  ``--set`` changes a key of the cell's
configuration file (a dotted path, a JSON value) for a look at a cause.
One JSON line each.
"""

import argparse
import json
import sys
import time
from pathlib import Path

from benchmark import harness


def _train_readings(spec, seed, device, sides):
    from benchmark.entries import train
    from benchmark.plain.check_train import (
        compare,
        leaf_gaps,
        reference_train,
    )
    from benchmark.plain.faults import set_faults

    run = harness.Run(spec, seed, device, time.perf_counter())
    train.setup(run)
    train.release(run)
    inputs, prog = run.state["inputs"], run.state["program"]
    ref = reference_train(inputs, device, prog["width"])
    out = {}
    if "program" in sides:
        out["program"] = dict(compare(prog, ref))
        print(json.dumps({"seed": seed, "side": "program",
                          "leaves": leaf_gaps(prog, ref)}),
              file=sys.stderr, flush=True)
    for side, kw, faults in (("control_fp8", {"mode": "fp8"}, {}),
                             ("witness_bf16", {"mode": "bf16"}, {}),
                             ("fault_half_batch", {}, {"half_batch": True}),
                             ("fault_sdf_offset", {}, {"sdf_offset": 5e-2})):
        if side not in sides:
            continue
        set_faults(**faults)
        try:
            other = reference_train(inputs, device, prog["width"], **kw)
        finally:
            set_faults()
        out[side] = dict(compare(other, ref))
        print(json.dumps({"seed": seed, "side": side,
                          "leaves": leaf_gaps(other, ref)}),
              file=sys.stderr, flush=True)
    return out


def _render_readings(spec, seed, device, sides):
    import numpy as np

    from benchmark.entries import render
    from benchmark.plain.check_render import compare, reference_render
    from benchmark.plain.faults import set_faults

    run = harness.Run(spec, seed, device, time.perf_counter())
    render.setup(run)
    v, prog = render._render(run, seed)
    render.release(run)
    inputs = dict(run.state["inputs"], eval=run.state["eval"], view=v)
    n = spec["mix"]["checked_chunks"]

    def ref(**kw):
        rng = np.random.default_rng(seed + 1)
        return reference_render(inputs, device, rng, n, **kw)

    rays, base = ref()
    out = {}
    if "program" in sides:
        out["program"] = dict(compare(prog, rays, base))
    for side, mode in (("control_fp8", "fp8"), ("witness_bf16", "bf16")):
        if side in sides:
            _, other = ref(mode=mode)
            out[side] = dict(compare(base_as_full(base, rays, prog), rays,
                                     other))
    if "fault_sdf_offset" in sides:
        set_faults(sdf_offset=5e-2)
        try:
            _, other = ref()
        finally:
            set_faults()
        out["fault_sdf_offset"] = dict(compare(
            base_as_full(base, rays, prog), rays, other))
    return out


def base_as_full(part: dict, rays, like: dict) -> dict:
    """The reference's chunk outputs placed into full-image arrays."""
    keep = rays >= 0
    full = {k: v.copy() for k, v in like.items()}
    for k in full:
        full[k][rays[keep]] = part[k][keep]
    return full


READINGS = {"train": _train_readings, "render": _render_readings}


def set_key(tree: dict, setting: str):
    """``a.b.c=<json>``: set ``tree["a"]["b"]["c"]``."""
    path, value = setting.split("=", 1)
    *keys, last = path.split(".")
    for k in keys:
        tree = tree[k]
    if last not in tree:
        raise KeyError(f"{path} is not a key of the configuration")
    tree[last] = json.loads(value)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--witness-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    bench = harness.load_json(Path.cwd() / "BENCHMARK.json")
    spec = harness.cell_spec(bench, args.workload)
    spec["mix"] = dict(spec["mix"], warmup_steps=0)
    for setting in args.set:
        set_key(spec["config"], setting)
    readings = READINGS[spec["mix"]["entry"]]
    for seed in sorted(set(args.seeds) | set(args.control_seeds)
                       | set(args.witness_seeds)):
        t = time.perf_counter()
        sides = (["program"] if seed in args.seeds else []) + (
            ["control_fp8", "fault_half_batch", "fault_sdf_offset"]
            if seed in args.control_seeds else []) + (
            ["witness_bf16"] if seed in args.witness_seeds else [])
        for side, gaps in readings(spec, seed, args.device, sides).items():
            print(json.dumps({"seed": seed, "side": side, "gaps": gaps}),
                  flush=True)
        print(f"seed {seed} took {time.perf_counter() - t:.1f} s",
              file=sys.stderr, flush=True)
        if args.device != "cpu":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
