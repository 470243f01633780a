"""Multi-host scene fleet -- shard the per-scene testlist across hosts
(port of ``spurfies_tpu/cli/fleet.py``).

The reference optimizes scenes one at a time in a Python loop
(runner.py:64-65); scenes are fully independent, so the multi-host
scaling axis for this workload is scene parallelism: every host takes a
slice of the testlist and runs the normal single-card per-scene
optimization (``cli.train.run_scene``) on it.  No cross-host
communication is needed or used; ``train.data_parallel=N`` shards each
scene's rays over N ranks of the host, which ``run_scene`` starts.

    # host i of n:
    python -m spurfies_tpu_torch.cli.fleet --scans scan21,...,scan118 \
        --num-hosts 4 --host-index $HOST_INDEX --config configs/dtu_pn.yaml

host-index defaults, in order: --host-index flag, $FLEET_HOST_INDEX,
``torch.distributed.get_rank()`` (when a process group is initialized;
divided by ``train.data_parallel``, the ranks of one host), 0.  Under
``train.data_parallel`` every rank of a host runs this CLI's loop
(``torchrun``), or the host's one process starts them per scene; rank 0
writes the manifest.
"""

import argparse
import json
import os
import time

import torch

from spurfies_tpu_torch.cli.train import run_scene
from spurfies_tpu_torch.config import Config, apply_overrides, load_yaml
from spurfies_tpu_torch.parallel.mesh import current
from spurfies_tpu_torch.utils.experiment import get_logger

log = get_logger()


def shard_scans(scans: list, num_hosts: int, host_index: int) -> list:
    """Round-robin scene assignment (balances mixed scene sizes better
    than contiguous blocks)."""
    if not 0 <= host_index < num_hosts:
        raise ValueError(
            f"host_index {host_index} outside [0, {num_hosts})"
        )
    return scans[host_index::num_hosts]


def resolve_host_index(flag_value, ranks_per_host: int = 1):
    if flag_value is not None:
        return int(flag_value)
    env = os.environ.get("FLEET_HOST_INDEX")
    if env is not None:
        return int(env)
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() // ranks_per_host
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument("--scans", required=True,
                    help="comma-separated full testlist (same on all hosts)")
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-index", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    cfg = load_yaml(args.config) if args.config else Config()
    cfg = apply_overrides(cfg, args.overrides)
    lead = current() is None or current().lead

    host = resolve_host_index(args.host_index, cfg.train.data_parallel)
    all_scans = [s.strip() for s in args.scans.split(",") if s.strip()]
    mine = shard_scans(all_scans, args.num_hosts, host)
    if lead:
        log.info(f"fleet host {host}/{args.num_hosts}: "
                 f"{len(mine)}/{len(all_scans)} scenes -> {mine}")

    results = {}
    for scan in mine:
        t0 = time.perf_counter()
        run_scene(cfg, scan, resume=args.resume, device=args.device)
        results[scan] = round(time.perf_counter() - t0, 1)
        if lead:
            log.info(f"fleet host {host}: {scan} done in {results[scan]}s")

    if not lead:
        return
    out = os.path.join(cfg.exps_folder, f"fleet_host{host}.json")
    os.makedirs(cfg.exps_folder, exist_ok=True)
    with open(out, "w") as f:
        json.dump({"host": host, "num_hosts": args.num_hosts,
                   "scenes": results}, f, indent=2)


if __name__ == "__main__":
    main()
