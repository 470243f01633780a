#!/usr/bin/env python3
"""Phase 23 of ``chip_smoke.py`` alone (``train.data_parallel``), on a
machine with one CUDA card:

    python3 chip_dp.py

It builds the kernels, times the unsharded default path on dust3r_like
(20 warm-up steps, then 50) as phase 10's stand-in, writes phase 15's
synthetic DTU scan into a temporary directory, then runs
``chip_smoke.dp_phase``: two ranks on the card over gloo, the training CLI
on two ranks, one rank over NCCL (about 100-150 s of command time).  Any
failure exits non-zero.
"""

import os
import subprocess
import sys
import tempfile
import time

import chip_smoke


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_dp: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from spurfies_tpu_torch.config import Config
    from spurfies_tpu_torch.convert.from_jax import (
        PRIOR_ASSET,
        load_prior_npz,
    )
    from spurfies_tpu_torch.data.synthetic import (
        export_synthetic_dtu,
        make_dust3r_like_scene,
    )
    from spurfies_tpu_torch.ops import cuda_build
    from spurfies_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    chip_smoke.log(f"device: {torch.cuda.get_device_name(0)} [{smi}]; "
                   f"build {cuda_build.build()}")
    cfg = Config()
    pts, cols, views = make_dust3r_like_scene()
    prior = load_prior_npz(PRIOR_ASSET, device="cuda")
    trainer = Trainer(cfg, pts, cols, views, device="cuda")
    trainer.load_frozen(prior)
    trainer.run(chip_smoke.TRAIN_WARMUP, window=chip_smoke.TRAIN_WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.run(chip_smoke.OPTION_STEPS, window=chip_smoke.OPTION_STEPS)
    torch.cuda.synchronize()
    chip_smoke.TIMED["dust3r_like"] = ((time.perf_counter() - t0)
                                       / chip_smoke.OPTION_STEPS * 1e3)
    del trainer
    with tempfile.TemporaryDirectory() as tmp:
        export_synthetic_dtu(os.path.join(tmp, "data"), scan_id=24,
                             n_views=chip_smoke.CLI_VIEWS,
                             img_res=chip_smoke.CLI_RES, n_points=40000,
                             radius=0.8, cam_dist=2.4, seed=1)
        chip_smoke.dp_phase(smi, tmp, cfg, pts, cols, views, prior)
    chip_smoke.log("chip_dp: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
