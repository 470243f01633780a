"""Training CLI — per-scene optimization (port of
``spurfies_tpu/cli/train.py``).

Reference surface: ``python runner.py testlist=scan24 vol=dtu_pn
opt_stepNs=[100_000,0,0]`` (runner.py:8-65).  Here:

    python -m spurfies_tpu_torch.cli.train --config configs/dtu_pn.yaml \\
        --scans scan24 [--resume] [--device cuda|cpu] [key.path=value ...]

Loops over scans, builds a Trainer per scene, runs ``train.opt_steps``
steps with periodic eval renders + checkpoints.  Everything runs on the
card unless ``--device cpu`` asks for the plain PyTorch path.

``train.data_parallel=N`` shards each step's rays over N ranks
(``parallel``): the CLI starts them itself, rank r on ``cuda:r`` (on the
CPU with ``--device cpu``), or joins them when ``torchrun`` started it
(``torchrun --nproc-per-node N -m spurfies_tpu_torch.cli.train ...``).
Only rank 0 logs, writes the experiment directory and checkpoints.
"""

import argparse
import dataclasses
import os

import numpy as np
import torch

from spurfies_tpu_torch.config import Config, apply_overrides, load_yaml
from spurfies_tpu_torch.cli.pretrain_prior import DEFAULT_OUT as PRETRAINED
from spurfies_tpu_torch.convert.from_jax import PRIOR_ASSET, load_prior_npz
from spurfies_tpu_torch.convert.torch_ckpt import (
    convert_local_prior,
    convert_vismvsnet,
)
from spurfies_tpu_torch.data.dtu import load_dtu
from spurfies_tpu_torch.data.mip_nerf import load_mipnerf, model_overrides
from spurfies_tpu_torch.data.mvs_local import build_local_bundle
from spurfies_tpu_torch.data.own_data import load_own_data
from spurfies_tpu_torch.device import resolve_device
from spurfies_tpu_torch.eval.plots import triptych
from spurfies_tpu_torch.parallel.launch import launch
from spurfies_tpu_torch.parallel.mesh import current
from spurfies_tpu_torch.train.trainer import Trainer
from spurfies_tpu_torch.utils.experiment import (
    ExperimentDir,
    MetricWriter,
    get_logger,
)

log = get_logger()


def load_scene_data(cfg: Config, scan: str):
    ds = cfg.dataset
    if ds.data_dir == "own_data":
        return load_own_data(ds.data_dir_root, scan)
    if ds.data_dir == "dtu":
        scan_id = int(scan[4:]) if str(scan).startswith("scan") else int(scan)
        return load_dtu(ds.data_dir_root, scan_id, ds.img_res, ds.num_views)
    if ds.data_dir == "mipnerf":
        return load_mipnerf(ds.data_dir_root, scan)
    raise NotImplementedError(ds.data_dir)


def apply_scene_overrides(cfg: Config, scan: str) -> Config:
    """Scene-dependent model knobs (±2 bounds for mipnerf garden/stump —
    reference pointneus_disent.py:45-53)."""
    if cfg.dataset.data_dir == "mipnerf" and scan in ("garden", "stump"):
        model = dataclasses.replace(cfg.model, **model_overrides(scan))
        cfg = dataclasses.replace(cfg, model=model)
    return cfg


def train_scene(cfg: Config, scan: str, resume: bool = False,
                device="cuda"):
    """Train one scene; returns ``(trainer, exp)``.  On the card the frozen
    prior's products run in bf16 (the kernels' dtype), on the CPU in f32.
    With ``train.data_parallel`` > 1 every rank of this process's group
    calls it (:func:`run_scene` starts them) and runs on its own device;
    rank 0 logs and writes, every rank renders its chunks."""
    group = current() if cfg.train.data_parallel > 1 else None
    dev = resolve_device(device) if group is None else group.device
    compute_dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    lead = group is None or group.lead

    def info(msg):
        if lead:
            log.info(msg)

    cfg = apply_scene_overrides(cfg, scan)
    sd = load_scene_data(cfg, scan)
    info(f"scene {scan}: {len(sd.train.ids)} train views, "
         f"{len(sd.points)} raw points, img_res={sd.img_res}")

    # the MVS feature-consistency bundle (the DTU local loss) when the
    # frozen Vis-MVSNet checkpoint is there (reference dtu.py:228-239); its
    # features are extracted on the trainer's device
    local_bundle = None
    vismvs_ckpt = os.path.join("ckpt", "vismvsnet.pt")
    if (cfg.dataset.data_dir == "dtu" and cfg.loss.local_weight > 0
            and os.path.exists(vismvs_ckpt)):
        local_bundle = build_local_bundle(
            cfg.dataset.data_dir_root, int(scan.replace("scan", "")),
            convert_vismvsnet(vismvs_ckpt, dev), sd.scale_mat, device=dev)
        info("local (Vis-MVSNet) feature loss enabled")

    trainer = Trainer(cfg, sd.points, sd.colors, sd.train_views(),
                      local_bundle=local_bundle, device=dev,
                      compute_dtype=compute_dtype)

    # frozen local-geometry prior (reference train.py:124-157): prefer the
    # reference's torch checkpoint, else a prior pretrained here
    # (cli/pretrain_prior.py's default output), else the repo's pretrained
    # prior; else warn (tests / smoke runs only)
    prior_ckpt = os.path.join("ckpt", "local_prior.pt")
    own_prior = os.path.abspath(PRETRAINED + ".npz")
    if os.path.exists(prior_ckpt):
        trainer.load_frozen(convert_local_prior(prior_ckpt, dev))
        info("loaded frozen local-geometry prior (torch ckpt)")
    elif os.path.exists(own_prior):
        trainer.load_frozen(load_prior_npz(own_prior, dev))
        info("loaded frozen local-geometry prior (pretrained here)")
    elif PRIOR_ASSET.exists():
        trainer.load_frozen(load_prior_npz(PRIOR_ASSET, dev))
        info("loaded frozen local-geometry prior (the repo's pretrained "
             "prior)")
    elif lead:
        log.warning(f"no local prior found ({prior_ckpt} or {PRIOR_ASSET}) "
                    "— frozen SDF decoder is randomly initialized")

    # rank 0 picks the experiment directory (a resumed one or a new
    # timestamp), and every rank restores from it
    stamp, resumed = None, False
    if lead:
        exp = ExperimentDir.latest(cfg.exps_folder, cfg.expname,
                                   scan) if resume else None
        resumed = exp is not None
        stamp = (exp or ExperimentDir(cfg.exps_folder, cfg.expname,
                                      scan)).timestamp
    if group is not None:
        stamp, resumed = group.broadcast_object((stamp, resumed))
    exp = ExperimentDir(cfg.exps_folder, cfg.expname, scan, timestamp=stamp)
    if resumed:
        trainer.restore_checkpoint(exp.checkpoint_path("latest"))
        info(f"resumed from {exp.dir} at step {int(trainer.state.step)}")
    writer = None
    if lead:
        exp.save_config(cfg)
        writer = MetricWriter(os.path.join(exp.plots_dir, "logs"))

    tcfg = cfg.train
    h, w = sd.img_res
    start = int(trainer.state.step)

    # In-training eval renders run at 1/4 resolution like the reference's
    # plot dataset (train.py:243-257,399).
    vstride = 4
    vh = (h + vstride - 1) // vstride
    vw = (w + vstride - 1) // vstride
    val_uv = np.ascontiguousarray(
        sd.uv.reshape(h, w, 2)[::vstride, ::vstride]).reshape(-1, 2)
    val_gt = sd.train.rgb[0].reshape(h, w, 3)[::vstride, ::vstride]
    val_mask = sd.train.mask[0].reshape(h, w, 3)[::vstride, ::vstride,
                                                 0] > 0.5

    done = start
    window = min(tcfg.render_freq, 500)
    while done < tcfg.opt_steps:
        n = min(window, tcfg.opt_steps - done)
        trainer.run(n, window=n,
                    callback=writer.scalars if writer is not None else None)
        done += n

        if done % tcfg.render_freq < window or done >= tcfg.opt_steps:
            # every rank renders its chunks; rank 0 writes the panel
            out = trainer.render_image(val_uv, trainer.views["pose"][0],
                                       trainer.views["intrinsics"][0])
            if lead:
                pred = out["rgb_values"].reshape(vh, vw, 3)
                mse = float(np.mean(((pred - val_gt) ** 2)[val_mask]))
                psnr = -10 * np.log10(mse + 1e-12)
                writer.scalars(done, {"psnr": psnr}, prefix="val")
                panel = triptych(
                    pred, out["depth_values"].reshape(vh, vw),
                    out["normal_map"].reshape(vh, vw, 3), gt=val_gt)
                writer.image(done, "val/triptych", panel)
                log.info(f"step {done}: val psnr {psnr:.2f}")

        if done % tcfg.checkpoint_freq < window or done >= tcfg.opt_steps:
            trainer.save_checkpoint(exp.checkpoint_path("latest"))
            trainer.save_checkpoint(exp.checkpoint_path(done))
            info(f"step {done}: checkpoint saved")

    if writer is not None:
        writer.close()
    return trainer, exp


def run_scene(cfg: Config, scan: str, resume: bool = False, device="cuda"):
    """:func:`train_scene` on ``train.data_parallel`` ranks: started here
    (rank r on ``cuda:r``, or on the CPU for ``device="cpu"``) unless this
    process is one of them already.  Returns ``(trainer, exp)``; from
    ranks started here ``(None, exp)``, rank 0's experiment directory."""
    dp = cfg.train.data_parallel
    if dp <= 1 or current() is not None:
        return train_scene(cfg, scan, resume, device)
    devices = None if torch.device(device).type == "cuda" else [device] * dp
    stamp = launch(_scene_rank, dp, cfg, scan, resume, device,
                   devices=devices)[0]
    return None, ExperimentDir(cfg.exps_folder, cfg.expname, scan,
                               timestamp=stamp)


def _scene_rank(group, cfg, scan, resume, device):
    return train_scene(cfg, scan, resume, device)[1].timestamp


def main(argv=None):
    """Parse ``argv`` and train each scan; returns ``[(trainer, exp)]``, one
    per scan (see :func:`run_scene` under ``train.data_parallel``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None, help="YAML config path")
    ap.add_argument("--scans", default=None,
                    help="comma-separated scan list (testlist)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("overrides", nargs="*", help="key.path=value")
    args = ap.parse_args(argv)

    cfg = load_yaml(args.config) if args.config else Config()
    cfg = apply_overrides(cfg, args.overrides)

    scans = (args.scans or str(cfg.dataset.scan_id)).split(",")
    return [run_scene(cfg, scan.strip(), resume=args.resume,
                      device=args.device) for scan in scans]


if __name__ == "__main__":
    main()
