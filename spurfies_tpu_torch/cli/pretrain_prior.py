"""Pretrain the local-geometry prior (port of
``spurfies_tpu/cli/pretrain_prior.py``; the role of ``ckpt/local_prior.pt``):

    python -m spurfies_tpu_torch.cli.pretrain_prior --steps 20000 \\
        [--out local_prior_torch] [--device cuda|cpu]

It writes ``<out>.npz`` (the decoder, the npz layout of
``convert.from_jax.PRIOR_ASSET``) and ``<out>_history.json``.  The training
CLI loads ``local_prior_torch.npz`` from its working directory when there
is no ``ckpt/local_prior.pt``.  Everything runs on the card unless
``--device cpu`` asks for the plain PyTorch path on the CPU.
"""

import argparse
import json
import os

import numpy as np

from spurfies_tpu_torch.device import resolve_device
from spurfies_tpu_torch.prior.mesh_corpus import build_shapes_from_meshes
from spurfies_tpu_torch.prior.pretrain import (
    PriorConfig,
    eval_holdout,
    pretrain,
    save_prior,
)
from spurfies_tpu_torch.prior.shapes import sample_shape
from spurfies_tpu_torch.utils.experiment import get_logger

log = get_logger()

# the default output, which cli/train.py loads from its working directory
DEFAULT_OUT = "local_prior_torch"


def main(argv=None):
    """Parse ``argv``, pretrain, save; returns (params, history)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--shapes", type=int, default=32)
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="output path without extension: <out>.npz and "
                         "<out>_history.json")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh-dir", default=None,
                    help="directory of .ply/.obj meshes (ShapeNet-style); "
                         "default is the procedural-primitive corpus")
    ap.add_argument("--eval-holdout", type=int, default=0, metavar="N",
                    help="after training, score held-out SDF L1 on N "
                         "unseen shapes (auto-decoder protocol)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = PriorConfig(steps=args.steps, n_shapes=args.shapes, seed=args.seed)
    shapes = None
    if args.mesh_dir:
        log.info(f"building mesh corpus from {args.mesh_dir}")
        shapes = build_shapes_from_meshes(
            args.mesh_dir, n_shapes=cfg.n_shapes, n_query=cfg.n_query,
            spacing=cfg.spacing, seed=cfg.seed, log=log.info)
    log.info(f"pretraining prior: {cfg.n_shapes} shapes, {cfg.steps} steps "
             f"on {dev}")
    params, history = pretrain(
        cfg, shapes=shapes, device=dev, callback=lambda r: log.info(
            f"step {r['step']}: sdf_l1={r['sdf_l1']:.4f} "
            f"eik={r['eikonal']:.3f} cov={r['coverage']:.2f}"))
    if args.eval_holdout:
        rng = np.random.default_rng(args.seed + 10_000)
        held = [sample_shape(rng, n_query=cfg.n_query, spacing=cfg.spacing)
                for _ in range(args.eval_holdout)]
        mean_l1, per = eval_holdout(params["decoder"], held, cfg, device=dev)
        log.info(f"held-out SDF L1 ({args.eval_holdout} unseen shapes): "
                 f"{mean_l1:.4f}  per-shape={['%.4f' % v for v in per]}")
        history.append({"holdout_l1": mean_l1})
    out = os.path.abspath(args.out)
    save_prior(out + ".npz", params)
    with open(out + "_history.json", "w") as f:
        json.dump(history, f, indent=2)
    log.info(f"saved prior to {out}.npz")
    return params, history


if __name__ == "__main__":
    main()
