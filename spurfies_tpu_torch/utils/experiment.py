"""Experiment directory layout, logging, metric writers (port of
``spurfies_tpu/utils/experiment.py``).

Behavioral spec from reference ``spurfies/train.py:76-98,212,293-328``:
``<exps_folder>/<expname>_<scan>/<timestamp>/{checkpoints/, plots/, run.yaml}``
with TensorBoard scalars (through ``torch.utils.tensorboard`` when the
``tensorboard`` package is installed; the JSONL file always); resume picks
the latest timestamp containing a checkpoint (train.py:56-74).
"""

import dataclasses
import json
import logging
import os
from datetime import datetime


def get_logger(name="spurfies_tpu_torch"):
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s | %(levelname)s | %(message)s", "%H:%M:%S"
        ))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


class ExperimentDir:
    def __init__(self, exps_folder: str, expname: str, scan_id: str,
                 timestamp: str | None = None):
        self.root = os.path.join(exps_folder, f"{expname}_{scan_id}")
        self.timestamp = timestamp or datetime.now().strftime(
            "%Y_%m_%d_%H_%M_%S"
        )
        self.dir = os.path.join(self.root, self.timestamp)
        self.ckpt_dir = os.path.join(self.dir, "checkpoints")
        self.plots_dir = os.path.join(self.dir, "plots")
        for d in (self.ckpt_dir, self.plots_dir):
            os.makedirs(d, exist_ok=True)

    @classmethod
    def latest(cls, exps_folder: str, expname: str, scan_id: str):
        """Latest timestamp dir containing a checkpoint (train.py:56-74,
        eval_spurfies.py:47-78)."""
        root = os.path.join(exps_folder, f"{expname}_{scan_id}")
        if not os.path.isdir(root):
            return None
        stamps = sorted(os.listdir(root), reverse=True)
        for ts in stamps:
            ck = os.path.join(root, ts, "checkpoints")
            if os.path.isdir(ck) and os.listdir(ck):
                return cls(exps_folder, expname, scan_id, timestamp=ts)
        return None

    def checkpoint_path(self, tag="latest"):
        return os.path.abspath(os.path.join(self.ckpt_dir, str(tag)))

    def save_config(self, cfg):
        with open(os.path.join(self.dir, "run.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)


class MetricWriter:
    """TensorBoard (``torch.utils.tensorboard``) + JSONL metric sink."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
            self.tb = SummaryWriter(log_dir)
        except ImportError:
            self.tb = None

    def scalars(self, step: int, values: dict, prefix: str = "t"):
        rec = {"step": step}
        for k, v in values.items():
            v = float(v)
            rec[k] = v
            if self.tb is not None:
                self.tb.add_scalar(f"{prefix}/{k}", v, step)
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()

    def image(self, step: int, tag: str, img):
        if self.tb is not None:
            import numpy as np
            self.tb.add_image(tag, np.asarray(img), step,
                              dataformats="HWC")

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()
