"""The training step's model FLOPs (dense budgets) over the window's time
and the card's bf16 peak, in percent; moves ``train_rays_per_s``."""

from benchmark.entries.train import mfu


def read(run):
    return mfu(run) if run.kind == "train" else None
