"""Device kernels a training step launches, from the traced window; moves
``train_rays_per_s`` (the eager step is bound by the host's launches)."""

from benchmark.entries.train import kernels_per_step


def read(run):
    return kernels_per_step(run) if run.kind == "train" else None
