"""Profiling / tracing utilities (port of ``spurfies_tpu/utils/profiling.py``).

``trace(logdir)`` wraps a block in a ``torch.profiler`` trace (CPU, and the
card's kernels when there is one) and writes it as a Chrome trace into
``logdir``, viewable in Perfetto or ``chrome://tracing``;
``RayRateMeter`` tracks the rays/s metric with true device syncs around
each window (on the card, ``sync_fn`` is ``torch.cuda.synchronize``).
"""

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str = "spurfies_trace"):
    """Profile the block; on exit writes ``<logdir>/trace.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class RayRateMeter:
    """Accumulates (rays, seconds) across windows; call .sync_fn between
    windows to get honest timings."""

    def __init__(self, sync_fn):
        self.sync_fn = sync_fn
        self.rays = 0
        self.seconds = 0.0

    @contextlib.contextmanager
    def measure(self, n_rays: int):
        self.sync_fn()
        t0 = time.perf_counter()
        yield
        self.sync_fn()
        self.seconds += time.perf_counter() - t0
        self.rays += n_rays

    @property
    def rays_per_sec(self) -> float:
        return self.rays / self.seconds if self.seconds > 0 else 0.0
