"""The traced window: ``torch.profiler`` around a callable, reduced to what
the per-layer metrics read, and the wrapper that counts the real pairs the
pair-MLP kernels are handed.

The profiler records the device's activity alone (CUDA, not the host's
operators), whose cost to the host is the least it offers.  ``reduce``
takes the device operations (kernels, copies, sets) as ``(name, start_us,
end_us)`` and the host's CUDA calls the same way, and gives the busy
seconds (the union of the device intervals), the window's length, the
kernel count, the device time by kernel name, and the ``breakdown`` of the
result line: the ten device operations that took most time and the ten
longest idle gaps, each named by the CUDA call that the host was in at the
gap's middle, or ``HOST_BETWEEN_CALLS`` where it was in none (Python and
the eager dispatch between launches).
"""

import bisect
import json
import os
import tempfile
import time

import torch

HOST_BETWEEN_CALLS = "(host between CUDA calls)"


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "cudaMemcpy",
                                "cudaMemset"))


def reduce(device_ops, host_ops, window_s: float) -> dict:
    ops = sorted(device_ops, key=lambda o: o[1])
    busy_us = 0.0
    gaps = []
    cur_s = cur_e = None
    for _, s, e in ops:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy_us += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    by_name = {}
    kernels = 0
    for name, s, e in ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
        kernels += _is_kernel(name)
    host = sorted(host_ops, key=lambda o: o[1])
    starts = [o[1] for o in host]

    def host_at(t):
        """The top-level host operation running at t (they do not
        overlap, so the last one to start before t)."""
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and host[i][2] >= t:
            return host[i][0]
        return HOST_BETWEEN_CALLS

    gaps.sort(key=lambda g: g[0] - g[1])
    idle = {}
    for s, e in gaps:
        name = host_at(0.5 * (s + e))
        idle[name] = idle.get(name, 0.0) + (e - s) * 1e-6
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_us * 1e-6, "window_s": window_s,
            "kernels": kernels, "by_name": by_name,
            "breakdown": {"device_ops": [[n, v] for n, v in top_ops],
                          "idle_gaps": [[n, v] for n, v in top_idle]}}


def _events(prof):
    """Device operations and the host's top-level calls of a finished
    profile, in microseconds: from its events, or where those hold no
    device operation, from the trace that the profiler exports."""
    dev, host = [], []
    for ev in prof.events():
        s, e = ev.time_range.start, ev.time_range.end
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((ev.name, s, e))
        elif ev.cpu_parent is None:
            host.append((ev.name, s, e))
    if dev:
        return dev, _top_level(host)
    return _exported_events(prof)


def _top_level(host):
    """The host operations not inside another one, of any thread."""
    host.sort(key=lambda o: (o[1], -o[2]))
    top, end = [], -1.0
    for op in host:
        if op[1] >= end:
            top.append(op)
            end = op[2]
    return top


def _exported_events(prof):
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    dev, host = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0.0))
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append((ev["name"], s, e))
        elif cat in ("cuda_runtime", "cuda_driver", "cpu_op",
                     "user_annotation", "python_function"):
            host.append((ev["name"], s, e))
    return dev, _top_level(host)


def profile(fn, sync) -> dict:
    """Run ``fn`` under ``torch.profiler`` (CUDA activity) between two
    device syncs; returns :func:`reduce` of it."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    dev, host = _events(prof)
    if not dev:
        raise RuntimeError("the profiler recorded no device operation")
    out = reduce(dev, host, window_s)
    out["read_s"] = time.perf_counter() - t1
    return out


def idle_pct(run) -> float | None:
    """The device's idle share of the measured window, in percent: one
    less the traced window's busy seconds a unit (step or image) over the
    measured window's seconds a unit.  The measured window runs without
    the profiler, whose cost to the host would stretch the traced one."""
    tr = run.trace
    if tr is None or not run.units or not tr.get("units"):
        return None
    busy = tr["busy_s"] / tr["units"]
    wall = run.window_s / run.units
    return 100.0 * (1.0 - busy / wall)


class PairCounter:
    """Holds each ``idx_ext`` that the pair-MLP entries ``pair_sdf_aggregate``
    (K3) and ``pair_sdf_value_agg`` (K2) are handed while installed, and
    counts afterwards, outside the trace, the real pairs among them: the
    entries in ``[0, N)``, that name a point and not the dump row N."""

    def __init__(self):
        self.held = {"k3": [], "k2": []}
        self._saved = []

    def install(self):
        from spurfies_tpu_torch.model import field
        from spurfies_tpu_torch.ops import pair_mlp

        def wrap(fn, key):
            def wrapped(table, idx_ext, x, layers, rbf):
                self.held[key].append((idx_ext, table.shape[0] - 1))
                return fn(table, idx_ext, x, layers, rbf)
            return wrapped

        # K3 is called through pair_mlp's module global (PairSdfAggregate),
        # K2 through the name field imported
        for mod, name, key in ((pair_mlp, "pair_sdf_aggregate", "k3"),
                               (field, "pair_sdf_value_agg", "k2")):
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, wrap(fn, key))
        return self

    def remove(self):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved = []

    def launches(self) -> dict:
        """``{"k3"|"k2": [(real pairs, P, k, N)]}``, one tuple a launch;
        releases the held tensors."""
        out = {key: [(int(((i >= 0) & (i < n)).sum()), i.shape[0],
                      i.shape[1], n) for i, n in items]
               for key, items in self.held.items()}
        self.held = {"k3": [], "k2": []}
        return out
