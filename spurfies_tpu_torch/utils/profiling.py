"""The program's recorder of spans and counters, and ``trace(logdir)``.

* **Counters** (:data:`COUNTS`): launches of the hand-written kernels by
  name, always on.  A module registers its names when it is imported
  (:func:`register`) and adds one a launch (:func:`count`).
* **Spans** (:func:`span`, :func:`unit`): the host's time at the port's
  layer boundaries, recorded only while a torch profiler session is active
  (``torch.autograd.profiler._is_profiler_enabled``, which the profiler
  sets whatever its activities).  Off, a span is one flag test and a shared
  null context.  On, each span keeps its name, its start and end in
  ``time.time_ns()`` -- the clock the profiler stamps its events on, so
  spans and the device's activity share one time base --, its parent and
  its unit: the training step or image it belongs to (:func:`unit` begins
  one; every child shares its parent's).  Spans are taken on the thread
  that opened the session's first span; the autograd engine's own thread
  (the card's backward) opens none, so a whole backward is one span on the
  caller's side.  The newest session's spans are kept, at most
  :data:`SPAN_CAP` of them (later ones are dropped and counted), until a
  span or a held launch of the next session; reading them clears nothing.
* **Real pairs** (:func:`hold_pairs`): while spans are on, K3 and K2 hand
  their ``idx_ext`` and N here, and the reader counts afterwards the real
  pairs among them (entries in ``[0, N)``) against the pair slots handed
  (``P x k``) once the session is over: when it is read, or at the first
  unit after it.  Holding adds no device operation to the session; past
  :data:`PAIR_CAP` held launches they are counted at once.
* :func:`idle_by_span` puts each idle gap of the device on the innermost
  span the host was in at the gap's middle, the midpoint rule of
  ``benchmark/trace.py``.
* ``trace(logdir)`` profiles a block (CPU, and CUDA with a card) and writes
  ``trace.json`` (the Chrome trace with the spans as a track of their own,
  for Perfetto or ``chrome://tracing``) and ``summary.json`` (each span
  name's count and inclusive and self host milliseconds, the idle seconds
  on each span, the CUDA calls by span, the launches and real pairs).
"""

import contextlib
import json
import os
import threading
import time

import torch
from torch.autograd import profiler as _torch_profiler

OUTSIDE = "(outside spans)"
SPAN_CAP = 1 << 20       # spans kept a session
PAIR_CAP = 1 << 13       # K3/K2 launches held before they are counted
PAIR_KERNELS = ("k3", "k2")

COUNTS = {}              # kernel launches by name, since the process began


def register(*names):
    """Add counters ``names`` at 0 (a counter already there keeps its
    count)."""
    for name in names:
        COUNTS.setdefault(name, 0)


def count(name):
    COUNTS[name] += 1


class Span:
    """One recorded span; ``parent`` is its parent's index in the session's
    list (-1 at the top), ``end_ns`` 0 while it is open."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "unit")

    def __init__(self, name, start_ns, parent, unit):
        self.name = name
        self.start_ns = start_ns
        self.end_ns = 0
        self.parent = parent
        self.unit = unit


class _Recorder:
    """The newest profiler session's spans and held K3/K2 launches.  It is
    its own context manager: spans nest, so a span's exit closes the
    innermost open one."""

    def __init__(self):
        self.live = False     # the session of what is held has not ended
        self._clear()

    def _clear(self):
        self.spans = []
        self.dropped = 0
        self.units = 0        # units begun
        self.thread = None
        self._stack = []
        self._held = []       # (kernel, idx_ext, N)
        self.pairs = {key: [0, 0, 0] for key in PAIR_KERNELS}

    def _begin(self):
        if not self.live:
            self._clear()
            self.live = True
            self.thread = threading.get_ident()

    def end(self):
        """Mark the session over, so that the next span or held launch
        begins a new one, and count what it held."""
        self.live = False
        self.count_held()

    def end_if_off(self):
        if self.live and not _torch_profiler._is_profiler_enabled:
            self.end()

    def open(self, name, new_unit):
        self._begin()
        if threading.get_ident() != self.thread:
            return _NULL
        if len(self.spans) >= SPAN_CAP:
            self.dropped += 1
            return _NULL
        parent = self._stack[-1] if self._stack else -1
        if new_unit:
            self.units += 1
            u = self.units - 1
        else:
            u = self.spans[parent].unit if parent >= 0 else self.units - 1
        self._stack.append(len(self.spans))
        self.spans.append(Span(name, time.time_ns(), parent, u))
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._stack:
            self.spans[self._stack.pop()].end_ns = time.time_ns()
        return False

    def hold(self, kernel, idx_ext, n):
        self._begin()
        self._held.append((kernel, idx_ext, n))
        if len(self._held) >= PAIR_CAP:
            self.count_held()

    def count_held(self):
        """Count the held launches' real pairs (on their device) and let
        the tensors go."""
        held, self._held = self._held, []
        for kernel, i, n in held:
            tally = self.pairs[kernel]
            tally[0] += int(((i >= 0) & (i < n)).sum())
            tally[1] += i.shape[0] * i.shape[1]
            tally[2] += 1


_REC = _Recorder()
_NULL = contextlib.nullcontext()


def span(name):
    """A span named ``name`` around a ``with`` block, while a profiler
    session is active."""
    if not _torch_profiler._is_profiler_enabled:
        return _NULL
    return _REC.open(name, False)


def unit(name):
    """A span that begins a new unit (a training step, an image).  The first
    unit after a profiler session ends the session."""
    if not _torch_profiler._is_profiler_enabled:
        if _REC.live:
            _REC.end()
        return _NULL
    return _REC.open(name, True)


def hold_pairs(kernel, idx_ext, n):
    """K3's or K2's launch (``kernel`` ``"k3"`` or ``"k2"``) on ``idx_ext
    [P, k]`` over a table of N points plus the dump row, held while spans
    are on."""
    if _torch_profiler._is_profiler_enabled:
        _REC.hold(kernel, idx_ext, n)


def spans():
    """The newest session's spans (a list of :class:`Span`)."""
    _REC.end_if_off()
    return _REC.spans


def host_ms(names):
    """The inclusive host milliseconds of the newest session's closed spans
    named in ``names``."""
    _REC.end_if_off()
    names = set(names)
    return sum(s.end_ns - s.start_ns for s in _REC.spans
               if s.name in names and s.end_ns) * 1e-6


def real_pairs():
    """``{"k3"|"k2": (real pairs, pair slots, launches)}`` of the newest
    session (read it after the session)."""
    _REC.end_if_off()
    return {k: tuple(v) for k, v in _REC.pairs.items()}


def real_pair_pct():
    """Real pairs over the pair slots handed to K3 and K2 together, in
    percent, or None when the session handed them none."""
    tallies = real_pairs().values()
    slots = sum(t[1] for t in tallies)
    return 100.0 * sum(t[0] for t in tallies) / slots if slots else None


def _innermost(times_us, spans_, origin_ns):
    """For each time (microseconds after ``origin_ns``, in any order), the
    index of the innermost closed span holding it, or -1."""
    closed = sorted((i for i, s in enumerate(spans_) if s.end_ns),
                    key=lambda i: (spans_[i].start_ns, -spans_[i].end_ns))
    bounds = [((spans_[i].start_ns - origin_ns) * 1e-3,
               (spans_[i].end_ns - origin_ns) * 1e-3) for i in closed]
    out = [-1] * len(times_us)
    stack, j = [], 0
    for k in sorted(range(len(times_us)), key=times_us.__getitem__):
        t = times_us[k]
        while j < len(closed) and bounds[j][0] <= t:
            while stack and bounds[stack[-1]][1] < bounds[j][0]:
                stack.pop()
            stack.append(j)
            j += 1
        while stack and bounds[stack[-1]][1] < t:
            stack.pop()
        out[k] = closed[stack[-1]] if stack else -1
    return out


def _idle_gaps(device_intervals):
    """The gaps ``[(start, end)]`` between the union of the device's
    intervals ``(name, start, end)``, as ``benchmark/trace.py``'s ``reduce``
    finds them."""
    gaps, cur_e = [], None
    for _, s, e in sorted(device_intervals, key=lambda o: o[1]):
        if cur_e is not None and s > cur_e:
            gaps.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return gaps


def idle_by_span(device_intervals, spans_, origin_ns=0):
    """``{span name | OUTSIDE: idle seconds}``: each idle gap of the device
    put on the innermost span the host was in at the gap's middle.

    ``device_intervals``: the device's operations ``(name, start_us,
    end_us)``, in microseconds after ``origin_ns`` on the profiler's clock
    (the kineto trace's start, or the exported trace's
    ``baseTimeNanoseconds``); ``spans_``: :class:`Span` s, as
    :func:`spans` gives them."""
    gaps = _idle_gaps(device_intervals)
    where = _innermost([0.5 * (s + e) for s, e in gaps], spans_, origin_ns)
    idle = {}
    for (s, e), i in zip(gaps, where):
        name = spans_[i].name if i >= 0 else OUTSIDE
        idle[name] = idle.get(name, 0.0) + (e - s) * 1e-6
    return idle


def span_table(spans_):
    """``{name: {"count", "inclusive_ms", "self_ms"}}`` of the closed spans;
    self time is a span's less its children's."""
    child_ns = [0] * len(spans_)
    for s in spans_:
        if s.end_ns and s.parent >= 0:
            child_ns[s.parent] += s.end_ns - s.start_ns
    table = {}
    for s, c in zip(spans_, child_ns):
        if not s.end_ns:
            continue
        row = table.setdefault(s.name, {"count": 0, "inclusive_ms": 0.0,
                                        "self_ms": 0.0})
        row["count"] += 1
        row["inclusive_ms"] += (s.end_ns - s.start_ns) * 1e-6
        row["self_ms"] += (s.end_ns - s.start_ns - c) * 1e-6
    return table


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_CALL_CATS = ("cuda_runtime", "cuda_driver")


def summarize(events, base_ns, spans_, launches=None, pairs=None):
    """``summary.json``'s content from an exported Chrome trace's events
    (``ts`` in microseconds after ``base_ns``) and the session's spans.

    ``calls_by_span``: each CUDA runtime or driver call by the innermost
    span it began in (a ``cudaMemcpy*`` whose copy went from the device to
    the host is named ``<call> DtoH``); ``launches_by_top_span``: the
    ``cudaLaunchKernel`` calls by their outermost span."""
    dev, calls, dtoh = [], [], set()
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        s = float(ev["ts"])
        if cat in _DEVICE_CATS:
            dev.append((ev["name"], s, s + float(ev.get("dur", 0.0))))
            if cat == "gpu_memcpy" and "DtoH" in ev["name"]:
                dtoh.add(ev.get("args", {}).get("correlation"))
        elif cat in _CALL_CATS:
            calls.append((ev["name"], s,
                          ev.get("args", {}).get("correlation")))
    where = _innermost([c[1] for c in calls], spans_, base_ns)
    by_span, top = {}, {}
    for (name, _, corr), i in zip(calls, where):
        if name.startswith("cudaMemcpy") and corr in dtoh:
            name += " DtoH"
        at = spans_[i].name if i >= 0 else OUTSIDE
        row = by_span.setdefault(name, {})
        row[at] = row.get(at, 0) + 1
        if name == "cudaLaunchKernel":
            while i >= 0 and spans_[i].parent >= 0:
                i = spans_[i].parent
            at = spans_[i].name if i >= 0 else OUTSIDE
            top[at] = top.get(at, 0) + 1
    return {"units": len({s.unit for s in spans_ if s.unit >= 0}),
            "spans": span_table(spans_), "dropped_spans": _REC.dropped,
            "idle_s": idle_by_span(dev, spans_, base_ns),
            "calls_by_span": by_span, "launches_by_top_span": top,
            "launches": launches or {}, "real_pairs": pairs or {}}


def _span_events(spans_, base_ns, pid):
    out = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": "program spans"}}]
    for s in spans_:
        if s.end_ns:
            out.append({
                "ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                "tid": 0, "ts": (s.start_ns - base_ns) * 1e-3,
                "dur": (s.end_ns - s.start_ns) * 1e-3,
                "args": {"unit": s.unit, "parent": (
                    spans_[s.parent].name if s.parent >= 0 else None)}})
    return out


@contextlib.contextmanager
def trace(logdir: str = "spurfies_trace"):
    """Profile the block; on exit writes ``<logdir>/trace.json`` and
    ``<logdir>/summary.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    before = dict(COUNTS)
    _REC.live = False                   # this session's spans only,
    _REC._clear()                       # the last one's freed here
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
    launches = {k: v - before.get(k, 0) for k, v in COUNTS.items()
                if v != before.get(k, 0)}
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    events = doc["traceEvents"]
    sp = spans()
    summary = summarize(events, base, sp, launches, real_pairs())
    pid = 1 + max([e["pid"] for e in events
                   if isinstance(e.get("pid"), int)], default=0)
    events.extend(_span_events(sp, base, pid))
    with open(path, "w") as f:
        json.dump(doc, f)
    with open(os.path.join(logdir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
