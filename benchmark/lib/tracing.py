"""The traced run's profile of a steady stretch of the window, reduced to
what the per-layer metrics read.

``torch.profiler`` records the host's ops and the device's operations
over a few calls; the benchmark's own spans (``record_function`` named
``bench.<layer>``) mark its calls into the program's layers. Nothing is
written to disk: the events are reduced in memory to

* the device's busy seconds (the union of its operations' intervals) and
  its operations, by kernel name;
* the spans' host intervals;
* the longest idle gaps between device operations, each named by the
  benchmark span and the innermost host op that ran across its middle;
* the program's counters, before and after.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch
from torch.profiler import record_function

SPAN_PREFIX = "bench."
TOP = 10
NAME_CHARS = 160


@contextlib.contextmanager
def span(name: str, on: bool):
    """A ``bench.<name>`` span when ``on``, else nothing at all."""
    if not on:
        yield
        return
    with record_function(SPAN_PREFIX + name):
        yield


@dataclasses.dataclass
class Trace:
    wall_s: float = 0.0
    busy_s: float = 0.0
    device_ops: int = 0
    kernels: dict = dataclasses.field(default_factory=dict)  # name -> [s, n]
    spans: dict = dataclasses.field(default_factory=dict)    # name -> [(a, b)]
    idle_gaps: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)
    work: dict = dataclasses.field(default_factory=dict)     # the driver's
    reduce_s: float = 0.0

    def kernel_s(self, fragment: str) -> float:
        """Device seconds of kernels whose name holds ``fragment``."""
        return sum(s for name, (s, _) in self.kernels.items()
                   if fragment in name)

    def idle_share(self):
        """% of the wall in which no operation ran on the device, or None
        when no device operation was traced."""
        if self.wall_s <= 0 or self.device_ops == 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.wall_s)

    def top_ops(self) -> list:
        """The device operations that took most time, ``[name, s]``, each
        name cut to ``NAME_CHARS``."""
        return [[k[:NAME_CHARS], v[0]] for k, v in sorted(
            self.kernels.items(), key=lambda kv: -kv[1][0])[:TOP]]


class Stretch:
    """Profile the calls made inside ``with Stretch(device, counters) as
    s:``; ``s.reduce()`` gives the reduction afterwards. ``counters()``
    returns the program's counters as a dict of numbers."""

    def __init__(self, device, counters):
        self.device = torch.device(device)
        self.counters = counters
        self.trace = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self._before = dict(self.counters())
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.wall_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        after = self.counters()
        self.counts = {k: after[k] - self._before.get(k, 0) for k in after}
        return False

    def reduce(self) -> "Trace":
        """The profile's reduction; its parse takes seconds, so the
        window's loop calls this after it has closed."""
        t0 = time.perf_counter()
        self.trace = reduce(_raw_events(self._prof), self.wall_s)
        self.trace.counters = self.counts
        self.trace.reduce_s = time.perf_counter() - t0
        self._prof = None
        return self.trace


def _raw_events(prof):
    """``(name, device_type, start_us, end_us, user_annotation)`` of every
    event, read from the profiler's raw results: building its event tree
    (``prof.events()``) costs tens of seconds on a long stretch."""
    results = getattr(prof.profiler, "kineto_results", None)
    if results is None:
        for e in prof.events():
            yield (e.name, e.device_type, e.time_range.start,
                   e.time_range.end, getattr(e, "is_user_annotation", False))
        return
    for e in results.events():
        start = e.start_ns()
        user = getattr(e, "is_user_annotation", None)
        yield (e.name(), e.device_type(), start * 1e-3,
               (start + e.duration_ns()) * 1e-3, bool(user and user()))


def _is_device(name, device_type, user) -> bool:
    return (device_type == torch.autograd.DeviceType.CUDA and not user
            and not name.startswith(SPAN_PREFIX))


def _union(intervals):
    """Merged ``[(a, b)]`` of intervals, sorted."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce(events, wall_s: float) -> Trace:
    """``events``: ``(name, device_type, start_us, end_us,
    user_annotation)`` tuples."""
    t = Trace(wall_s=wall_s)
    dev, host = [], []
    for name, device_type, a, b, user in events:
        if _is_device(name, device_type, user):
            dev.append((a, b))
            k = t.kernels.setdefault(name, [0.0, 0])
            k[0] += (b - a) * 1e-6
            k[1] += 1
        elif device_type == torch.autograd.DeviceType.CPU:
            if name.startswith(SPAN_PREFIX):
                t.spans.setdefault(name[len(SPAN_PREFIX):], []).append(
                    (a, b))
            else:
                host.append((a, b, name))
    busy = _union(dev)
    t.device_ops = len(dev)
    t.busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1],
                    busy[i + 1][0]) for i in range(len(busy) - 1)),
                  reverse=True)[:TOP]
    t.idle_gaps = [[_name_at((a + b) / 2, host, t.spans), g * 1e-6]
                   for g, a, b in gaps]
    return t


def _innermost(when: float, intervals):
    """The name of the latest-starting ``(a, b, name)`` running at
    ``when``, or None."""
    best = None
    for a, b, name in intervals:
        if a <= when <= b and (best is None or a > best[0]):
            best = (a, name)
    return best[1] if best else None


def _name_at(when: float, host, spans) -> str:
    """``<span>/<op>``: the innermost benchmark span and host op running
    at ``when``."""
    span_name = _innermost(when, [(a, b, name) for name, ivs in spans.items()
                                  for a, b in ivs])
    op = _innermost(when, host) or "host"
    return f"{span_name}/{op}" if span_name else op
