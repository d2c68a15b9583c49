"""Host-clock tracing of the port: spans, counters and per-call records
(extends the port of ``bayesssm_tpu/utils/timing.py``).

* :class:`span` — ``with span("filter"):`` adds the block's host-clock
  duration (``time.perf_counter_ns``) to an aggregate keyed by its path,
  the names of the spans open around it joined by ``/`` (for example
  ``sample_chains/mh_step/filter/day/transition``): count, total ns and
  self ns, the duration less the part its child spans cover. While a
  ``torch.profiler`` records, the span also opens
  ``record_function("bssm.<name>")``, so it lies on the profiler's
  timeline beside the device's operations; otherwise it opens nothing
  more.
* :func:`count` — a named counter, always on (:func:`counters` reads
  the thread's totals). :func:`host_sync` counts a
  point where the host waits on a device (``host_sync``): a copy to or
  from host memory (:func:`host_copy` for a copy to the device of what
  may already be there), ``.item()``, ``bool()`` of a device tensor,
  ``torch.nonzero`` or ``torch.cuda.synchronize``; none on the CPU.
* :class:`DeviceTally` — counters a kernel adds into on the card (the
  sweep op's ``sweep.loop_iters``, the lanes' own iterations of a
  callback's ``rng.event_loop``, and ``sweep.loop_slots``, the lane-slots
  the blocks issued for them). A launch takes the tally's values through
  :meth:`DeviceTally.feed`, which marks the tally fed by the calling
  thread. :func:`stage_device_tallies` queues the copy to the host of
  the tallies the thread fed, behind the work that feeds them, and
  :func:`fold_device_tallies`, called after a wait the caller makes
  anyway, adds them to the thread's counters: ``sample_chains`` does both
  around the wait that ends it, so they land in its record with no wait
  of their own.
* The outermost open span of a thread is the root of a call (``pmmh`` or
  ``sample_chains`` when called directly). When a root closes, its span
  aggregates and the counters' deltas over it are kept, with a call id
  and whether a profiler recorded during it, among the last
  ``RECENT_CALLS`` calls: :func:`recent_calls`; :func:`reset` forgets
  them.
* :class:`PhaseTimer` — seconds per named phase, each phase a span. On a
  CUDA device a phase ends with ``torch.cuda.synchronize()`` before the
  clock is read: PyTorch returns before the card has finished the work it
  was given, so a phase would otherwise time only the host's issuing of
  work.

Spans, counters and their roots belong to the thread that opens them.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time

import torch
import torch.autograd.profiler as _profiler

__all__ = ["span", "spanned", "count", "counters", "host_sync", "host_copy",
           "DeviceTally", "stage_device_tallies", "fold_device_tallies",
           "recent_calls", "reset", "PhaseTimer", "SPAN_PREFIX",
           "RECENT_CALLS"]

SPAN_PREFIX = "bssm."
RECENT_CALLS = 512

_clock = time.perf_counter_ns
_recent: collections.deque = collections.deque(maxlen=RECENT_CALLS)
_call_ids = itertools.count(1)


class _Thread(threading.local):
    def __init__(self):
        self.stack: list = []        # the open spans, outermost first
        self.counters: dict = {}     # name -> total since the thread began
        self.fed: dict = {}          # DeviceTally -> None, fed since staged
        self.staged: list = []       # DeviceTally staged, not yet folded


_tls = _Thread()


class _Root:
    """What a root span gathers over its call."""

    __slots__ = ("spans", "counters", "profiled")

    def __init__(self, counters: dict):
        self.spans: dict = {}        # path -> [count, total ns, self ns]
        self.counters = dict(counters)
        self.profiled = False


class span:
    """``with span(name):`` times the block on the host's clock (module
    docstring); ``ns`` holds its duration once it has closed."""

    __slots__ = ("name", "path", "root", "t0", "child", "rf", "ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _tls.stack
        if stack:
            parent = stack[-1]
            self.path = parent.path + "/" + self.name
            self.root = parent.root
        else:
            self.path = self.name
            self.root = _Root(_tls.counters)
        if _profiler._is_profiler_enabled:
            self.root.profiled = True
            self.rf = _profiler.record_function(SPAN_PREFIX + self.name)
            self.rf.__enter__()
        else:
            self.rf = None
        self.child = 0
        stack.append(self)
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        ns = _clock() - self.t0
        self.ns = ns
        stack = _tls.stack
        stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        agg = self.root.spans.get(self.path)
        if agg is None:
            self.root.spans[self.path] = [1, ns, ns - self.child]
        else:
            agg[0] += 1
            agg[1] += ns
            agg[2] += ns - self.child
        if stack:
            stack[-1].child += ns
        else:
            _close_root(self)
        return False


def _close_root(s: span) -> None:
    before = s.root.counters
    deltas = {k: v - before.get(k, 0) for k, v in _tls.counters.items()
              if v != before.get(k, 0)}
    _recent.append({
        "id": next(_call_ids),
        "root": s.name,
        "profiled": s.root.profiled,
        "ns": s.ns,
        "spans": {path: {"count": a[0], "total_ns": a[1], "self_ns": a[2]}
                  for path, a in s.root.spans.items()},
        "counters": deltas,
    })


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    c = _tls.counters
    c[name] = c.get(name, 0) + n


def counters() -> dict:
    """A copy of the calling thread's counters: name -> total since the
    thread began."""
    return dict(_tls.counters)


def host_sync(where, n: int = 1) -> None:
    """Count ``n`` waits of the host on the device of ``where`` (a tensor
    or a ``torch.device``): none on the CPU, where no queue runs ahead of
    the host."""
    if getattr(where, "device", where).type != "cpu":
        count("host_sync", n)


def host_copy(x, device) -> None:
    """Count the wait of copying ``x`` to ``device`` from host memory: a
    Python number, an array or a CPU tensor; a device tensor needs no
    copy from the host."""
    if not (isinstance(x, torch.Tensor) and x.device.type != "cpu"):
        host_sync(torch.device(device))


class DeviceTally:
    """Counters ``names`` that kernels on ``device`` add into: ``values``,
    an int64 tensor there, one entry a name.

    Only the tallies a thread fed (:meth:`feed`) are staged and folded by
    that thread. A tally fed outside ``sample_chains``, as by a filter
    called directly on the card, waits for the thread's next stage: its
    counts then land in the record of the call that stages it.
    """

    def __init__(self, names, device):
        self.names = tuple(names)
        self.device = torch.device(device)
        self.values = torch.zeros(len(self.names), dtype=torch.int64,
                                  device=self.device)
        self._host = torch.zeros(len(self.names), dtype=torch.int64,
                                 pin_memory=self.device.type == "cuda")

    def feed(self) -> torch.Tensor:
        """``values``, for a launch that adds into them: the tally is the
        calling thread's to stage."""
        _tls.fed[self] = None
        return self.values


def stage_device_tallies(device) -> None:
    """Queue, on ``device``'s current stream, the copy to the host and the
    reset of the tallies there that the thread fed, behind the work
    queued so far; no wait. A tally staged and not yet folded waits for
    the next stage."""
    device = torch.device(device)
    for t in [t for t in _tls.fed
              if t.device == device and t not in _tls.staged]:
        t._host.copy_(t.values, non_blocking=True)
        t.values.zero_()
        del _tls.fed[t]
        _tls.staged.append(t)


def fold_device_tallies() -> None:
    """Add the tallies the thread staged to its counters. Call it only
    after the host has waited for the work queued before the stage."""
    staged, _tls.staged = _tls.staged, []
    for t in staged:
        for name, v in zip(t.names, t._host.tolist()):
            if v:
                count(name, v)


def recent_calls() -> list:
    """The last ``RECENT_CALLS`` root calls, oldest first, each a dict:
    ``id``, ``root`` (its span's name), ``profiled`` (a profiler recorded
    during it), ``ns`` (its duration), ``spans`` (path -> ``count``,
    ``total_ns``, ``self_ns``) and ``counters`` (name -> change over the
    call)."""
    return list(_recent)


def reset() -> None:
    """Forget the recorded calls."""
    _recent.clear()


class PhaseTimer:
    """Collects wall-clock seconds per named phase; ``device`` is the
    device whose queued work a phase waits for before it stops the
    clock."""

    def __init__(self, verbose: bool = False, device=None):
        self.timings: dict[str, float] = {}
        self.verbose = verbose
        self.device = torch.device(device) if device is not None else None

    @contextlib.contextmanager
    def phase(self, name: str):
        s = span(name)
        try:
            with s:
                try:
                    yield
                finally:
                    if self.device is not None and self.device.type == "cuda":
                        host_sync(self.device)
                        torch.cuda.synchronize(self.device)
        finally:
            elapsed = s.ns * 1e-9
            self.timings[name] = self.timings.get(name, 0.0) + elapsed
            if self.verbose:
                print(f"[timing] {name}: {elapsed:.2f}s")
