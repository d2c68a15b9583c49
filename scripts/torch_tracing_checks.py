"""Checks of the port's tracing (``bayesssm_tpu_torch/utils/timing.py``) on
the card.

    python3 scripts/torch_tracing_checks.py [syncs] [views] [overhead] \
        [cost] [--cells ...] [--calls N]

``syncs``: for each benchmark cell (``benchmark/workloads/``), set the cell
up as the benchmark does, then run one more call of its shape with
``torch.cuda.set_sync_debug_mode("warn")``: every operation that makes the
host wait on the device warns, and each warning is traced to the
package's line that issued it. Explicit ``torch.cuda.synchronize`` calls
do not warn and are counted by a wrapper. The call's ``host_sync``
counter (``recent_calls()``) should equal warnings plus synchronizes.
The set-up has captured the MH step's CUDA graphs, so that call replays
them and captures nothing; a second call after the cached graphs are
dropped (``recapture``) captures them again, and its wait for the capture
counts too. Prints one JSON line a cell, the sites with their counts
first, the call's ``sweep.lane_days`` (chains x lanes x days its K1
launches cover), ``sweep.lane_transitions`` (chains x lanes x the
transitions before the weight stages) and, where the callbacks run
``rng.event_loop``, ``sweep.loop_iters`` and ``sweep.loop_slots`` (the
lanes' own loop iterations and the lane-slots the blocks issued, which
the card tallies and the call's last wait brings back with no wait of
their own: its warnings still equal ``host_sync``).

``views``: for each sampling cell, ``--calls`` calls of its shape timed
both on the benchmark's host clock (``drivers/sample_loop.py``: the
filter's wrapper and the MH step outside it) and by the program's spans
(``filter`` total and ``mh_step`` self time): the benchmark's means beside
the spans' median of per-call means and their mean over all calls; on the
sweep cells also the sweep op's ``prepare`` and ``launch`` spans.

``overhead``: for each sampling cell, rounds of ``--calls`` calls with the
spans on and with their enter and exit made empty, in turns in one
process: the seconds a call takes each way (medians over the rounds).

``cost``: nanoseconds a span's enter and exit take, 10**6 pairs with no
profiler and 10**5 under ``torch.profiler`` (CPU and CUDA activities),
and a counter's increment.

Needs a CUDA device; without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import sys
import time
import traceback
import warnings

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELLS = ("sir.sweep", "sir.engine", "sinusoidal.engine", "sir.pmmh",
         "sv.sweep", "lv.sweep", "lvssa.sweep")
PACKAGES = ("bayesssm_tpu_torch", "benchmark")


def _site() -> str:
    """``file:line function`` of the innermost frame of the package or the
    benchmark on the stack; else the innermost three frames."""
    stack = traceback.extract_stack()[:-2]
    for frame in reversed(stack):
        rel = pathlib.Path(frame.filename).resolve()
        try:
            rel = rel.relative_to(ROOT)
        except ValueError:
            continue
        if rel.parts and rel.parts[0] in PACKAGES:
            return f"{rel}:{frame.lineno} {frame.name}"
    return "outside " + " < ".join(f"{f.filename}:{f.lineno} {f.name}"
                                   for f in reversed(stack[-3:]))


def _debug_call(loop) -> dict:
    """One call of ``loop`` under ``set_sync_debug_mode("warn")``: the
    sites that made the host wait, and the call's counters."""
    import torch

    from bayesssm_tpu_torch.utils import timing

    sites = collections.Counter()
    real_sync = torch.cuda.synchronize

    def counted_sync(*args, **kwargs):
        sites["synchronize " + _site()] += 1
        return real_sync(*args, **kwargs)

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" in str(message):
            sites[_site()] += 1

    real_filter = warnings.simplefilter

    def keep_showing(action, *args, **kwargs):
        # drivers/pmmh_calls.py silences the call's warnings; keep ours.
        if action != "ignore":
            real_filter(action, *args, **kwargs)

    timing.reset()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        warnings.simplefilter = keep_showing
        torch.cuda.synchronize = counted_sync
        torch.cuda.set_sync_debug_mode("warn")
        try:
            loop.call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize = real_sync
            warnings.simplefilter = real_filter
    wall = time.perf_counter() - t0
    roots = [c for c in timing.recent_calls()
             if c["root"] in ("sample_chains", "pmmh")]
    counters = roots[-1]["counters"] if roots else {}
    # torch warns once when the mode is first set, from no line of ours.
    seen = sum(n for k, n in sites.items() if not k.startswith("outside"))
    return dict(sites=dict(sites.most_common()), seen=seen,
                counted=counters.get("host_sync", 0),
                captures=counters.get("mh_graph.capture", 0),
                mh_steps=counters.get("mh_steps", 0),
                graph_steps=counters.get("mh_graph.step", 0),
                lane_days=counters.get("sweep.lane_days", 0),
                lane_transitions=counters.get("sweep.lane_transitions", 0),
                loop_iters=counters.get("sweep.loop_iters", 0),
                loop_slots=counters.get("sweep.loop_slots", 0),
                match=seen == counters.get("host_sync", 0),
                call_s=round(wall, 3))


def syncs(name: str, seed: int) -> dict:
    """A call of the cell after its set-up, whose MH step graphs are
    cached (no capture, no wait of its own), then one after the cache is
    dropped, which captures them again and waits once for it."""
    import torch

    from benchmark.lib.spec import load_cell
    from bayesssm_tpu_torch.pmmh import driver

    dev = torch.device("cuda", 0)
    cell = load_cell(name)
    loop = cell.driver().setup(cell, seed, dev)
    torch.cuda.synchronize(dev)
    cached = _debug_call(loop)
    driver._STEPS.clear()
    recaptured = _debug_call(loop)
    return dict(cell=name, **cached, recapture=recaptured,
                both_match=cached["match"] and recaptured["match"])


def views(name: str, seed: int, calls: int) -> dict:
    import statistics

    import torch

    from benchmark.lib import program_spans
    from benchmark.lib.spec import load_cell
    from bayesssm_tpu_torch.utils import timing

    dev = torch.device("cuda", 0)
    cell = load_cell(name)
    loop = cell.driver().setup(cell, seed, dev)
    torch.cuda.synchronize(dev)
    timing.reset()
    loop.timed = True
    for _ in range(calls):
        loop.call()
    loop.timed = False
    h = loop.host
    recs = program_spans.calls("sample_chains")

    def view(leaf, i):
        per = [program_spans.spans(c, leaf) for c in recs]
        return dict(
            median_ms=statistics.median(a[i] / a[0] for a in per) * 1e-6,
            mean_ms=sum(a[i] for a in per) / sum(a[0] for a in per) * 1e-6)

    out = dict(cell=name, calls=calls,
               filter_host_ms=h["filter_s"] / h["filter_calls"] * 1e3,
               filter_span=view("filter", 1),
               mh_host_ms=h["outside_s"] / h["steps"] * 1e3,
               mh_step_self=view("mh_step", 2))
    if cell.workload["filter"] == "sweep":
        out.update(prepare_span=view("prepare", 1),
                   launch_span=view("launch", 1))
    return out


def overhead(name: str, seed: int, calls: int, rounds: int = 8) -> dict:
    import statistics

    import torch

    from benchmark.lib.spec import load_cell
    from bayesssm_tpu_torch.utils import timing

    dev = torch.device("cuda", 0)
    cell = load_cell(name)
    loop = cell.driver().setup(cell, seed, dev)
    cls = timing.span
    real = (cls.__enter__, cls.__exit__)
    empty = (lambda self: self, lambda self, *exc: False)
    secs = {"on": [], "off": []}
    try:
        for r in range(rounds):
            for mode in (("on", "off") if r % 2 == 0 else ("off", "on")):
                cls.__enter__, cls.__exit__ = real if mode == "on" else empty
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                for _ in range(calls):
                    loop.call()
                secs[mode].append((time.perf_counter() - t0) / calls)
    finally:
        cls.__enter__, cls.__exit__ = real
    on, off = (statistics.median(secs[m]) for m in ("on", "off"))
    return dict(cell=name, calls=calls, rounds=rounds, on_s=on, off_s=off,
                on_over_off=on / off, on_wins=sum(
                    a < b for a, b in zip(secs["on"], secs["off"])))


def cost() -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bayesssm_tpu_torch.utils import timing

    span, count = timing.span, timing.count

    def pairs(n):
        with span("root"):
            t0 = time.perf_counter_ns()
            for _ in range(n):
                with span("x"):
                    pass
            return (time.perf_counter_ns() - t0) / n

    def empty(n):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            pass
        return (time.perf_counter_ns() - t0) / n

    def counts(n):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            count("x")
        return (time.perf_counter_ns() - t0) / n

    pairs(10**4)
    loop_ns = empty(10**6)
    off = [pairs(10**6) - loop_ns for _ in range(3)]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        on = [pairs(10**5) - loop_ns for _ in range(3)]
    return dict(span_ns_no_profiler=off, span_ns_profiler=on,
                count_ns=counts(10**6) - loop_ns, loop_ns=loop_ns,
                device=torch.cuda.get_device_name(0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", nargs="*",
                    choices=("syncs", "views", "overhead", "cost"))
    ap.add_argument("--cells", nargs="*", default=list(CELLS))
    ap.add_argument("--seed", type=int, default=2**33 + 17)
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args(argv)
    what = args.what or ["syncs", "views", "overhead", "cost"]
    import torch

    if not torch.cuda.is_available():
        print("torch_tracing_checks: needs a CUDA device", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    ok = True
    if "cost" in what:
        print(json.dumps(cost()), flush=True)
    if "syncs" in what:
        for i, name in enumerate(args.cells):
            out = syncs(name, args.seed + i)
            ok = ok and out["both_match"]
            print(json.dumps(out), flush=True)
    sampling = [c for c in args.cells if c != "sir.pmmh"]
    if "views" in what:
        for i, name in enumerate(sampling):
            print(json.dumps(views(name, args.seed + 10 + i, args.calls)),
                  flush=True)
    if "overhead" in what:
        for i, name in enumerate(sampling):
            print(json.dumps(overhead(name, args.seed + 20 + i, args.calls)),
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
