"""Closed-loop MH sampling: one caller runs the system's ``sample_chains``
over a batched filter, call after call, each call waiting on the last.

Traffic parameters (the cell's ``workloads/<cell>.json``): ``filter``
(the program's filter path), ``chains``, ``particles`` (alive lanes a
chain), ``lanes`` (the lane bound), ``steps_per_call`` (MH steps a
``sample_chains`` call; every call's samples go to the host, as
``pmmh()``'s chunks do) and ``trace_calls`` (calls a traced run
profiles). The chains start at the configuration's generating theta with
its diagonal proposal; ``--seed`` is the root seed of the chains' MH
stream; the observations are the configuration's dataset.

The window runs whole calls until ``--seconds`` have passed; a call ends
with its samples on the host, so the window ends at a device sync. One
call, drawn from the seed (in a traced run the first profiled one), is
checked: its entry state, its first filter outputs and its samples are
kept for the reference (``reference/check.py``), which replays its
first ``CHECK_STEPS`` MH steps: the limits were set from readings at
that count.

Every untraced call of the window is timed on the host's clock, and so
is each filter call inside it: in a traced run the host's per-layer
metrics read these calls, free of the profiler's cost.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.lib.tracing import Stretch, span
from benchmark.reference.check import SamplingCheck

CHECK_STEPS = 2


class Loop:
    """The program's chains and filter for one cell, and what the window
    keeps for the check."""

    def __init__(self, cell, seed: int, device):
        from bayesssm_tpu_torch.pmmh.driver import init_chain_state
        from bayesssm_tpu_torch.pmmh.transforms import resolve_transforms

        cfg, wl = cell.config, cell.workload
        self.cell, self.seed, self.device = cell, int(seed), device
        self.ref = cell.reference()
        self.y = self.ref.simulate(cfg)
        self.chains, self.particles = wl["chains"], wl["particles"]
        self.lanes, self.steps = wl["lanes"], wl["steps_per_call"]
        self._pf, self.prior_fns = cell.program().build(
            cfg, wl["filter"], self.y, self.particles, self.lanes)
        names = list(self.ref.PARAMS)
        self.transforms = resolve_transforms(cfg["transform"], names)
        self.factors = np.tile(np.diag(cfg["proposal_sd"]).astype(np.float32),
                               (self.chains, 1, 1))
        self.theta0 = np.array([cfg["theta"][q] for q in names], np.float32)
        self.state = init_chain_state(self.theta0, self.factors,
                                      self.particles, self.seed, device)
        self.traced = False
        self.timed = False       # host-clock the call (an untraced one)
        self.host = dict(calls=0, steps=0, filter_calls=0, filter_s=0.0,
                         outside_s=0.0)
        self._prev = 0.0         # host clock at the call's start or the
                                 # last filter's return
        self.to_record = 0
        self.recorded = []
        self.history = []        # (first step, samples [C, k, P]) a call
        self.checked = None
        self.checked_at = None   # calls in history before the checked one

    def pf(self, seed_words, theta, n):
        """The program's filter inside the benchmark's span; the first
        outputs of the checked call are copied for the reference."""
        t0 = time.perf_counter()
        with span("filter", self.traced):
            ll, est = self._pf(seed_words, theta, n)
        if self.timed:
            t1, h = time.perf_counter(), self.host
            h["outside_s"] += t0 - self._prev
            h["filter_s"] += t1 - t0
            h["filter_calls"] += 1
            self._prev = t1
        if self.to_record:
            self.recorded.append(ll.clone())
            self.to_record -= 1
        return ll, est

    def call(self, checked: bool = False) -> None:
        from bayesssm_tpu_torch.pmmh.driver import sample_chains

        st = self.state
        if checked:
            entry = dict(entry_step=st.step, entry_theta=st.theta.clone(),
                         entry_ll=None if st.ll is None else st.ll.clone())
            self.to_record = CHECK_STEPS
            self.recorded = []
        if self.timed:
            self.host["calls"] += 1
            self.host["steps"] += self.steps
        self._prev = time.perf_counter()
        with span("sample_chains", self.traced):
            res = sample_chains(self.pf, st, self.steps + 1, 1,
                                self.prior_fns, self.transforms)
        if checked:
            entry.update(samples=res.samples,
                         ll_props=torch.stack(self.recorded))
            self.checked, self.checked_at = entry, len(self.history)
        self.history.append((st.step + 1, res.samples))
        self.state = res.state


def _launches():
    from bayesssm_tpu_torch.ops import _build

    return dict(_build.launches)


def setup(cell, seed: int, device) -> Loop:
    """Build the chains and the filter and warm every shape up: the first
    call evaluates the filter at the start and runs a whole call, and
    copies what a checked call keeps, so that no kernel loads for the
    first time inside the window."""
    loop = Loop(cell, seed, device)
    loop.call(checked=True)
    loop.checked = loop.checked_at = None
    return loop


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def window(loop: Loop, seconds: float, trace: bool) -> dict:
    """Run calls for ``seconds``; in a traced run profile ``trace_calls``
    of them from a third of the way in (past the end, if one call
    outlasts the window)."""
    wl = loop.cell.workload
    check_from = np.random.default_rng(loop.seed % 2**64).uniform(
        0.2, 0.8) * seconds
    stretch = None
    calls = 0
    ends = []                # host clock at the end of each untraced call
    _sync(loop.device)
    loop.timed = True
    t0 = time.perf_counter()
    while True:
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds and not (trace and stretch is None):
            break
        if trace and stretch is None and elapsed >= seconds / 3:
            loop.timed = False
            with Stretch(loop.device, _launches) as stretch:
                loop.traced = True
                for i in range(wl["trace_calls"]):
                    loop.call(checked=i == 0)
                loop.traced = False
            loop.timed = True
            calls += wl["trace_calls"]
            continue
        loop.call(checked=(not trace and loop.checked is None
                           and elapsed >= check_from))
        calls += 1
        ends.append(time.perf_counter() - t0)
    _sync(loop.device)
    elapsed = time.perf_counter() - t0
    loop.timed = False
    if loop.checked is None:
        loop.call(checked=True)      # after the window, untimed
    steps = calls * loop.steps
    out = dict(attempted=steps * loop.chains, calls=calls, window_s=elapsed,
               call_s=np.diff([0.0, *ends]).tolist(),
               e2e={"mh_samples_per_s": loop.chains * steps / elapsed})
    if stretch is not None:
        out["trace"] = stretch.reduce()
        out["trace"].work.update(steps=wl["trace_calls"] * loop.steps,
                                 calls=wl["trace_calls"],
                                 host=dict(loop.host))
    return out


def release(loop: Loop) -> None:
    """Drop the program's state and filter before the reference runs."""
    loop.state = None
    loop._pf = None
    if torch.device(loop.device).type == "cuda":
        torch.cuda.empty_cache()


def _reference_check(loop: Loop, dt=torch.float32) -> SamplingCheck:
    cfg, wl = loop.cell.config, loop.cell.workload
    transforms = [cfg["transform"][q] for q in loop.ref.PARAMS]
    return SamplingCheck(loop.ref.Model(cfg), wl["filter"], loop.y,
                         loop.particles, loop.lanes, loop.factors,
                         loop.ref.log_priors(), transforms, loop.device,
                         dt=dt)


def check(loop: Loop, checked=None):
    """``(numbers, work)``: the comparison of the checked call (or of
    ``checked``, outputs put in the program's place) with the reference,
    and the work the reference counted on its inputs."""
    ref = _reference_check(loop)
    theta0 = np.broadcast_to(loop.theta0, (loop.chains, loop.theta0.size))
    numbers = ref.compare(loop.seed, theta0,
                          loop.history[:loop.checked_at],
                          checked or loop.checked)
    model = ref.model
    c = loop.chains
    work = dict(model=loop.cell.config["model"], chains=c,
                particles=loop.particles, lanes=loop.lanes,
                days=int(len(loop.y)), state_cols=model.state_cols,
                events_per_filter=ref.tally.fired / max(ref.filter_calls * c,
                                                        1),
                events_per_day=ref.tally.fired / max(ref.tally.chain_days, 1))
    return numbers, work


def control(loop: Loop, dt) -> dict:
    """The checked call's outputs as the reference computes them in
    ``dt``, put in the program's place: its numbers."""
    low = _reference_check(loop, dt)
    theta0 = np.broadcast_to(loop.theta0, (loop.chains, loop.theta0.size))
    got = loop.checked
    words = low.words(loop.seed, loop.chains)
    ll_entry, _ = low.entry_ll(words, theta0, loop.history[:loop.checked_at],
                               got["entry_theta"])
    k = got["ll_props"].shape[0]
    ll_props, thetas = low.replay(words, got["entry_theta"], ll_entry,
                                  got["entry_step"], k)
    fake = dict(got, entry_ll=ll_entry.float(), ll_props=ll_props.float(),
                samples=thetas.float().permute(1, 0, 2).cpu().numpy())
    return check(loop, fake)[0]
