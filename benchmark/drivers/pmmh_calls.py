"""Closed-loop calls of the public ``pmmh()``: one caller runs whole calls,
tuning included, back to back, each waiting on the last.

Traffic parameters (the cell's ``workloads/<cell>.json``): ``filter`` (the
program's filter path, as the configuration's ``programs/<model>.py``
``pmmh_model`` builds it), ``chains``, ``m`` and ``burn_in`` (samples a
chain, burn-in included), ``tune`` (``default_tune_control``'s
arguments), ``call_seeds`` (the calls' ``pmmh(seed=)``) and
``trace_calls`` (calls a traced run profiles). A call's tuning picks its
particle counts, and with them the sampler's lane bound and work, from
its seed; so every run makes the same calls, cycling through
``call_seeds`` in an order drawn from ``--seed``, which also draws the
checked call and the check's samples. Every chain starts its
pilot at the configuration's generating theta with its transforms; the
observations are the configuration's dataset.

The window runs whole calls until ``--seconds`` have passed; a call ends
with its samples on the host, so the window ends at a device sync. One
call, drawn from the seed, is checked (in a traced run the call after the
window, so that the profiled call holds no kept inputs and allocates as
the others do):
the benchmark's ``pf_impl`` wraps the program's filter factory and keeps
every filter call's inputs and log-likelihood of that call, without a
copy, for the reference (``reference/pmmh.py``). Each untraced call's
``timings`` (tuning, sampling) are kept for the per-layer metrics.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from benchmark.lib.tracing import Stretch, span
from benchmark.reference.pmmh import PmmhCheck, lane_bound


class Loop:
    """The program's ``pmmh()`` call for one cell, and what the window
    keeps for the check."""

    def __init__(self, cell, seed: int, device):
        from bayesssm_tpu_torch import default_tune_control

        cfg, wl = cell.config, cell.workload
        self.cell, self.seed, self.device = cell, int(seed), device
        self.ref = cell.reference()
        self.y = self.ref.simulate(cfg)
        self.names = list(self.ref.PARAMS)
        self.fns, self.log_priors, self._pf_impl = cell.program().pmmh_model(
            cfg, wl["filter"])
        self.chains, self.m, self.burn_in = wl["chains"], wl["m"], wl[
            "burn_in"]
        self.tune = default_tune_control(**wl["tune"])
        self.k = 0
        rng = np.random.default_rng([self.seed % 2**64, 7])
        self.order = rng.permutation(len(wl["call_seeds"]))
        self.traced = False
        self.recording = None    # filter calls of the checked call
        self.phase = 0           # factory calls so far in this call
        self.timed = False
        self.timings = []        # the untraced window calls' timings
        self.checked = None

    def pf_impl(self, y, num_particles, *args, **kwargs):
        """The program's filter factory; its filters run inside the
        benchmark's span, and the checked call's are kept."""
        from bayesssm_tpu_torch.pmmh.tuning import _make_pf_loglike

        pf = (self._pf_impl or _make_pf_loglike)(y, num_particles, *args,
                                                 **kwargs)
        phase, self.phase = self.phase, self.phase + 1

        def wrapped(seed_words, theta, n=None):
            with span("filter", self.traced):
                ll, est = (pf(seed_words, theta) if n is None
                           else pf(seed_words, theta, n))
            if self.recording is not None:
                self.recording.append(dict(
                    phase=phase, words=seed_words, theta=theta, ll=ll,
                    n=num_particles if n is None else n))
            return ll, est

        return wrapped

    def run(self, seed: int, m: int, burn_in: int, tune):
        from bayesssm_tpu_torch import pmmh

        self.phase = 0
        theta0 = {q: self.cell.config["theta"][q] for q in self.names}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return pmmh("bootstrap_filter", self.y, m, *self.fns,
                        self.log_priors, theta0, burn_in,
                        num_chains=self.chains,
                        param_transform=self.cell.config["transform"],
                        tune_control=tune, seed=seed, print_summary=False,
                        pf_impl=self.pf_impl, device=self.device)

    def call(self, checked: bool = False) -> None:
        seeds = self.cell.workload["call_seeds"]
        seed = int(seeds[self.order[self.k % len(seeds)]])
        self.k += 1
        if checked:
            self.recording = []
        with span("pmmh", self.traced):
            out = self.run(seed, self.m, self.burn_in, self.tune)
        if self.timed:
            self.timings.append(dict(out.timings))
        if checked:
            self.checked = dict(
                seed=seed, calls=self.recording, target_n=out.target_n,
                samples=np.stack([out.theta_chain[q] for q in self.names],
                                 axis=-1))
            self.recording = None


def _launches():
    from bayesssm_tpu_torch.ops import _build

    return dict(_build.launches)


def setup(cell, seed: int, device) -> Loop:
    """Load the kernels and warm the cell's shapes up: one short call
    (the pilot's filters, its variance run of ``chains x pilot_reps``
    rows, a few sampling steps), and the sampler's filter once at every
    lane bound a call's tuning can choose, so that no kernel loads for the
    first time inside the window."""
    from bayesssm_tpu_torch import default_tune_control

    loop = Loop(cell, seed, device)
    wl = cell.workload
    short = dict(wl["tune"], pilot_m=4, pilot_burn_in=2)
    loop.run(loop.seed - 1, 4, 1, default_tune_control(**short))
    theta = torch.as_tensor(np.tile(np.float32(
        [cell.config["theta"][q] for q in loop.names]), (loop.chains, 1)),
        device=device)
    words = torch.zeros((loop.chains, 2), dtype=torch.int64, device=device)
    lanes = 128
    while lanes <= lane_bound(1000):
        pf = loop.pf_impl(loop.y, None, loop.names, (*loop.fns, None, None),
                          None, "BPF", "SISAR", "stratified", False,
                          max_particles=lanes)
        pf(words, theta, torch.full((loop.chains,), float(lanes),
                                    device=device))
        lanes *= 2
    return loop


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def window(loop: Loop, seconds: float, trace: bool) -> dict:
    """Run calls for ``seconds``; in a traced run profile ``trace_calls``
    whole calls from a third of the way in."""
    wl = loop.cell.workload
    check_from = np.random.default_rng(loop.seed % 2**64).uniform(
        0.2, 0.8) * seconds
    stretch = None
    calls = 0
    ends = []
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
                for _ in range(wl["trace_calls"]):
                    loop.call()
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
    out = dict(attempted=calls * loop.chains * loop.m, calls=calls,
               window_s=elapsed, call_s=np.diff([0.0, *ends]).tolist(),
               e2e={"pmmh_call_s": elapsed / max(calls, 1)})
    if stretch is not None:
        out["trace"] = stretch.reduce()
        out["trace"].work.update(calls=wl["trace_calls"],
                                 timings=list(loop.timings))
    return out


def release(loop: Loop) -> None:
    """Drop the program's filter factory before the reference runs; the
    checked call's kept filter inputs and outputs stay."""
    loop._pf_impl = None
    if torch.device(loop.device).type == "cuda":
        torch.cuda.empty_cache()


def _reference_check(loop: Loop) -> PmmhCheck:
    cfg, wl = loop.cell.config, loop.cell.workload
    return PmmhCheck(loop.ref.Model(cfg), wl["filter"], loop.y, loop.chains,
                     loop.m, loop.burn_in, wl["tune"],
                     [cfg["theta"][q] for q in loop.names],
                     loop.ref.log_priors(),
                     [cfg["transform"][q] for q in loop.names], loop.device)


def check(loop: Loop, control_dt=None):
    """``(numbers, work)``: the checked call against the reference (with
    ``control_dt``, the sampled filter outputs are the reference's in that
    type, put in the program's place)."""
    numbers = _reference_check(loop).compare(loop.checked["seed"],
                                             loop.checked, control_dt)
    work = dict(model=loop.cell.config["model"], chains=loop.chains)
    return numbers, work


def control(loop: Loop, dt) -> dict:
    """The checked call's numbers with the reference in ``dt`` in the
    program's place."""
    return check(loop, dt)[0]
