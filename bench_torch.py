"""Benchmark of the PyTorch + CUDA port: aggregate PMMH samples/s at 4096
chains, the port of ``bench.py``.

Prints ONE JSON line last: ``{"metric", "value", "unit", "vs_baseline"}``.
The command line, defaults, workloads, timing and baseline are
``bench.py``'s; the port runs them on the current CUDA device
(``--device cuda``, the default) or, when asked, on the CPU (``--device
cpu``). Without a card and without ``--device cpu`` it exits non-zero; it
never falls back.

``--config`` picks the filter:

  bpf  (default) — bootstrap filter on stochastic SIR(500, 70), T = 10
  apf            — auxiliary filter (the Poisson lookahead)
  rmpf           — resample-move filter (the +-2 move on I)
  pmmh           — the public ``pmmh()`` end to end (pilot tuning, then
                   chunked sampling); the rate is the marginal sampling
                   rate between ``m // 8`` and ``m`` steps
  sinusoidal     — the README model, T = 20, always through its whole-sweep
                   kernel (``sinusoidal_sweep_pf_impl``, K1c)

and ``--transition`` the SIR route: ``sir_sweep`` (the whole sweep in one
kernel, K1 with the selection K2 inside), ``gillespie_pallas`` or
``gillespie`` (the engine with the per-day kernels K4 and K3; the port's
two names are one op), ``tauleap`` (the engine with K3 and plain binomial
draws, no K4).

One MH step is ``bench.py``'s ``mh_step``: a random walk on the log of
every parameter (the sinusoidal phi included) with a diagonal proposal of
sd ``PROP_SD``, the Jacobian ``sum(z') - sum(z)``, from ``THETA0``. It
runs as ``pmmh/driver.py::sample_chains``, whose proposal normals, accept
uniforms and filter seeds come from the port's MH stream (a lowbias32
hash of the chain words and the step), not from ``jax.random``: a chain's
samples differ from ``bench.py``'s, and only the rate compares.

Timing: one warm-up call, then ``--reps`` repetitions of ``--calls`` calls
of ``--steps`` MH steps; each repetition ends at ``torch.cuda.synchronize()``
and gives one rate. The median is reported; the repetitions go to stderr.
``vs_baseline`` divides by the single-core NumPy implementation of the
same filter (``baselines/single_core_numpy.py``, median of
``--baseline-reps``), which runs on this machine's host CPU.

The metric is ``cuda_pmmh_samples_per_sec_{chains}chains_{sir|sinusoidal}``
with ``_apf``, ``_rmpf`` or ``_pmmh_e2e`` appended: the ``cuda_`` prefix
keeps it apart from ``bench.py``'s series, whose values are a TPU's.

Usage: python bench_torch.py [--quick] [--config C] [--transition T]
                             [--chains C] [--particles N] [--steps K]
                             [--device cuda|cpu] [--profile DIR]

``main(argv)`` returns the record as a dict, so other scripts (and the
tests) call it in-process.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import platform
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CONFIGS = ("bpf", "apf", "rmpf", "pmmh", "sinusoidal")
TRANSITIONS = ("gillespie", "gillespie_pallas", "tauleap", "sir_sweep")
ALGORITHM = {"bpf": "BPF", "pmmh": "BPF", "apf": "APF", "rmpf": "RMPF"}
# bench.py:46-47, :155, :186: the generating theta the chains start from,
# and the sd of the log-space random walk.
THETA0 = {"sir": (0.5, 0.2), "sinusoidal": (0.8, 1.0, 0.5)}
PROP_SD = {"sir": (0.1, 0.1), "sinusoidal": (0.05, 0.1, 0.1)}
N_TOTAL, INIT_INFECTED = 500, 70
# Root seed of the chains' MH stream words (init_chain_state).
SAMPLER_SEED = 1405
# bench.py's defaults and its --quick cuts (bench.py:348-386).
DEFAULTS = dict(chains=4096, steps=64, calls=2, reps=5, m=512,
                baseline_steps=20, baseline_reps=3)
QUICK = dict(chains=256, steps=2, calls=2, reps=2, m=8, baseline_steps=2,
             baseline_reps=1)
# --config pmmh's pilot, bench.py's cut of the reference defaults (pilot_m
# 2000 -> 200, pilot_reps 100 -> 20).
PMMH_PILOT = dict(pilot_m=200, pilot_burn_in=50, pilot_reps=20)


def model_of(config: str) -> str:
    return "sinusoidal" if config == "sinusoidal" else "sir"


def observations(config: str) -> np.ndarray:
    """``bench.py``'s data: SIR(500, 70) over 10 days, or the README
    model's 20 observations, both from seed 1405."""
    if model_of(config) == "sinusoidal":
        from bayesssm_tpu_torch.models.sinusoidal import simulate_sinusoidal

        return simulate_sinusoidal(seed=1405, t_val=20)[1]
    from bayesssm_tpu_torch.models.sir import simulate_sir

    return simulate_sir(seed=1405)[1]


def sir_pf(y, particles: int, algorithm: str = "BPF",
           transition: str = "sir_sweep"):
    """The filter of one SIR MH step, ``pf(seed_words [C, 2], theta [C, 2],
    n) -> (loglike, state_est)`` with theta ``(lam, gamma)``: on
    ``sir_sweep`` the whole-sweep op that ``ops/sir_sweep.py::
    sir_filter_sweep`` runs (K1), built once by ``sir_sweep_pf_impl`` so the
    ``lgamma(y + 1)`` column is computed once; otherwise the engine's
    filter (``_make_pf_loglike``, K4 and K3 a day, or K3 alone on
    ``tauleap``) with the SIR lookahead and move."""
    from bayesssm_tpu_torch.models.sir import (
        sir_aux_log_likelihood_fn,
        sir_model,
        sir_move_fn,
        sir_sweep_pf_impl,
    )
    from bayesssm_tpu_torch.pmmh.tuning import _make_pf_loglike

    names = ["lam", "gamma"]
    if transition == "sir_sweep":
        return sir_sweep_pf_impl(N_TOTAL, INIT_INFECTED)(
            y, particles, names, None, None, algorithm, "SISAR",
            "stratified", False, max_particles=particles)
    fns, _, _ = sir_model(N_TOTAL, INIT_INFECTED, transition=transition)
    return _make_pf_loglike(
        y, particles, names,
        (*fns, sir_aux_log_likelihood_fn, sir_move_fn(N_TOTAL)), None,
        algorithm, "SISAR", "stratified", False, max_particles=particles)


def sinusoidal_pf(y, particles: int, path: str = "sweep"):
    """The README model's bootstrap filter at ``particles`` lanes, theta
    ``(phi, sigma_x, sigma_y)``: the whole sweep (``path="sweep"``, K1c,
    what ``bench.py --config sinusoidal`` runs) or the engine (K3 a
    day)."""
    from bayesssm_tpu_torch.models.sinusoidal import (
        sinusoidal_model,
        sinusoidal_sweep_pf_impl,
    )
    from bayesssm_tpu_torch.pmmh.tuning import _make_pf_loglike

    fns, log_priors, _ = sinusoidal_model()
    factory = (sinusoidal_sweep_pf_impl() if path == "sweep"
               else _make_pf_loglike)
    return factory(y, particles, list(log_priors), (*fns, None, None), None,
                   "BPF", "SISAR", "stratified", False,
                   max_particles=particles)


def sampler(model: str, chains: int, particles: int, device,
            seed: int = SAMPLER_SEED):
    """``(ChainState, prior_fns, transforms)``: ``chains`` chains at
    ``THETA0[model]`` with ``particles`` particles each, a diagonal
    proposal of sd ``PROP_SD[model]`` and a log transform on every
    parameter (``bench.py``'s ``mh_step``)."""
    from bayesssm_tpu_torch.pmmh.driver import init_chain_state
    from bayesssm_tpu_torch.pmmh.transforms import resolve_transforms

    if model == "sinusoidal":
        from bayesssm_tpu_torch.models.sinusoidal import sinusoidal_model

        _, log_priors, _ = sinusoidal_model()
    else:
        from bayesssm_tpu_torch.models.sir import sir_model

        _, log_priors, _ = sir_model()
    names = list(log_priors)
    factors = np.tile(np.diag(PROP_SD[model]).astype(np.float32),
                      (chains, 1, 1))
    state = init_chain_state(THETA0[model], factors, particles, seed, device)
    return (state, [log_priors[q] for q in names],
            resolve_transforms({q: "log" for q in names}, names))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def samples_per_sec(config, y, chains, particles, steps_per_call,
                    timed_calls, reps, transition, device, profile=None):
    """``bench.py``'s ``tpu_samples_per_sec`` on the port: ``(median
    samples/s, the repetitions' rates)``."""
    from bayesssm_tpu_torch.pmmh.driver import sample_chains

    if config == "sinusoidal":
        pf = sinusoidal_pf(y, particles)
    else:
        pf = sir_pf(y, particles, ALGORITHM[config], transition)
    state, prior_fns, transforms = sampler(model_of(config), chains,
                                           particles, device)

    def call(st):
        # burn_in = steps: only the last sample goes to the host.
        return sample_chains(pf, st, steps_per_call + 1, steps_per_call,
                             prior_fns, transforms).state

    state = call(state)     # warm-up (the initial evaluation included)
    _sync(device)
    rates = []
    with _profiled(profile, device):
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(timed_calls):
                state = call(state)
            _sync(device)
            rates.append(chains * steps_per_call * timed_calls
                         / (time.perf_counter() - t0))
    return float(np.median(rates)), rates


def pmmh_e2e_samples_per_sec(y, chains, m, transition, device):
    """``bench.py``'s ``pmmh_e2e_samples_per_sec`` on the port: the public
    ``pmmh()`` on SIR(500, 70) with ``default_tune_control(**PMMH_PILOT)``,
    twice at ``m`` and twice at ``m //
    8``; the marginal rate ``chains (m - m // 8) / (t_m - t_short)`` from
    the shorter sampling time at each length. ``timings["sampling"]`` ends
    at a device sync (``utils/timing.py``). Returns ``(rate, timings,
    target_n, the four raw sampling times)``."""
    import warnings

    from bayesssm_tpu_torch import default_tune_control, pmmh
    from bayesssm_tpu_torch.models.sir import sir_model, sir_sweep_pf_impl

    model_transition = ("gillespie_pallas" if transition == "sir_sweep"
                        else transition)
    fns, log_priors, transform = sir_model(N_TOTAL, INIT_INFECTED,
                                           transition=model_transition)
    pf_impl = (sir_sweep_pf_impl(N_TOTAL, INIT_INFECTED)
               if transition == "sir_sweep" else None)

    def run(m_run):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return pmmh(
                "bootstrap_filter", np.asarray(y, np.float32), m_run, *fns,
                log_priors, {"lam": 0.5, "gamma": 0.2}, m_run // 4,
                num_chains=chains, seed=1405, param_transform=transform,
                tune_control=default_tune_control(**PMMH_PILOT),
                print_summary=False, pf_impl=pf_impl, device=device)

    m_short = max(2, m // 8)
    # Full length first, each length twice, the minimum of each pair
    # (bench.py: a one-off cost that lands in one run of a pair cancels).
    first, out = run(m), run(m)
    shorts = [run(m_short).timings["sampling"] for _ in range(2)]
    fulls = [first.timings["sampling"], out.timings["sampling"]]
    t_full, t_short = min(fulls), min(shorts)
    rate = chains * (m - m_short) / (t_full - t_short)
    timings = dict(out.timings)
    timings["sampling"] = t_full
    timings["sampling_short"] = t_short
    return rate, timings, np.asarray(out.target_n), fulls + shorts


def baseline_samples_per_sec(y, particles, steps, reps, config="bpf"):
    """``bench.py``'s baseline: one MH step costs one sweep of the
    single-core NumPy filter at the generating parameters; median of
    ``reps`` repeats of ``steps`` sweeps after one warm-up sweep."""
    baselines = str(ROOT / "baselines")
    if baselines not in sys.path:
        sys.path.insert(0, baselines)
    from single_core_numpy import (
        sinusoidal_bpf_loglike,
        sir_apf_loglike,
        sir_bpf_loglike,
        sir_rmpf_loglike,
    )

    fn = {"bpf": sir_bpf_loglike, "pmmh": sir_bpf_loglike,
          "apf": sir_apf_loglike, "rmpf": sir_rmpf_loglike,
          "sinusoidal": sinusoidal_bpf_loglike}[config]
    theta = ((0.8, 1.0, 0.5) if config == "sinusoidal"
             else (0.5, 0.2, N_TOTAL, INIT_INFECTED))
    rng = np.random.default_rng(0)
    y = np.asarray(y)
    fn(rng, y, particles, *theta)
    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(steps):
            fn(rng, y, particles, *theta)
        rates.append(steps / (time.perf_counter() - t0))
    return float(np.median(rates))


@contextlib.contextmanager
def _profiled(directory, device):
    """A ``torch.profiler`` trace of the block, written to
    ``directory/trace.json`` (Chrome trace format); nothing without a
    directory."""
    if directory is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profile: {path}", file=sys.stderr)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="bench.py's cuts: 256 chains, 2 steps a call, 2 "
                         "calls, 2 reps, m 8, a baseline of 2 sweeps once; "
                         "an option given explicitly keeps its value")
    ap.add_argument("--config", default="bpf", choices=CONFIGS)
    ap.add_argument("--chains", type=int)
    ap.add_argument("--particles", type=int, default=128)
    ap.add_argument("--steps", type=int, help="MH steps a timed call")
    ap.add_argument("--calls", type=int)
    ap.add_argument("--reps", type=int)
    ap.add_argument("--m", type=int,
                    help="MH chain length for --config pmmh (the metric "
                         "is the marginal rate between m//8 and m)")
    ap.add_argument(
        "--transition", default="sir_sweep", choices=TRANSITIONS,
        help="SIR filter path (sir_sweep = the whole sweep in one kernel; "
             "gillespie_pallas / gillespie = the engine's per-day kernels; "
             "tauleap = the engine with tau-leaping)")
    ap.add_argument("--baseline-steps", type=int)
    ap.add_argument("--baseline-reps", type=int)
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler trace of the timed region "
                         "to DIR")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the current CUDA device, the default), "
                         "'cuda:<i>' or 'cpu'")
    args = ap.parse_args(argv)
    for name, value in (QUICK if args.quick else DEFAULTS).items():
        if getattr(args, name) is None:
            setattr(args, name, value)
    return args


def main(argv=None) -> dict:
    """Run the benchmark that ``argv`` selects and return its record."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            sys.exit("bench_torch: no CUDA device; pass --device cpu to run "
                     "the port on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        from bayesssm_tpu_torch.ops import _build

        _build.load_library()   # nvcc runs here, before any timer
    elif device.type != "cpu":
        sys.exit(f"bench_torch: unknown device {args.device!r}")

    y = observations(args.config)
    model_tag = model_of(args.config)
    metric = f"cuda_pmmh_samples_per_sec_{args.chains}chains_{model_tag}"
    if args.config == "pmmh":
        value, timings, target_n, raw = pmmh_e2e_samples_per_sec(
            y, args.chains, args.m, args.transition, device)
        print(f"pmmh e2e timings: {timings}; sampling seconds (m, m, "
              f"m//8, m//8): {raw}; target_n min/med/max = "
              f"{target_n.min()}/{int(np.median(target_n))}/"
              f"{target_n.max()}", file=sys.stderr)
        metric += "_pmmh_e2e"
    else:
        value, rates = samples_per_sec(
            args.config, y, args.chains, args.particles, args.steps,
            args.calls, args.reps, args.transition, device, args.profile)
        print(f"reps (samples/s): {[round(r) for r in rates]}",
              file=sys.stderr)
        if args.config not in ("bpf", "sinusoidal"):
            metric += f"_{args.config}"

    base = baseline_samples_per_sec(y, args.particles, args.baseline_steps,
                                    args.baseline_reps, config=args.config)
    print(f"baseline: {base} samples/s on one core of the host "
          f"({os.cpu_count()} CPUs, {platform.processor() or 'unknown'}); "
          f"device {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""), file=sys.stderr)
    return {"metric": metric, "value": round(value, 2), "unit": "samples/s",
            "vs_baseline": round(value / base, 2)}


if __name__ == "__main__":
    print(json.dumps(main()))
