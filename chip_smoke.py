#!/usr/bin/env python3
"""Bring-up check of the PyTorch + CUDA port (``bayesssm_tpu_torch``) on one
NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It builds the
CUDA kernels from ``bayesssm_tpu_torch/csrc`` with ``nvcc``, holds each one
against its plain PyTorch version on the card, and drives the port's two
paths at full width — stochastic-SIR PMMH, 4096 chains x 128 particles,
T = 10 — through ``sample_chains`` and then through the public ``pmmh()``
with pilot tuning: the whole-sweep path (``sir_sweep_pf_impl``) and the
generic engine's bootstrap filter with the per-day kernels
(``_make_pf_loglike`` on ``sir_model(transition="gillespie_pallas")``).
Phases:

1. device name, count, and ``nvidia-smi`` name and power limit;
2. kernel build: seconds, registers and spills from ``-Xptxas -v``;
3. ``bssm_select`` against searchsorted + gather, bitwise, N in {128, 1024};
4. LGSS sweep kernel against the plain sweep (C=512, N=1024, T=20, SISR):
   >= 99% of chains within 1e-3 in loglike, mean within max(5 SE, 0.1) of
   the exact Kalman value;
5. SIR sweep kernel against the plain sweep at 4096 x 128 x 10: >= 99% of
   chains within 1e-3, all finite, a second launch bitwise equal; kernel
   and plain ms per sweep;
6. the sweep path: one warm-up MH step, then 64 timed steps (samples/s on
   the host clock up to ``torch.cuda.synchronize()``), the plain sweep
   over 4 steps, and an acceptance rate strictly inside (0, 1);
7. the fused weight step (K3) against its plain version at 4096 x 128
   (d = 2) and 512 x 1024 (d = 1): host and in-kernel positions,
   stratified/systematic/multinomial, adaptive and always, masked lanes;
   columns, weights, ESS and log-sum-exp bitwise; kernel and plain ms;
8. the Gillespie day-step (K4) against its plain version at 4096 x 128,
   rates spread as in phase 5 and some chains with I = 0: S and I bitwise;
   kernel and plain ms;
9. LGSS through ``bootstrap_filter`` with ``use_fused="auto"`` (C=512,
   N=1024, T=20, SISR): K3 launched every day, mean within max(5 SE, 0.1)
   of the Kalman value;
10. the engine path: one warm-up MH step, then 32 timed steps with exactly
    10 K4 and 10 K3 launches per step, finite theta, acceptance strictly
    inside (0, 1); the plain engine on the card over 2 steps;
11. the public ``pmmh()`` with pilot tuning, as the JAX package's
    ``bench.py --config pmmh`` runs it: 4096 chains, SIR(500, 70),
    T = 10, theta0 = (0.5, 0.2), m = 512, burn_in = 128, seed 1405,
    ``default_tune_control(pilot_m=200, pilot_burn_in=50, pilot_reps=20)``;
    once through ``pf_impl=sir_sweep_pf_impl(500, 70)`` (K1 and no K3 or
    K4) and once through the engine (K3 and K4, no K1). Tuning and
    sampling seconds, samples/s as C (m - 1) / sampling, target_n and the
    lane bound, acceptance, ESS and R-hat; finite samples, acceptance
    strictly inside (0, 1), target_n in [50, 1000].

``--profile`` adds a ``torch.profiler`` window over 8 steps of each path
(and of each ``pmmh()`` path's phase 2, at its lane bound and counts)
and prints the device busy share. Any failure raises (exit code not 0).
Without a CUDA device it fails before printing any result. The last line
is one JSON object ``{"ok": true, "device": {...}}``; the line before it is
nvidia-smi's, and the one before that the per-kernel JSON.
"""

from __future__ import annotations

import json
import math
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

ROUTE = "cuda"
SWEEP_SOURCE = "bayesssm_tpu_torch/csrc/sweep.cu"
SWEEP_REPLACES = "bayesssm_tpu/ops/sweep_builder.py:146"
SELECT_SOURCE = "bayesssm_tpu_torch/csrc/select.cuh"
SELECT_REPLACES = "bayesssm_tpu/ops/merge_select.py:131"
RESAMPLE_SOURCE = "bayesssm_tpu_torch/csrc/resample.cu"
RESAMPLE_REPLACES = "bayesssm_tpu/ops/resampling_pallas.py:60"
GILLESPIE_SOURCE = "bayesssm_tpu_torch/csrc/gillespie.cu"
GILLESPIE_REPLACES = "bayesssm_tpu/ops/gillespie_pallas.py:71"
CHAINS, PARTICLES = 4096, 128
AGREE_TOL = 1e-3       # |d loglike| per chain, kernel vs plain sweep
AGREE_SHARE = 0.99     # share of chains that must agree within AGREE_TOL
# pmmh() as the JAX package's `bench.py --config pmmh` runs it.
PMMH_M, PMMH_BURN_IN = 512, 128


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` replayed from a CUDA graph:
    the device time of its launches without the host's time to issue
    them (``fn`` must not synchronise)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps)


def words_for(c: int, seed: int, dev) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.as_tensor(
        rng.integers(0, 2**32, size=(c, 2), dtype=np.uint64).astype(np.int64),
        device=dev,
    )


def compare(ll_k: torch.Tensor, ll_p: torch.Tensor, what: str) -> float:
    """Share-of-chains agreement; returns the max |d loglike| over chains."""
    if not (bool(torch.isfinite(ll_k).all()) and
            bool(torch.isfinite(ll_p).all())):
        raise AssertionError(f"{what}: non-finite loglike")
    diff = (ll_k - ll_p).abs()
    share = float((diff <= AGREE_TOL).float().mean())
    say(what, agree_share=f"{share:.6f}", max_abs_err=float(diff.max()),
        median_abs_err=float(diff.median()))
    if share < AGREE_SHARE:
        raise AssertionError(f"{what}: only {share:.4f} of chains agree")
    return float(diff.max())


def phase_select(dev) -> None:
    from bayesssm_tpu_torch.ops import _build
    from bayesssm_tpu_torch.ops.merge_select import (
        select_cols,
        select_cols_reference,
    )
    from bayesssm_tpu_torch.ops.sweep_builder import cdf_ext

    rng = np.random.default_rng(3)
    for n in (128, 1024):
        r = 64
        w = rng.random((r, n)).astype(np.float32)
        w[rng.random((r, n)) < 0.3] = 0.0       # runs of equal CDF values
        alive = rng.integers(n // 2, n + 1, size=r).astype(np.float32)
        lane = np.arange(n, dtype=np.float32)
        w[lane[None, :] >= alive[:, None]] = 0.0  # masked lanes
        w /= w.sum(axis=1, keepdims=True)
        u = rng.random((r, 1)).astype(np.float32)
        pos = np.where(lane[None, :] < alive[:, None],
                       (lane[None, :] + u) / alive[:, None], 1.0)
        pos = pos.astype(np.float32)
        shuffled = np.take_along_axis(pos, rng.permuted(
            np.tile(np.arange(n), (r, 1)), axis=1), axis=1)
        cols = [torch.as_tensor(rng.normal(size=(r, n)).astype(np.float32),
                                device=dev) for _ in range(2)]
        cdf = cdf_ext(torch.as_tensor(w, device=dev),
                      torch.as_tensor(lane, device=dev)[None, :],
                      torch.as_tensor(alive, device=dev)[:, None])
        for name, p in (("sorted", pos), ("unsorted", shuffled)):
            pt = torch.as_tensor(np.ascontiguousarray(p), device=dev)
            got = select_cols(cdf, pt, cols)
            want = select_cols_reference(cdf, pt, cols)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            say("select", n=n, positions=name, bitwise_equal=same)
            if not same:
                raise AssertionError(f"bssm_select differs (n={n}, {name})")
    if _build.launches["bssm_select"] != 4:
        raise AssertionError("bssm_select launch count is off")

    # Time at the main path's shape: 4096 chains x 128 lanes, 2 columns.
    r, n = CHAINS, PARTICLES
    w = torch.rand((r, n), device=dev)
    w = w / w.sum(dim=1, keepdim=True)
    lane = torch.arange(n, dtype=torch.float32, device=dev)[None, :]
    cdf = cdf_ext(w, lane, torch.full((r, 1), float(n), device=dev))
    pos = (lane + torch.rand((r, 1), device=dev)) / n
    cols = [torch.randn((r, n), device=dev) for _ in range(2)]
    kernel_ms = graph_ms(lambda: select_cols(cdf, pos, cols), 20)
    plain_ms = graph_ms(lambda: select_cols_reference(cdf, pos, cols), 20)
    say("select", shape=f"{r}x{n}x2", kernel_ms=kernel_ms,
        plain_ms=plain_ms)
    return 0.0, kernel_ms, plain_ms


def phase_lgss(dev) -> None:
    from bayesssm_tpu_torch.models.lgss import simulate_lgss
    from bayesssm_tpu_torch.ops.lgss_sweep import _lgss_op
    from bayesssm_tpu_torch.utils.kalman import kalman_loglik

    a, sx, sy, c, n = 0.9, 0.6, 0.4, 512, 1024
    _, y = simulate_lgss(11, t_val=20, a=a, sigma_x=sx, sigma_y=sy)
    ys = torch.as_tensor(y, dtype=torch.float32, device=dev)
    op = _lgss_op(1.0, 1.0, "stratified", True, False)
    theta = torch.tensor([[a, sx, sy]], device=dev).expand(c, 3)
    words = words_for(c, 0, dev)
    ll_k, _ = op(words, ys, theta, n)
    ll_p, _ = op.sweep_reference(words, ys, theta, n)
    compare(ll_k, ll_p, "lgss")
    truth = kalman_loglik(y, a, 1.0, sx, sy, p0=1.0)
    lls = ll_k.double().cpu().numpy()
    se = lls.std() / np.sqrt(c)
    say("lgss", kernel_mean=lls.mean(), kalman=truth, se=se)
    if abs(lls.mean() - truth) >= max(5 * se, 0.1):
        raise AssertionError("LGSS kernel mean is off the Kalman value")


def sir_inputs(dev):
    from bayesssm_tpu_torch.models.sir import simulate_sir
    from bayesssm_tpu_torch.ops.sir_sweep import _sir_op

    _, y = simulate_sir(seed=1405)
    op, obs_transform = _sir_op(500, 70, 8, "stratified", False, False)
    y2 = obs_transform(torch.as_tensor(y, device=dev))
    return y, op, y2


def phase_sir(dev):
    from bayesssm_tpu_torch.ops import _build

    _, op, y2 = sir_inputs(dev)
    rng = np.random.default_rng(5)
    base = np.array([0.5, 0.2], np.float32)
    theta = torch.as_tensor(
        base * np.exp(0.1 * rng.normal(size=(CHAINS, 2))).astype(np.float32),
        device=dev,
    )
    words = words_for(CHAINS, 1, dev)
    before = _build.launches["bssm_sweep_sir"]
    ll_k, est_k = op(words, y2, theta, PARTICLES)
    ll_k2, est_k2 = op(words, y2, theta, PARTICLES)
    ll_p, est_p = op.sweep_reference(words, y2, theta, PARTICLES)
    torch.cuda.synchronize()
    if _build.launches["bssm_sweep_sir"] != before + 2:
        raise AssertionError("SIR sweep launch count did not advance")
    if not (torch.equal(ll_k, ll_k2) and torch.equal(est_k, est_k2)):
        raise AssertionError("SIR kernel is not deterministic")
    if not bool(torch.isfinite(est_k).all()):
        raise AssertionError("SIR state estimates are not finite")
    err = compare(ll_k, ll_p, "sir")
    kernel_ms = cuda_ms(lambda: op(words, y2, theta, PARTICLES), 10)
    plain_ms = cuda_ms(lambda: op.sweep_reference(words, y2, theta,
                                                  PARTICLES), 2)
    say("sir", shape=f"{CHAINS}x{PARTICLES}x10", kernel_ms=kernel_ms,
        plain_ms=plain_ms)
    return err, kernel_ms, plain_ms


def phase_main_path(dev):
    from bayesssm_tpu_torch.models.sir import sir_model, sir_sweep_pf_impl
    from bayesssm_tpu_torch.ops import _build
    from bayesssm_tpu_torch.pmmh.driver import init_chain_state, sample_chains
    from bayesssm_tpu_torch.pmmh.transforms import resolve_transforms

    y, op, y2 = sir_inputs(dev)
    _, log_priors, transform = sir_model()
    names = list(log_priors)
    prior_fns = [log_priors[p] for p in names]
    transforms = resolve_transforms(transform, names)
    factors = np.tile(np.diag([0.1, 0.1]).astype(np.float32), (CHAINS, 1, 1))
    pf = sir_sweep_pf_impl(500, 70)(
        y, PARTICLES, names, None, None, "BPF", "SISAR", "stratified", False,
        max_particles=PARTICLES,
    )
    state = init_chain_state([0.5, 0.2], factors, PARTICLES, 1405, dev)
    warm = sample_chains(pf, state, 2, 1, prior_fns, transforms)
    torch.cuda.synchronize()

    steps = 64
    _build.reset_launches()
    t0 = time.perf_counter()
    out = sample_chains(pf, warm.state, steps + 1, 0, prior_fns, transforms)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _build.launches["bssm_sweep_sir"]
    rate = CHAINS * steps / seconds
    acc = float(out.acceptance_rate.mean())
    say("main", steps=steps, seconds=seconds, samples_per_s=rate,
        acceptance=acc, sweep_launches=launches)
    if launches != steps:
        raise AssertionError(f"main path launched the sweep {launches} "
                             f"times for {steps} steps")
    if not np.isfinite(out.samples).all() or not 0.0 < acc < 1.0:
        raise AssertionError("main path samples are not finite, or the "
                             "acceptance rate is degenerate")

    def plain_pf(words, theta, n):
        return op.sweep_reference(words, y2, theta, n,
                                  max_particles=PARTICLES)

    plain_steps = 4
    t0 = time.perf_counter()
    sample_chains(plain_pf, warm.state, plain_steps + 1, 0, prior_fns,
                  transforms)
    torch.cuda.synchronize()
    plain_rate = CHAINS * plain_steps / (time.perf_counter() - t0)
    say("main", plain_samples_per_s=plain_rate, plain_steps=plain_steps)
    return launches, pf, warm.state, prior_fns, transforms


def phase_fused_resample(dev):
    """K3 against its plain version, bitwise, on every route it has."""
    from bayesssm_tpu_torch.ops import _build
    from bayesssm_tpu_torch.ops.resampling import _positions
    from bayesssm_tpu_torch.ops.resampling_fused import (
        POSITION_METHODS,
        fused_weight_resample,
        fused_weight_resample_reference,
        fused_weight_resample_seeded,
    )

    def routes(lw, parts, pos, uni, thr, words, alive, method, always):
        """(kernel, plain) callables of both position routes."""
        return {
            "host": (
                lambda: fused_weight_resample(lw, parts, pos, uni, thr,
                                              always),
                lambda: fused_weight_resample_reference(
                    lw, parts, uni, thr, positions=pos,
                    always_resample=always)),
            "inkernel": (
                lambda: fused_weight_resample_seeded(
                    lw, parts, words, alive, uni, thr, method, always),
                lambda: fused_weight_resample_reference(
                    lw, parts, uni, thr, key_words=words, num_alive=alive,
                    method=method, always_resample=always)),
        }

    gen = torch.Generator(device=dev).manual_seed(7)
    before = _build.launches["bssm_fused_resample"]
    calls = 0
    timed = None
    for c, n, d in ((CHAINS, PARTICLES, 2), (512, 1024, 1)):
        lane = torch.arange(n, dtype=torch.float32, device=dev)
        # Masked lanes: a quarter of the chains keep every lane.
        alive = torch.randint(n // 2, n + 1, (c,), device=dev,
                              generator=gen).to(torch.float32)
        alive[: c // 4] = float(n)
        live = lane[None, :] < alive[:, None]
        # Weight spreads from flat to peaked, so some chains resample.
        scale = 0.1 + 3.0 * torch.rand((c, 1), device=dev, generator=gen)
        lw = scale * torch.randn((c, n), device=dev, generator=gen)
        lw = torch.where(live, lw, -1e30)
        parts = torch.randn((c, n, d), device=dev, generator=gen)
        uni = torch.where(live, 1.0 / alive[:, None], 0.0)
        thr = alive / 2.0
        words = words_for(c, n, dev)
        for method in POSITION_METHODS:
            pos = _positions(words, method, n, alive)
            for always in (False, True):
                pair = routes(lw, parts, pos, uni, thr, words, alive,
                              method, always)
                for route, (kern, plain) in pair.items():
                    got, want = kern(), plain()
                    calls += 1
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b) for a, b in zip(got, want)):
                        raise AssertionError(
                            f"K3 differs: {c}x{n}x{d} {route} {method} "
                            f"always={always}")
                    if (c, route, method, always) == (
                            CHAINS, "inkernel", "stratified", False):
                        timed = (kern, plain)
        say("fused_resample", shape=f"{c}x{n}x{d}", calls=calls,
            bitwise_equal=True)
    if _build.launches["bssm_fused_resample"] != before + calls:
        raise AssertionError("bssm_fused_resample launch count is off")
    kernel_ms = graph_ms(timed[0], 20)
    plain_ms = graph_ms(timed[1], 5)
    say("fused_resample", shape=f"{CHAINS}x{PARTICLES}x2",
        mode="inkernel stratified adaptive", kernel_ms=kernel_ms,
        plain_ms=plain_ms, kernel_ms_host_issued=cuda_ms(timed[0], 20),
        plain_ms_host_issued=cuda_ms(timed[1], 5))
    return 0.0, kernel_ms, plain_ms


def phase_gillespie(dev):
    """K4 against its plain version, bitwise, at the main path's shape."""
    from bayesssm_tpu_torch.ops import _build
    from bayesssm_tpu_torch.ops.gillespie import (
        gillespie_step,
        gillespie_step_reference,
    )

    rng = np.random.default_rng(9)
    base = np.array([0.5, 0.2], np.float32)
    theta = base * np.exp(0.1 * rng.normal(size=(CHAINS, 2)))
    lam = torch.as_tensor(theta[:, 0].astype(np.float32), device=dev)
    gam = torch.as_tensor(theta[:, 1].astype(np.float32), device=dev)
    s = rng.integers(250, 431, size=(CHAINS, PARTICLES))
    i = np.minimum(rng.integers(0, 120, size=(CHAINS, PARTICLES)), 500 - s)
    i[::64] = 0                      # whole chains with I = 0
    i[:, :3] = 0                     # and some lanes of every chain
    state = torch.as_tensor(np.stack([s, i], -1).astype(np.float32),
                            device=dev)
    words = words_for(CHAINS, 4, dev)
    before = _build.launches["bssm_gillespie"]
    got = gillespie_step(words, state, lam, gam, 500)
    want = gillespie_step_reference(words, state, lam, gam, 500)
    torch.cuda.synchronize()
    if _build.launches["bssm_gillespie"] != before + 1:
        raise AssertionError("bssm_gillespie launch count is off")
    if not torch.equal(got, want):
        raise AssertionError("K4 differs from its plain version")
    if bool((got.sum(-1) > state.sum(-1)).any()) or bool((got < 0).any()):
        raise AssertionError("K4 broke the population bounds")
    def kern():
        return gillespie_step(words, state, lam, gam, 500)

    kernel_ms = graph_ms(kern, 20)
    # The plain event loop asks the host whether any lane is still active
    # on every iteration, so it cannot be captured: its time includes the
    # host's, as it does on the engine path.
    plain_ms = cuda_ms(
        lambda: gillespie_step_reference(words, state, lam, gam, 500), 3)
    say("gillespie", shape=f"{CHAINS}x{PARTICLES}", bitwise_equal=True,
        kernel_ms=kernel_ms, plain_ms=plain_ms,
        kernel_ms_host_issued=cuda_ms(kern, 20))
    return 0.0, kernel_ms, plain_ms


def phase_engine_lgss(dev):
    """LGSS through the engine's bootstrap filter, K3 every day."""
    from bayesssm_tpu_torch.filters import bootstrap_filter
    from bayesssm_tpu_torch.models.lgss import lgss_model, simulate_lgss
    from bayesssm_tpu_torch.ops import _build
    from bayesssm_tpu_torch.utils.kalman import kalman_loglik

    a, sx, sy, c, n, t = 0.9, 0.6, 0.4, 512, 1024, 20
    _, y = simulate_lgss(11, t_val=t, a=a, sigma_x=sx, sigma_y=sy)
    (init_fn, trans_fn, ll_fn), _, _ = lgss_model()
    before = _build.launches["bssm_fused_resample"]
    res = bootstrap_filter(words_for(c, 2, dev), y, n, init_fn, trans_fn,
                           ll_fn, theta=dict(a=a, sigma_x=sx, sigma_y=sy),
                           resample_algorithm="SISR", use_fused="auto",
                           return_particles=False)
    lls = res.loglike.double().cpu().numpy()
    launched = _build.launches["bssm_fused_resample"] - before
    if launched != t:
        raise AssertionError(f"the LGSS engine launched K3 {launched} "
                             f"times over {t} days")
    truth = kalman_loglik(y, a, 1.0, sx, sy, p0=1.0)
    se = lls.std() / np.sqrt(c)
    say("engine_lgss", k3_launches=launched, mean=lls.mean(), kalman=truth,
        se=se, finite=bool(np.isfinite(lls).all()))
    if not np.isfinite(lls).all() or abs(lls.mean() - truth) >= max(
            5 * se, 0.1):
        raise AssertionError("the LGSS engine mean is off the Kalman value")


def engine_pf(dev, plain=False):
    """The slice's batched filter: ``_make_pf_loglike`` on SIR with the
    per-day kernels, or with their plain versions (portable weight step,
    plain day-step) when ``plain``."""
    from bayesssm_tpu_torch.models.sir import simulate_sir, sir_model
    from bayesssm_tpu_torch.ops.gillespie import gillespie_step_reference
    from bayesssm_tpu_torch.pmmh.tuning import _make_pf_loglike

    _, y = simulate_sir(seed=1405)
    (init_fn, trans_fn, ll_fn), log_priors, transform = sir_model(
        500, 70, transition="gillespie_pallas")
    names = list(log_priors)
    if not plain:
        return _make_pf_loglike(
            y, PARTICLES, names, (init_fn, trans_fn, ll_fn, None, None),
            None, "BPF", "SISAR", "stratified", False,
            max_particles=PARTICLES), log_priors, transform
    from bayesssm_tpu_torch.filters import bootstrap_filter

    def plain_trans(key, particles, lam, gamma):
        return gillespie_step_reference(key, particles, lam, gamma, 500)

    ys = torch.as_tensor(y, dtype=torch.float32, device=dev)

    def pf(words, theta, n):
        res = bootstrap_filter(
            words, ys, n, init_fn, plain_trans, ll_fn,
            theta={q: theta[:, j] for j, q in enumerate(names)},
            return_particles=False, max_particles=PARTICLES,
            use_fused=False)
        return res.loglike, res.state_est

    return pf, log_priors, transform


def phase_engine_path(dev):
    from bayesssm_tpu_torch.ops import _build
    from bayesssm_tpu_torch.pmmh.driver import init_chain_state, sample_chains
    from bayesssm_tpu_torch.pmmh.transforms import resolve_transforms

    pf, log_priors, transform = engine_pf(dev)
    names = list(log_priors)
    prior_fns = [log_priors[p] for p in names]
    transforms = resolve_transforms(transform, names)
    factors = np.tile(np.diag([0.1, 0.1]).astype(np.float32), (CHAINS, 1, 1))
    state = init_chain_state([0.5, 0.2], factors, PARTICLES, 1405, dev)
    warm = sample_chains(pf, state, 2, 1, prior_fns, transforms)
    torch.cuda.synchronize()

    steps = 32
    _build.reset_launches()
    t0 = time.perf_counter()
    out = sample_chains(pf, warm.state, steps + 1, 0, prior_fns, transforms)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(_build.launches)
    rate = CHAINS * steps / seconds
    acc = float(out.acceptance_rate.mean())
    say("engine", steps=steps, seconds=seconds, samples_per_s=rate,
        acceptance=acc, k3_launches=counts["bssm_fused_resample"],
        k4_launches=counts["bssm_gillespie"],
        k1_launches=counts["bssm_sweep_sir"])
    for name in ("bssm_fused_resample", "bssm_gillespie"):
        if counts[name] != 10 * steps:
            raise AssertionError(f"the engine path launched {name} "
                                 f"{counts[name]} times in {steps} steps")
    if not np.isfinite(out.samples).all() or not 0.0 < acc < 1.0:
        raise AssertionError("engine path samples are not finite, or the "
                             "acceptance rate is degenerate")

    plain_pf, _, _ = engine_pf(dev, plain=True)
    plain_steps = 2
    t0 = time.perf_counter()
    sample_chains(plain_pf, warm.state, plain_steps + 1, 0, prior_fns,
                  transforms)
    torch.cuda.synchronize()
    plain_rate = CHAINS * plain_steps / (time.perf_counter() - t0)
    say("engine", plain_samples_per_s=plain_rate, plain_steps=plain_steps)
    return counts, pf, warm.state, prior_fns, transforms


def phase_pmmh(path, control):
    """The public ``pmmh()`` with pilot tuning at full width on one path:
    ``"sweep"`` (``pf_impl=sir_sweep_pf_impl(500, 70)``, K1) or
    ``"engine"`` (the default filter on ``sir_model(transition=
    "gillespie_pallas")``, K4 and K3). Returns the kernel launch counts of
    the call and its output."""
    import warnings

    from bayesssm_tpu_torch import pmmh
    from bayesssm_tpu_torch.models.sir import (
        simulate_sir,
        sir_model,
        sir_sweep_pf_impl,
    )
    from bayesssm_tpu_torch.ops import _build
    from bayesssm_tpu_torch.pmmh.driver import _particle_lane_bound

    chains, m, burn_in = CHAINS, PMMH_M, PMMH_BURN_IN
    _, y = simulate_sir(seed=1405)
    (init_fn, trans_fn, ll_fn), log_priors, transform = sir_model(
        500, 70, transition="gillespie_pallas")
    pf_impl = sir_sweep_pf_impl(500, 70) if path == "sweep" else None
    _build.reset_launches()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # ESS/R-hat advice on short runs
        out = pmmh("bootstrap_filter", y, m, init_fn, trans_fn, ll_fn,
                   log_priors, {"lam": 0.5, "gamma": 0.2}, burn_in,
                   num_chains=chains, param_transform=transform, seed=1405,
                   tune_control=control, pf_impl=pf_impl,
                   print_summary=False)
    counts = dict(_build.launches)
    t = out.timings
    tn = out.target_n
    acc = float(out.acceptance_rate.mean())
    say("pmmh", path=path, chains=chains, m=m, burn_in=burn_in,
        pilot_m=control.pilot_m, pilot_reps=control.pilot_reps,
        cut="pilot_m 2000->200 and pilot_reps 100->20 (bench.py's)",
        tuning_s=t["tuning"], compile_s=t["compile"],
        sampling_s=t["sampling"],
        samples_per_s=chains * (m - 1) / t["sampling"],
        target_n_min=int(tn.min()), target_n_median=float(np.median(tn)),
        target_n_max=int(tn.max()),
        lane_bound=_particle_lane_bound(int(tn.max())), acceptance=acc,
        k1_launches=counts["bssm_sweep_sir"],
        k3_launches=counts["bssm_fused_resample"],
        k4_launches=counts["bssm_gillespie"])
    for q in out.param_names:
        # A chain whose pilot never moved in its second half gets a zero
        # proposal (zero pilot covariance, as in the JAX driver) and never
        # moves: its zero variance makes ESS and R-hat NaN.
        frozen = np.ptp(out.theta_chain[q], axis=1) == 0
        say("pmmh", path=path, param=q, ess=out.diagnostics["ess"][q],
            rhat=out.diagnostics["rhat"][q],
            mean=float(out.theta_chain[q].mean()),
            frozen_chains=int(frozen.sum()),
            frozen_values=out.theta_chain[q][frozen, 0][:4].tolist(),
            frozen_acceptance=out.acceptance_rate[frozen][:4].tolist())
    samples = np.stack(list(out.theta_chain.values()))
    if samples.shape != (2, chains, m - burn_in):
        raise AssertionError(f"pmmh ({path}) samples have shape "
                             f"{samples.shape}")
    if not np.isfinite(samples).all() or not 0.0 < acc < 1.0:
        raise AssertionError(f"pmmh ({path}): samples not finite, or the "
                             "acceptance rate is degenerate")
    if tn.min() < 50 or tn.max() > 1000:
        raise AssertionError(f"pmmh ({path}): target_n outside [50, 1000]")
    k1 = counts["bssm_sweep_sir"]
    k34 = (counts["bssm_fused_resample"], counts["bssm_gillespie"])
    if path == "sweep" and (k1 == 0 or any(k34)):
        raise AssertionError(f"pmmh sweep path launched K1 {k1} times and "
                             f"K3/K4 {k34} times")
    if path == "engine" and (k1 != 0 or not all(k34)):
        raise AssertionError(f"pmmh engine path launched K1 {k1} times and "
                             f"K3/K4 {k34} times")
    return counts, out


def pmmh_phase2(dev, path, out):
    """The filter and a sampler state as ``pmmh()``'s phase 2 holds them
    after ``out``: the same lane bound and per-chain counts, the chains'
    last samples, a diagonal proposal (for ``--profile``)."""
    from bayesssm_tpu_torch.models.sir import (
        simulate_sir,
        sir_model,
        sir_sweep_pf_impl,
    )
    from bayesssm_tpu_torch.pmmh.driver import (
        _particle_lane_bound,
        init_chain_state,
        sample_chains,
    )
    from bayesssm_tpu_torch.pmmh.transforms import resolve_transforms
    from bayesssm_tpu_torch.pmmh.tuning import _make_pf_loglike

    _, y = simulate_sir(seed=1405)
    fns, log_priors, transform = sir_model(500, 70,
                                           transition="gillespie_pallas")
    names = list(log_priors)
    bound = _particle_lane_bound(int(out.target_n.max()))
    factory = sir_sweep_pf_impl(500, 70) if path == "sweep" else (
        _make_pf_loglike)
    pf = factory(y, None, names, (*fns, None, None), None, "BPF", "SISAR",
                 "stratified", False, max_particles=bound)
    c = len(out.target_n)
    last = np.stack([out.theta_chain[q][:, -1] for q in names], axis=1)
    factors = np.tile(np.diag([0.1, 0.1]).astype(np.float32), (c, 1, 1))
    state = init_chain_state(last, factors, out.target_n, 1405, dev)
    prior_fns = [log_priors[q] for q in names]
    transforms = resolve_transforms(transform, names)
    warm = sample_chains(pf, state, 2, 1, prior_fns, transforms)
    return pf, warm.state, prior_fns, transforms


def profile_steps(what, pf, state, prior_fns, transforms, steps=8):
    """Device busy share of ``steps`` MH steps under ``torch.profiler``:
    the union of the CUDA kernels' intervals over the window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from bayesssm_tpu_torch.pmmh.driver import sample_chains

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sample_chains(pf, state, steps + 1, 0, prior_fns, transforms)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)[:6]
    say("profile", path=what, steps=steps, wall_ms=wall_us / 1e3,
        device_busy_ms=busy / 1e3, busy_share=busy / wall_us,
        device_ops=len(spans))
    for e in top:
        say("profile", path=what, op=repr(e.key[:60]),
            device_ms=e.device_time_total / 1e3, calls=e.count)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's check needs one card",
              file=sys.stderr)
        return 1
    import bayesssm_tpu_torch  # noqa: F401  (fails outside a checkout)
    from bayesssm_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    say("device", kind=repr(kind), count=count, torch=torch.__version__,
        cuda=torch.version.cuda, nvidia_smi=repr(smi))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    _build.load_library()
    info = _build.build_info
    ptx = [ln.strip() for ln in info["ptxas"].splitlines()
           if re.search(r"registers|spill", ln)]
    say("build", seconds=f"{info['seconds']:.2f}", library=info["path"])
    for ln in ptx:
        print(f"[build] {ln}")

    select_err, select_ms, select_plain_ms = phase_select(dev)
    phase_lgss(dev)
    err, kernel_ms, plain_ms = phase_sir(dev)
    sweep_launches, sweep_pf, sweep_state, prior_fns, transforms = (
        phase_main_path(dev))
    k3_err, k3_ms, k3_plain_ms = phase_fused_resample(dev)
    k4_err, k4_ms, k4_plain_ms = phase_gillespie(dev)
    phase_engine_lgss(dev)
    counts, eng_pf, eng_state, prior_fns, transforms = phase_engine_path(dev)
    if "--profile" in sys.argv[1:]:
        profile_steps("sweep", sweep_pf, sweep_state, prior_fns, transforms)
        profile_steps("engine", eng_pf, eng_state, prior_fns, transforms)

    from bayesssm_tpu_torch import default_tune_control

    control = default_tune_control(pilot_m=200, pilot_burn_in=50,
                                   pilot_reps=20)
    pmmh_counts = []
    for path in ("sweep", "engine"):
        run_counts, out = phase_pmmh(path, control)
        pmmh_counts.append(run_counts)
        if "--profile" in sys.argv[1:]:
            profile_steps(f"pmmh-{path}", *pmmh_phase2(dev, path, out))
    for name in counts:
        counts[name] += sum(c[name] for c in pmmh_counts)
    sweep_launches += sum(c["bssm_sweep_sir"] for c in pmmh_counts)

    # select_index has no launch of its own on either path: it runs inside
    # every sweep and every fused-resample launch counted here.
    select_launches = sweep_launches + counts["bssm_fused_resample"]
    say("select", main_path_launches_of_its_kernels=select_launches)
    print(json.dumps({"kernels": [
        {"name": "bssm_sweep_sir", "route": ROUTE, "source": SWEEP_SOURCE,
         "replaces": SWEEP_REPLACES, "launches": sweep_launches,
         "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms},
        {"name": "bssm_select", "route": ROUTE, "source": SELECT_SOURCE,
         "replaces": SELECT_REPLACES, "launches": select_launches,
         "max_abs_err": select_err, "ms": select_ms,
         "plain_ms": select_plain_ms},
        {"name": "bssm_fused_resample", "route": ROUTE,
         "source": RESAMPLE_SOURCE, "replaces": RESAMPLE_REPLACES,
         "launches": counts["bssm_fused_resample"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain_ms},
        {"name": "bssm_gillespie", "route": ROUTE,
         "source": GILLESPIE_SOURCE, "replaces": GILLESPIE_REPLACES,
         "launches": counts["bssm_gillespie"], "max_abs_err": k4_err,
         "ms": k4_ms, "plain_ms": k4_plain_ms},
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
