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
2. kernel build: seconds, registers and spills from ``-Xptxas -v``, and
   the registers and resident blocks per SM of K4 and of K1 with the SIR
   functor at 128 and 1024 lanes, and K3's registers and resident warps
   (one chain each) per SM at 128 and 1024 lanes, from the CUDA runtime
   (``_build.occupancy``);
3. ``bssm_select`` against searchsorted + gather, bitwise, N in {128, 1024};
4. LGSS sweep kernel against the plain sweep (C=512, N=1024, T=20, SISR):
   >= 99% of chains within 1e-3 in loglike, mean within max(5 SE, 0.1) of
   the exact Kalman value;
5. SIR sweep kernel against the plain sweep at 4096 x 128 x 10: >= 99% of
   chains within 1e-3, all finite, a second launch bitwise equal; kernel
   ms per sweep by CUDA-graph replay (and CUDA events), plain ms;
6. the sweep path: one warm-up MH step, then 64 timed steps (samples/s on
   the host clock up to ``torch.cuda.synchronize()``), the plain sweep
   over 4 steps, and an acceptance rate strictly inside (0, 1);
7. the fused weight step (K3) against its plain version at 4096 x 128
   (d = 2) and 512 x 1024 (d = 1): host and in-kernel positions,
   stratified/systematic/multinomial, adaptive and always, masked lanes;
   columns, weights, ESS and log-sum-exp bitwise; kernel and plain ms;
8. the Gillespie day-step (K4) against its plain version at 4096 x 128,
   rates spread as in phase 5 and some chains with I = 0: S and I bitwise;
   kernel and plain ms; then on the states the engine path hands it (the
   particles of phase 10's engine before each of its 10 days,
   ``engine_day_states``): each day bitwise, and ms a launch by CUDA-graph
   replay beside its bound;
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
    strictly inside (0, 1), target_n in [50, 1000];
12. K1's APF, RMPF and gapped sweeps (``obs_times`` with gaps of 1-3
    days) against the plain sweep at 4096 x 128 x 10: bitwise, or >= 99%
    of chains within 1e-3; kernel ms as in phase 5, and plain ms;
13. K3 as the engine's APF aux resample runs it (3 columns: S, I and the
    clamped aux log-weight; forced) at 4096 x 128, bitwise;
14. MH samples/s of the APF and the RMPF, the port of ``bench.py
    --config apf|rmpf`` with either ``--transition``: the sweep path 64
    steps, the engine path 32 steps with K4 and K3 launched twice a day
    (APF) or once (RMPF); finite samples, acceptance strictly inside
    (0, 1);
15. ``pmmh("auxiliary_filter")`` and ``pmmh("resample_move_filter")`` on
    both paths with phase 11's control, m = 128 and burn_in = 32;
16. the kernels at the 1024-lane bound the APF runs of phase 15 reach
    (4096 chains, per-chain counts spread over 50..1000): K1's APF
    against the plain sweep (>= 99% of chains within 1e-3), K3 as the
    engine's APF day step and aux resample, and K4, bitwise; kernel and
    plain ms;
17. K1 with the sinusoidal functor (K1c) against the plain sweep at the
    width of ``bench.py --config sinusoidal`` (4096 x 128, T = 20, theta
    spread around (0.8, 1.0, 0.5)) and at the README's lane bound (4096 x
    1024, counts 50..1000): bitwise, or >= 99% of chains within 1e-3;
    kernel ms (CUDA events, 10 launches), plain ms, the bound;
18. K1 with the LGSS-mv functor (K1b-mv) against the plain sweep at
    phase 4's shape (512 x 1024, T = 20, SISR), contiguous and with
    ``obs_times`` gaps; then the public ``lgss_mv_bpf_sweep`` on both,
    counted, its contiguous mean within max(5 SE, 0.1) of
    ``kalman_loglik_mv``;
19. the port of ``bench.py --config sinusoidal``: theta0 = (0.8, 1.0,
    0.5), log-space proposal sd (0.05, 0.1, 0.1), 4096 x 128 x 20; the
    sweep path (``sinusoidal_sweep_pf_impl``) 64 steps with one K1c launch
    each, the engine path 32 steps with 20 K3 launches each and no other
    kernel; samples/s, acceptance strictly inside (0, 1);
20. ``pmmh()`` on the README model at 4096 chains on both paths
    (``pilot_init_params`` alternating (0.4, 0.4, 0.4) and (0.8, 0.8,
    0.8), phase 11's control, m = 128, burn_in = 32): tuning s, sampling
    samples/s, target_n and the lane bound, acceptance, posterior means,
    ESS and R-hat; finite samples, target_n in [50, 1000];
21. the engine on the rest of the zoo: ``pmmh()`` on ``sv_model()``
    (logit phi) at 4096 chains, T = 50, m = 64, K3 launched; and 8 MH
    steps of ``sir_model(transition="tauleap")`` at 4096 x 128 x 10 (the
    port of ``bench.py --transition tauleap``), 10 K3 launches and no K4 a
    step;
22. user-written callbacks on the card (K1g, the functor that
    ``ops/sweep_codegen.py`` generates from traced ``torch`` callbacks):
    (a) the SV callbacks of ``examples/torch_custom_sweep_kernel.py``
    against their plain sweep at 4096 x 128 x 50 (``simulate_sv(1405)``,
    theta spread around (0.95, 0.3, -1.0)) for BPF, APF, RMPF (the move of
    ``tests/test_sweep_builder.py:43-48``) and a gapped sweep (50
    observations over 70 steps), and BPF at 4096 x 1024 with counts
    50..1000: bitwise, or >= 99% of chains within 1e-3; (b) the functor
    generated from the port's sinusoidal callbacks against the hand-written
    K1c on phase 17's inputs, bit for bit; (c) K1g's ms by CUDA-graph
    replay and its bound, the lane instructions counted from the IR
    (``ir_instr``); (d) the example's ``pmmh()`` through
    ``build_sweep_pf_impl`` at phase 21's setting, only
    ``bssm_sweep_generated`` launched, beside phase 21's engine figure;
    (e) every op the tracer maps (``sweep_codegen.op_zoo``) through its
    generated kernel against PyTorch's CUDA ops, bit for bit;
23. Metropolis resampling, which bypasses K3: (a)
    ``metropolis_resample_indices`` at 4096 x 128, 256 steps, counts
    50..128, bitwise with the CPU on 512 seeded chains; ms a call and
    device ops a call (``device_ops``); (b) the engine's LGSS BPF with
    ``resample_fn="metropolis"`` at 4096 x 128, T = 20, SISR, no K3
    launch, its mean within max(5 SE, 0.3) of the stratified engine's;
    (c) ``pmmh(resample_fn="metropolis")`` on the SIR engine with phase
    11's control, m = 24: the pilot launches K3, phase 2 (counted through
    a ``pf_impl`` around the default filter) K4 and no K3; samples/s,
    device ops of one MH step beside the stratified step's;
24. checkpoint/resume through ``pmmh()`` at 4096 chains on the SIR sweep
    path (m = 64, a snapshot every 16 steps) and the engine (m = 16, every
    4): uninterrupted, chunked, and m / 2 then resumed, equal bit for bit;
    the snapshot's step and samples, no temporary file left, no tuning
    and only the MH steps' launches in the resumed run; seconds and bytes
    per snapshot write;
25. the host resampler, built with this machine's ``g++``, against the
    NumPy definition of the three schemes on 4096 rows of 128 weights;
26. multi-rank, NCCL: a child process joins a one-rank NCCL group, builds
    ``global_chain_mesh()`` and runs phase 15's RMPF ``pmmh(mesh=...)``
    on both paths; samples, counts and acceptance equal phase 15's bit for
    bit, the launches too, and the outputs' gathers run on NCCL;
27. multi-rank, two ranks on the card over gloo (NCCL refuses two ranks
    on one device): (a) phase 15's sweep RMPF ``pmmh()`` on a 2 x 1 chains
    mesh, 2048 chains a rank, both ranks' full output equal to phase 15's
    bit for bit; on a 1 x 2 particle mesh (b) the SIR RMPF
    ``sharded_particle_filter`` on the engine at 4096 chains x 256
    particles (128 a rank), K4 once a day on each rank and K3 never, its
    mean within max(5 SE, 0.1) of the unsharded engine's at 256
    particles; (c) the LGSS ``sharded_bootstrap_filter`` at phase 9's
    shape within max(5 SE, 0.1) of the Kalman value; (d) the SIR BPF
    ``pmmh()`` on the engine at 4096 chains, m = 32, phase 24's engine
    pilot (100 steps, 10 repetitions):
    finite samples, acceptance strictly inside (0, 1), target_n in [50,
    1000], tuning and sampling seconds and the seconds a filter day waits
    in gloo collectives (``collective_clock``). The children's launches
    count in the kernels line;
28. the port's bench entry, ``bench_torch.main(argv)`` in-process
    (``BENCH_RUNS``): ``bench.py``'s default (SIR BPF on the whole sweep)
    and ``--transition gillespie_pallas`` at full width (4096 chains, 64
    steps x 2 calls x 5 reps), then ``--quick`` for ``--config apf``,
    ``rmpf``, ``sinusoidal``, ``pmmh`` and ``--transition tauleap``: each
    record's four keys, a finite positive value and ``vs_baseline``, and
    the launches each route implies a filter call (K1 once on
    ``sir_sweep``, K4 and K3 ten times on ``gillespie_pallas``, K3 ten
    times and no K4 on ``tauleap``, K1c once on ``sinusoidal``; K1 alone
    for ``pmmh``), printed beside the card's name and power limit;
29. the examples on the card (``EXAMPLE_RUNS``):
    ``examples/torch_sinusoidal_readme.py --fused`` at the README's m = 500
    (K1c only), its posterior means within ``tests/test_parity.py``'s 3-SE
    bands of the README's table and target_n in [50, 1000];
    ``examples/torch_stochastic_sir.py`` at its own settings (K4 and K3)
    and ``examples/torch_stochastic_volatility.py`` cut as
    ``EXAMPLE_RUNS`` says (K3): finite samples, acceptance strictly inside
    (0, 1), means, SDs and ESS printed.

Each kernel's bound is the larger of the bytes it must move over the
card's memory rate and its lane instructions over the card's rate for
their pipe (``bound``); K1's and K4's instructions are mostly the
Gillespie events this run's data needs, counted by the plain versions
(``EventTally``); K1c's and K1b-mv's are their functors' normals, ``sinf``
and Gaussian weights, counted from the source; K1g's are its IR's ops,
priced alike (``ir_instr``).

``--profile`` adds a ``torch.profiler`` window over 8 steps of each path
(and of each ``pmmh()`` path's phase 2, at its lane bound and counts)
and prints the device busy share. Any failure raises (exit code not 0).
Without a CUDA device it fails before printing any result. The last line
is one JSON object ``{"ok": true, "device": {...}}``; the line before it is
nvidia-smi's, and the one before that the per-kernel JSON.
"""

from __future__ import annotations

import contextlib
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

import bench_torch  # noqa: E402  (the port's bench entry, beside this file)

ROUTE = "cuda"
SWEEP_SOURCE = "bayesssm_tpu_torch/csrc/sweep.cuh"
SWEEP_REPLACES = "bayesssm_tpu/ops/sweep_builder.py:146"
# K2 as its standalone entry and K3 run it (one warp a row); inside K1 it
# is csrc/select.cuh::select_index.
SELECT_SOURCE = "bayesssm_tpu_torch/csrc/warp_reduce.cuh"
SELECT_REPLACES = "bayesssm_tpu/ops/merge_select.py:131"
RESAMPLE_SOURCE = "bayesssm_tpu_torch/csrc/resample.cu"
RESAMPLE_REPLACES = "bayesssm_tpu/ops/resampling_pallas.py:60"
GILLESPIE_SOURCE = "bayesssm_tpu_torch/csrc/gillespie.cu"
GILLESPIE_REPLACES = "bayesssm_tpu/ops/gillespie_pallas.py:71"
SIN_REPLACES = "bayesssm_tpu/models/sinusoidal.py:55"
# K1 with a user's callbacks: the JAX builder's public escape hatch.
GEN_REPLACES = "bayesssm_tpu/ops/sweep_builder.py:146"
LGSS_MV_REPLACES = "bayesssm_tpu/ops/lgss_sweep_pallas.py:116"
SIN_THETA0 = bench_torch.THETA0["sinusoidal"]   # bench.py:46-47
CHAINS, PARTICLES = 4096, 128
AGREE_TOL = 1e-3       # |d loglike| per chain, kernel vs plain sweep
AGREE_SHARE = 0.99     # share of chains that must agree within AGREE_TOL
# pmmh() as the JAX package's `bench.py --config pmmh` runs it.
PMMH_M, PMMH_BURN_IN = 512, 128
# The APF and RMPF pmmh() runs are cut to a quarter of the steps: at
# m = 512 the engine's RMPF alone took 116 s of the script's 214 s (H100,
# 700 W). The width stays.
FILTER_PMMH_M, FILTER_PMMH_BURN_IN = 128, 32
# Phase 23: chains whose Metropolis indices the CPU recomputes, and the
# Metropolis pmmh()'s steps: m = 32 took 44 s of phases 23-25's 100 s
# (a Metropolis engine step is ~1.4 s; H100, 700 W), so m is cut to 24.
METROPOLIS_CHECK_ROWS = 512
METROPOLIS_PMMH_M, METROPOLIS_PMMH_BURN_IN = 24, 8
# Phase 24: (path, m, burn_in, checkpoint_every, pilot settings or None
# for phase 11's) of each checkpoint/resume run. Three engine pilots at
# phase 11's settings took ~18 s; the engine's pilot is halved.
CHECKPOINT_RUNS = (("sweep", 64, 16, 16, None),
                   ("engine", 16, 4, 4, dict(pilot_m=100, pilot_burn_in=25,
                                             pilot_reps=10)))
# Phases 26 and 27, the multi-rank paths. NCCL refuses two ranks on one
# card ("Duplicate GPU detected", seen on the H100 before these phases were
# written), so NCCL runs as a one-rank group (26) and the two-rank logic
# runs over gloo, which stages CUDA tensors through the host (27). A child
# rank that fails, or outlives RANK_TIMEOUT_S seconds (start-up included),
# fails the script.
RANK_TIMEOUT_S = 300
# Phase 27: (b) the particle-sharded SIR RMPF filter's particles (128 a
# rank, the main path's width) and its root seed; (d) the particle-sharded
# pmmh()'s steps, cut from phase 11's m = 512 to 32, and its pilot, cut
# from phase 11's 200 steps and 20 repetitions to phase 24's engine pilot:
# at phase 11's, (d) tuned for 86 s of phases 26-27's 205 s, 53 s of it
# in gloo collectives (7 a filter day, 23 ms; H100, 700 W).
SHARDED_PARTICLES, SHARDED_SEED = 256, 27
SHARDED_PMMH_M, SHARDED_PMMH_BURN_IN = 32, 8
SHARDED_PILOT = dict(pilot_m=100, pilot_burn_in=25, pilot_reps=10)
# Observation gaps of the gapped sweep: 10 observations over 14 days.
GAPS = (1, 2, 1, 1, 3, 1, 1, 2, 1, 1)
# One H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM bandwidth, and
# 67 TFLOP/s in float32 outside the tensor cores, which counts a fused
# multiply-add as two: 128 lanes x 2 x 132 SMs x 1.98 GHz.
PEAK_BYTES_S = 3.35e12
# Seconds of untimed calls before each timing (``cuda_ms``). Without them
# the first kernel timed after host-bound work read up to 25% slow (H100
# 80GB HBM3, 700 W).
WARM_S = 1.0
SM_CLOCKS_S = 67e12 / (2 * 128)
# Lane instructions per SM and clock on compute capability 9.0 (the CUDA
# C++ Programming Guide's throughput table): four schedulers issue 32
# lanes each (and 128 float32 adds or multiplies run), 64 integer adds,
# logic ops, shifts and compares, 16 MUFU operations (reciprocal, exp2,
# log2) or conversions. The kernels are built with --fmad=false, so a
# float32 add or multiply is one instruction, not half of one FMA.
ISSUE_PER_SM, ALU_PER_SM, XU_PER_SM = 128, 64, 16
# Lane instructions per Gillespie event (models.cuh::sir_attempt), counted from
# the source as (all, integer ALU, MUFU or conversion): two counter draws
# (14 each: counter add and multiply, key xor, lowbias32's three shift-xor
# pairs and two multiplies, the shift, one conversion, the scale), the
# rates (4), the IEEE reciprocal (~6, one MUFU), log1pf (~20, one
# conversion) and the clock, event choice and predicated updates (~14).
EVENT_INSTR = (72, 25, 4)
# Lane instructions of the Gaussian functors (models.cuh, rng.cuh), as
# above: a Box-Muller normal (two counter draws, logf ~20, sqrtf ~8, cosf
# on its fast path ~25, five multiplies and adds); sinf on its fast path
# (~25, a few integer ops of its quadrant); a Gaussian weight (subtract,
# IEEE divide ~8, three multiplies and subtracts, logf ~20).
NORMAL_INSTR = (90, 24, 5)
SINF_INSTR = (25, 4, 0)
GAUSS_WEIGHT_INSTR = (35, 0, 3)
# Each IR op of a generated functor, priced as above: a counter draw 14
# (12 integer, one conversion); expf, logf, log1pf, expm1f, tanhf ~20 with
# one MUFU; sqrtf, an IEEE divide or reciprocal ~8 with one MUFU; sinf and
# cosf as SINF_INSTR; powf ~40; NaN-propagating max/min/clamp 3; every
# other op (add, multiply, compare, select, a host int) 1.
IR_PRICE = {"uniform": (14, 12, 1), "normal": NORMAL_INSTR,
            "exp": (20, 0, 1), "log": (20, 0, 1), "log1p": (20, 0, 1),
            "expm1": (20, 0, 1), "tanh": (20, 0, 1), "sqrt": (8, 0, 1),
            "recip": (8, 0, 1), "sin": SINF_INSTR, "cos": SINF_INSTR,
            "maximum": 3, "minimum": 3, "clamp": 3}


def instr(*parts):
    """Sum of instruction tuples ``(all, alu, xu)``; a plain int counts
    that many float instructions."""
    tuples = [q if isinstance(q, tuple) else (q, 0, 0) for q in parts]
    return tuple(sum(q[j] for q in tuples) for j in range(3))


def ir_instr(fn):
    """Lane instructions of one call of a traced callback (``IR_PRICE``;
    a divide by a traced value ~8 with one MUFU, by a number 1; ``pow`` by
    its exponent)."""
    from bayesssm_tpu_torch.ops.sweep_codegen import Const

    parts = []
    for node in fn.nodes:
        if node.op in ("col", "theta", "obs", "time"):
            continue
        if node.op == "div" and not isinstance(node.args[1], Const):
            parts.append((8, 0, 1))
        elif node.op == "pow":
            e = float(node.attr)
            parts.append({0.0: 0, 1.0: 0, 2.0: 1, 3.0: 2, -0.5: (4, 0, 1)}
                         .get(e, (8, 0, 1) if e in (0.5, -1.0, -2.0)
                              else (40, 0, 2)))
        else:
            parts.append(IR_PRICE.get(node.op, 1))
    return instr(*parts)


def stage_instr(n: int):
    """Lane instructions, at least, of one weight-and-selection stage of a
    K1 day (or of K3) outside the events: log-weight, exp and the
    normalising divides (~50), a position draw (~25), the reductions,
    the CDF scan and the binary search (~20 per halving of ``n``); an APF
    day has two stages, and an RMPF day's move costs about one more."""
    return (100 + 20 * math.log2(n), 0, 6)


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


def cuda_ms(fn, reps: int, warm_s: float = WARM_S) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls, after
    calling it for ``warm_s`` seconds (at least once): a card that has
    idled on host-bound work runs the first calls at a lower clock."""
    t0 = time.perf_counter()
    while True:
        fn()
        torch.cuda.synchronize()
        if time.perf_counter() - t0 >= warm_s:
            break
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


def bound(bytes_moved: float, *work):
    """``(bound_ms, bound_by)``: the larger of bytes over the memory rate
    and the lane instructions over the card's rate for their pipe. Each
    ``work`` item is ``(count, (all, alu, xu))``: ``count`` times that many
    lane instructions of each kind."""
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    issue, alu, xu = (sum(k * w[j] for k, w in work) for j in range(3))
    t_ops = max(issue / ISSUE_PER_SM, alu / ALU_PER_SM,
                xu / XU_PER_SM) / SM_CLOCKS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sweep_bound(c: int, n: int, live: float, t: int, stages: int, tally):
    """K1 over ``c`` chains of ``n`` lanes, ``live`` of them alive: reads
    seeds, the [T, 2] observation rows, theta, counts and thresholds,
    writes loglike and [T+1, 2] estimates; its instructions are the
    tallied events plus ``stages`` weight-and-selection stages a live
    lane."""
    bytes_moved = 4 * (6 * c + 2 * t) + 4 * (c + 2 * c * (t + 1))
    return bound(bytes_moved, (tally.fired, EVENT_INSTR),
                 (live * stages, stage_instr(n)))


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

    def library():
        # The nearest PyTorch has: an upper-bound search and a gather per
        # column (two library calls; the plain version is the same).
        m = torch.searchsorted(cdf, pos, right=True).clamp_(max=n - 1)
        return [torch.gather(col, 1, m) for col in cols]

    library_ms = graph_ms(library, 20)
    # Reads cdf, pos and the columns, writes the columns; a lane's binary
    # search takes ~6 instructions per halving, its loads and stores ~8.
    bound_ms, bound_by = bound(4 * r * n * (2 + 2 * 2),
                               (r * n, (6 * math.log2(n) + 8, 0, 0)))
    say("select", shape=f"{r}x{n}x2", kernel_ms=kernel_ms,
        plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
        bound_by=bound_by, share_of_bound=bound_ms / kernel_ms)
    return dict(max_abs_err=0.0, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


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


def sir_inputs(dev, algorithm="BPF", gaps=None):
    from bayesssm_tpu_torch.models.sir import simulate_sir
    from bayesssm_tpu_torch.ops.sir_sweep import _sir_op

    _, y = simulate_sir(seed=1405)
    op, obs_transform = _sir_op(500, 70, 8, "stratified",
                                algorithm == "RMPF", False, algorithm, 2,
                                gaps)
    y2 = obs_transform(torch.as_tensor(y, device=dev))
    return y, op, y2


def kernel_vs_plain(what, entry, op, words, ys, theta, alive, n,
                    plain_context=None):
    """K1 (``entry``) launched twice and its plain sweep run once on the
    same inputs (the plain one inside ``plain_context``): fails unless the
    launch count advanced by two and the kernel is deterministic, with
    finite estimates, and agrees with the plain sweep (``compare``).
    Returns ``(max_abs_err, bitwise, run)``; ``run(sweep)`` repeats the
    call, for timing."""
    from bayesssm_tpu_torch.ops import _build

    def run(sweep):
        return sweep(words, ys, theta, alive, max_particles=n)

    before = _build.launches[entry]
    ll_k, est_k = run(op)
    ll_k2, est_k2 = run(op)
    with plain_context or contextlib.nullcontext():
        ll_p, est_p = run(op.sweep_reference)
    torch.cuda.synchronize()
    if _build.launches[entry] != before + 2:
        raise AssertionError(f"{what}: {entry} launch count did not advance")
    if not (torch.equal(ll_k, ll_k2) and torch.equal(est_k, est_k2)):
        raise AssertionError(f"{what}: the kernel is not deterministic")
    if not bool(torch.isfinite(est_k).all()):
        raise AssertionError(f"{what}: state estimates are not finite")
    bitwise = torch.equal(ll_k, ll_p) and torch.equal(est_k, est_p)
    return compare(ll_k, ll_p, what), bitwise, run


def sweep_check(dev, what, algorithm="BPF", gaps=None, reps=10,
                n=PARTICLES, counts=None):
    """K1 with the SIR functor against the plain sweep at 4096 chains x
    ``n`` lanes x 10 days, every lane alive or ``counts [C]`` of them
    (``kernel_vs_plain``); kernel ms by CUDA-graph replay (and by CUDA
    events over host-issued launches), plain ms, and the bound from the
    events the plain sweep counted. The counts are a device tensor: a
    Python number would be copied to the card on every launch, and that
    copy waits for the launch before it."""
    from bayesssm_tpu_torch.ops.gillespie import EventTally

    _, op, y2 = sir_inputs(dev, algorithm, gaps)
    rng = np.random.default_rng(5)
    base = np.array([0.5, 0.2], np.float32)
    theta = torch.as_tensor(
        base * np.exp(0.1 * rng.normal(size=(CHAINS, 2))).astype(np.float32),
        device=dev,
    )
    alive = (torch.full((CHAINS,), float(n), device=dev) if counts is None
             else counts)
    tally = EventTally()
    err, bitwise, run = kernel_vs_plain(
        what, "bssm_sweep_sir", op, words_for(CHAINS, 1, dev), y2, theta,
        alive, n, plain_context=tally)
    kernel_ms = graph_ms(lambda: run(op), reps)
    events_ms = cuda_ms(lambda: run(op), reps)
    plain_ms = cuda_ms(lambda: run(op.sweep_reference), 1)
    t = y2.shape[0]
    stages = t * (1 if algorithm == "BPF" else 2)
    live = CHAINS * n if counts is None else float(counts.sum())
    bound_ms, bound_by = sweep_bound(CHAINS, n, live, t, stages, tally)
    say(what, shape=f"{CHAINS}x{n}x{t}", algorithm=algorithm,
        alive="all" if counts is None else
        f"{int(counts.min())}..{int(counts.max())}",
        gaps=gaps, bitwise_equal=bitwise, max_abs_err=err,
        kernel_ms=kernel_ms, kernel_ms_events=events_ms, plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by=bound_by, share_of_bound=bound_ms / kernel_ms,
        **tally.summary())
    return dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def phase_sir(dev):
    return sweep_check(dev, "sir")


def phase_sweep_branches(dev):
    """K1's APF stage, RMPF move and gap loop (phase 12)."""
    for what, algorithm, gaps in (("sir_apf", "APF", None),
                                  ("sir_rmpf", "RMPF", None),
                                  ("sir_gapped", "BPF", GAPS)):
        sweep_check(dev, what, algorithm, gaps)


def run_mh(dev, what, pf, steps, per_step, model="sir"):
    """One warm-up MH step, then ``steps`` timed steps with the launch
    counts set to 0 just before and read just after, from
    ``bench_torch.sampler(model)``'s state at 4096 chains; ``per_step``
    maps a kernel to the launches each step must make. Returns the counts,
    the warm state, priors and transforms."""
    from bayesssm_tpu_torch.ops import _build
    from bayesssm_tpu_torch.pmmh.driver import sample_chains

    state, prior_fns, transforms = bench_torch.sampler(model, CHAINS,
                                                       PARTICLES, dev)
    warm = sample_chains(pf, state, 2, 1, prior_fns, transforms)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = sample_chains(pf, warm.state, steps + 1, 0, prior_fns, transforms)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(_build.launches)
    acc = float(out.acceptance_rate.mean())
    say(what, steps=steps, seconds=seconds,
        samples_per_s=CHAINS * steps / seconds, acceptance=acc,
        launches={k: v for k, v in counts.items() if v})
    for name in counts:
        if counts[name] != per_step.get(name, 0) * steps:
            raise AssertionError(f"{what}: {name} launched {counts[name]} "
                                 f"times in {steps} steps")
    if not np.isfinite(out.samples).all() or not 0.0 < acc < 1.0:
        raise AssertionError(f"{what}: samples are not finite, or the "
                             "acceptance rate is degenerate")
    return counts, warm.state, prior_fns, transforms


def plain_rate(dev, what, pf, state, prior_fns, transforms, steps):
    from bayesssm_tpu_torch.pmmh.driver import sample_chains

    t0 = time.perf_counter()
    sample_chains(pf, state, steps + 1, 0, prior_fns, transforms)
    torch.cuda.synchronize()
    say(what, plain_samples_per_s=CHAINS * steps / (time.perf_counter() - t0),
        plain_steps=steps)


def phase_main_path(dev):
    _, op, y2 = sir_inputs(dev)
    pf = bench_torch.sir_pf(bench_torch.observations("bpf"), PARTICLES)
    counts, state, prior_fns, transforms = run_mh(
        dev, "main", pf, 64, {"bssm_sweep_sir": 1})

    def plain_pf(words, theta, n):
        return op.sweep_reference(words, y2, theta, n,
                                  max_particles=PARTICLES)

    plain_rate(dev, "main", plain_pf, state, prior_fns, transforms, 4)
    return counts, pf, state, prior_fns, transforms


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
                        timed = (kern, plain, float(alive.sum()))
        say("fused_resample", shape=f"{c}x{n}x{d}", calls=calls,
            bitwise_equal=True)
    if _build.launches["bssm_fused_resample"] != before + calls:
        raise AssertionError("bssm_fused_resample launch count is off")
    kernel_ms = graph_ms(timed[0], 20)
    plain_ms = graph_ms(timed[1], 5)
    bound_ms, bound_by = fused_resample_bound(CHAINS, PARTICLES, 2, timed[2])
    say("fused_resample", shape=f"{CHAINS}x{PARTICLES}x2",
        mode="inkernel stratified adaptive", kernel_ms=kernel_ms,
        plain_ms=plain_ms, kernel_ms_host_issued=cuda_ms(timed[0], 20),
        plain_ms_host_issued=cuda_ms(timed[1], 5), bound_ms=bound_ms,
        bound_by=bound_by, share_of_bound=bound_ms / kernel_ms)
    return dict(max_abs_err=0.0, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def fused_resample_bound(c: int, n: int, d: int, live=None):
    """K3: reads log-weights, particles, uniform weights, thresholds, seed
    words and counts; writes particles, weights, ESS and log-sum-exp; one
    weight-and-selection stage a live lane (``live`` of them, else all)."""
    bytes_moved = 4 * (c * n * (2 + d) + 4 * c) + 4 * (c * n * (1 + d) + 2 * c)
    return bound(bytes_moved, (c * n if live is None else live,
                               stage_instr(n)))


def k3_check(dev, what, n, alive, aux):
    """K3 on 4096 chains of ``n`` lanes, ``alive [C]`` of them live,
    against its plain version, bitwise, and timed. ``aux``: as the engine's
    APF aux resample runs it (S, I and the clamped aux log-weight as three
    columns, forced, threshold 0); else as its day step (S and I,
    adaptive at half the live count)."""
    from bayesssm_tpu_torch.ops.resampling_fused import (
        fused_weight_resample_reference,
        fused_weight_resample_seeded,
    )

    c = CHAINS
    gen = torch.Generator(device=dev).manual_seed(13)
    lane = torch.arange(n, dtype=torch.float32, device=dev)
    live = lane[None, :] < alive[:, None]
    lw = torch.where(live, 3.0 * torch.randn((c, n), device=dev,
                                             generator=gen), -1e30)
    parts = torch.randint(0, 200, (c, n, 2), device=dev,
                          generator=gen).to(torch.float32)
    if aux:
        parts = torch.cat([parts, lw[..., None]], dim=-1).contiguous()
    uni = torch.where(live, 1.0 / alive[:, None], 0.0)
    thr = torch.zeros(c, device=dev) if aux else alive / 2.0
    words = words_for(c, 31, dev)

    def kern():
        return fused_weight_resample_seeded(lw, parts, words, alive, uni,
                                            thr, "stratified", aux)

    def plain():
        return fused_weight_resample_reference(
            lw, parts, uni, thr, key_words=words, num_alive=alive,
            method="stratified", always_resample=aux)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{what}: K3 differs from its plain version")
    kernel_ms = graph_ms(kern, 20)
    plain_ms = graph_ms(plain, 5)
    d = parts.shape[2]
    bound_ms, bound_by = fused_resample_bound(c, n, d, float(alive.sum()))
    say(what, shape=f"{c}x{n}x{d}", always=aux,
        alive=f"{int(alive.min())}..{int(alive.max())}", bitwise_equal=True,
        max_abs_err=0.0, kernel_ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by,
        share_of_bound=bound_ms / kernel_ms)


def phase_fused_resample_aux(dev):
    """K3 as the engine's APF aux resample runs it (phase 13)."""
    gen = torch.Generator(device=dev).manual_seed(13)
    n = PARTICLES
    alive = torch.randint(n // 2, n + 1, (CHAINS,), device=dev,
                          generator=gen).to(torch.float32)
    alive[: CHAINS // 4] = float(n)
    k3_check(dev, "fused_resample_aux", n, alive, aux=True)


def gillespie_inputs(dev, n=PARTICLES):
    """Phase 8's K4 inputs on 4096 chains of ``n`` lanes: rates spread as
    in phase 5, S uniform on 250..430, I on 0..119 (a wide spread of
    events a lane), whole chains with I = 0 and three such lanes in every
    chain. Returns ``(words, state, lam, gam)``."""
    rng = np.random.default_rng(9)
    base = np.array([0.5, 0.2], np.float32)
    theta = base * np.exp(0.1 * rng.normal(size=(CHAINS, 2)))
    lam = torch.as_tensor(theta[:, 0].astype(np.float32), device=dev)
    gam = torch.as_tensor(theta[:, 1].astype(np.float32), device=dev)
    s = rng.integers(250, 431, size=(CHAINS, n))
    i = np.minimum(rng.integers(0, 120, size=(CHAINS, n)), 500 - s)
    i[::64] = 0                      # whole chains with I = 0
    i[:, :3] = 0                     # and some lanes of every chain
    state = torch.as_tensor(np.stack([s, i], -1).astype(np.float32),
                            device=dev)
    return words_for(CHAINS, 4, dev), state, lam, gam


def engine_day_states(dev):
    """The states the engine path hands K4: the particles of phase 10's
    SIR engine (4096 x 128, T = 10, rates spread as in phase 5) before each
    day's transition, from ``bootstrap_filter(..., return_particles=
    True)``. Returns ``(words [T, C, 2], states [T, C, N, 2], lam, gam)``,
    one key per day."""
    from bayesssm_tpu_torch.filters import bootstrap_filter
    from bayesssm_tpu_torch.models.sir import simulate_sir, sir_model

    _, y = simulate_sir(seed=1405)
    fns, _, _ = sir_model(500, 70, transition="gillespie_pallas")
    _, _, lam, gam = gillespie_inputs(dev)
    res = bootstrap_filter(words_for(CHAINS, 41, dev), y, PARTICLES, *fns,
                           theta=dict(lam=lam, gamma=gam),
                           return_particles=True)
    t = len(y)
    states = res.particles_history[:, :t].transpose(0, 1).contiguous()
    words = torch.stack([words_for(CHAINS, 100 + d, dev) for d in range(t)])
    return words, states, lam, gam


def phase_gillespie(dev, what="gillespie", n=PARTICLES):
    """K4 against its plain version, bitwise, on 4096 chains of ``n``
    lanes (the main path's shape by default), on phase 8's inputs."""
    from bayesssm_tpu_torch.ops import _build
    from bayesssm_tpu_torch.ops.gillespie import (
        EventTally,
        gillespie_step,
        gillespie_step_reference,
    )

    words, state, lam, gam = gillespie_inputs(dev, n)
    before = _build.launches["bssm_gillespie"]
    got = gillespie_step(words, state, lam, gam, 500)
    with EventTally() as tally:
        want = gillespie_step_reference(words, state, lam, gam, 500)
    torch.cuda.synchronize()
    if _build.launches["bssm_gillespie"] != before + 1:
        raise AssertionError("bssm_gillespie launch count is off")
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: K4 differs from its plain version")
    if bool((got.sum(-1) > state.sum(-1)).any()) or bool((got < 0).any()):
        raise AssertionError(f"{what}: K4 broke the population bounds")

    def kern():
        return gillespie_step(words, state, lam, gam, 500)

    kernel_ms = graph_ms(kern, 20)
    # The plain event loop asks the host whether any lane is still active
    # on every iteration, so it cannot be captured: its time includes the
    # host's, as it does on the engine path.
    plain_ms = cuda_ms(
        lambda: gillespie_step_reference(words, state, lam, gam, 500), 3)
    # Reads the state, seed words and rates; writes the state.
    bound_ms, bound_by = bound(4 * (4 * CHAINS * n + 4 * CHAINS),
                               (tally.fired, EVENT_INSTR))
    say(what, shape=f"{CHAINS}x{n}", bitwise_equal=True, max_abs_err=0.0,
        kernel_ms=kernel_ms, plain_ms=plain_ms,
        kernel_ms_host_issued=cuda_ms(kern, 20), bound_ms=bound_ms,
        bound_by=bound_by, share_of_bound=bound_ms / kernel_ms,
        **tally.summary())
    return dict(max_abs_err=0.0, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def phase_gillespie_engine_days(dev):
    """K4 on the states the engine path hands it (``engine_day_states``):
    each day bitwise against its plain version, and the ten launches timed
    together by CUDA-graph replay, with their bound from the events the
    plain version counted. Prints per-launch figures."""
    from bayesssm_tpu_torch.ops.gillespie import (
        EventTally,
        gillespie_step,
        gillespie_step_reference,
    )

    words, states, lam, gam = engine_day_states(dev)
    days = states.shape[0]
    with EventTally() as tally:
        for d in range(days):
            want = gillespie_step_reference(words[d], states[d], lam, gam,
                                            500)
            got = gillespie_step(words[d], states[d], lam, gam, 500)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"K4 differs on the engine's day {d}")

    def kern():
        for d in range(days):
            gillespie_step(words[d], states[d], lam, gam, 500)

    kernel_ms = graph_ms(kern, 10) / days
    bound_ms, bound_by = bound(
        days * 4 * (4 * CHAINS * PARTICLES + 4 * CHAINS),
        (tally.fired, EVENT_INSTR))
    say("gillespie_engine_days", shape=f"{days}x{CHAINS}x{PARTICLES}",
        bitwise_equal=True, kernel_ms_per_launch=kernel_ms,
        bound_ms_per_launch=bound_ms / days, bound_by=bound_by,
        share_of_bound=bound_ms / days / kernel_ms, **tally.summary())


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


def engine_pf(dev, plain=False, algorithm="BPF"):
    """The engine's batched filter: ``bench_torch.sir_pf`` on SIR with the
    per-day kernels for ``algorithm``, or the bootstrap filter on their
    plain versions (portable weight step, plain day-step) when
    ``plain``."""
    from bayesssm_tpu_torch.models.sir import sir_model
    from bayesssm_tpu_torch.ops.gillespie import gillespie_step_reference

    y = bench_torch.observations("bpf")
    if not plain:
        return bench_torch.sir_pf(y, PARTICLES, algorithm, "gillespie_pallas")
    from bayesssm_tpu_torch.filters import bootstrap_filter

    (init_fn, _, ll_fn), log_priors, _ = sir_model(
        500, 70, transition="gillespie_pallas")
    names = list(log_priors)

    ys = torch.as_tensor(y, dtype=torch.float32, device=dev)

    def plain_trans(key, particles, lam, gamma):
        return gillespie_step_reference(key, particles, lam, gamma, 500)

    def plain_pf(words, theta, n):
        res = bootstrap_filter(
            words, ys, n, init_fn, plain_trans, ll_fn,
            theta={q: theta[:, j] for j, q in enumerate(names)},
            return_particles=False, max_particles=PARTICLES,
            use_fused=False)
        return res.loglike, res.state_est

    return plain_pf


def phase_engine_path(dev):
    pf = engine_pf(dev)
    counts, state, prior_fns, transforms = run_mh(
        dev, "engine", pf, 32,
        {"bssm_fused_resample": 10, "bssm_gillespie": 10})
    plain_rate(dev, "engine", engine_pf(dev, plain=True), state, prior_fns,
               transforms, 2)
    return counts, pf, state, prior_fns, transforms


def phase_filters_mh(dev):
    """MH samples/s of the APF and the RMPF on both paths (phase 14), the
    port of ``bench.py --config apf|rmpf`` with either ``--transition``:
    the engine's APF launches K4 and K3 twice a day, its RMPF once."""
    counts = []
    for algorithm, per_day in (("APF", 2), ("RMPF", 1)):
        counts.append(run_mh(dev, f"sweep_{algorithm.lower()}",
                             bench_torch.sir_pf(
                                 bench_torch.observations("bpf"), PARTICLES,
                                 algorithm), 64,
                             {"bssm_sweep_sir": 1})[0])
        counts.append(run_mh(
            dev, f"engine_{algorithm.lower()}",
            engine_pf(dev, algorithm=algorithm), 32,
            {"bssm_fused_resample": 10 * per_day,
             "bssm_gillespie": 10 * per_day})[0])
    return counts


def phase_lane_bound(dev):
    """Phase 16: the kernels at the 1024-lane bound that phase 15's APF
    ``pmmh()`` runs reach, on 4096 chains with per-chain counts spread over
    50..1000 as its tuning leaves them: K1's APF against the plain sweep,
    K3 as the engine's APF day step and aux resample, and K4, each against
    its plain version on the same inputs."""
    n = 1024
    counts = spread_counts(dev)
    sweep_check(dev, "lane_bound_sir_apf", "APF", reps=3, n=n, counts=counts)
    k3_check(dev, "lane_bound_fused_resample", n, counts, aux=False)
    k3_check(dev, "lane_bound_fused_resample_aux", n, counts, aux=True)
    phase_gillespie(dev, "lane_bound_gillespie", n)


def run_pmmh(what, y, fns, log_priors, init, transform, control, m,
             burn_in, cut, pf_wrapper="bootstrap_filter", pf_impl=None,
             **extra):
    """The public ``pmmh()`` with pilot tuning at 4096 chains, the launch
    counts set to 0 just before and read just after: prints the timings,
    tuned counts, lane bound, acceptance, launches, and each parameter's
    mean, ESS and R-hat; fails on samples that are not finite, an
    acceptance outside (0, 1) or a count outside [50, 1000]. Returns the
    counts and the output."""
    import warnings

    from bayesssm_tpu_torch import pmmh
    from bayesssm_tpu_torch.ops import _build
    from bayesssm_tpu_torch.pmmh.driver import _particle_lane_bound

    chains = CHAINS
    _build.reset_launches()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # ESS/R-hat advice on short runs
        out = pmmh(pf_wrapper, y, m, *fns, log_priors, init, burn_in,
                   num_chains=chains, param_transform=transform, seed=1405,
                   tune_control=control, pf_impl=pf_impl,
                   print_summary=False, **extra)
    counts = dict(_build.launches)
    t = out.timings
    tn = out.target_n
    acc = float(out.acceptance_rate.mean())
    say("pmmh", path=what, chains=chains, m=m, burn_in=burn_in,
        pilot_m=control.pilot_m, pilot_reps=control.pilot_reps,
        cut=cut,
        tuning_s=t["tuning"], compile_s=t["compile"],
        sampling_s=t["sampling"],
        samples_per_s=chains * (m - 1) / t["sampling"],
        target_n_min=int(tn.min()), target_n_median=float(np.median(tn)),
        target_n_max=int(tn.max()),
        lane_bound=_particle_lane_bound(int(tn.max())), acceptance=acc,
        launches={k: v for k, v in counts.items() if v})
    for q in out.param_names:
        # A chain whose pilot never moved in its second half gets a zero
        # proposal (zero pilot covariance, as in the JAX driver) and never
        # moves: its zero variance makes ESS and R-hat NaN.
        frozen = np.ptp(out.theta_chain[q], axis=1) == 0
        say("pmmh", path=what, param=q, ess=out.diagnostics["ess"][q],
            rhat=out.diagnostics["rhat"][q],
            mean=float(out.theta_chain[q].mean()),
            frozen_chains=int(frozen.sum()),
            frozen_values=out.theta_chain[q][frozen, 0][:4].tolist(),
            frozen_acceptance=out.acceptance_rate[frozen][:4].tolist())
    samples = np.stack(list(out.theta_chain.values()))
    if samples.shape != (len(log_priors), chains, m - burn_in):
        raise AssertionError(f"pmmh ({what}) samples have shape "
                             f"{samples.shape}")
    if not np.isfinite(samples).all() or not 0.0 < acc < 1.0:
        raise AssertionError(f"pmmh ({what}): samples not finite, or the "
                             "acceptance rate is degenerate")
    if tn.min() < 50 or tn.max() > 1000:
        raise AssertionError(f"pmmh ({what}): target_n outside [50, 1000]")
    return counts, out


def expect_launches(what, counts, launched, not_launched=()):
    """Fail unless every kernel of ``launched`` ran and none of
    ``not_launched`` did (``not_launched="others"``: no other kernel)."""
    if not_launched == "others":
        not_launched = [k for k in counts if k not in launched]
    bad = ([k for k in launched if counts[k] == 0]
           + [k for k in not_launched if counts[k] != 0])
    if bad:
        raise AssertionError(f"{what}: launches {counts} (off: {bad})")


def sir_pmmh_args(path):
    """``(y, model fns, log_priors, transform, keyword arguments)`` of the
    SIR ``pmmh()`` runs of phases 11, 15, 26 and 27 on ``path``:
    ``"sweep"`` (``pf_impl=sir_sweep_pf_impl(500, 70)``) or ``"engine"``
    (the default filter on ``sir_model(transition="gillespie_pallas")``)."""
    from bayesssm_tpu_torch.models.sir import (
        simulate_sir,
        sir_aux_log_likelihood_fn,
        sir_model,
        sir_move_fn,
        sir_sweep_pf_impl,
    )

    _, y = simulate_sir(seed=1405)
    fns, log_priors, transform = sir_model(500, 70,
                                           transition="gillespie_pallas")
    return y, fns, log_priors, transform, dict(
        pf_impl=sir_sweep_pf_impl(500, 70) if path == "sweep" else None,
        aux_log_likelihood_fn=sir_aux_log_likelihood_fn,
        move_fn=sir_move_fn(500))


def phase_pmmh(path, control, pf_wrapper="bootstrap_filter", m=PMMH_M,
               burn_in=PMMH_BURN_IN):
    """The public ``pmmh()`` with pilot tuning at full width on one path:
    ``"sweep"`` (K1) or ``"engine"`` (K4 and K3), for one of the three
    filters (``sir_pmmh_args``). Returns the kernel launch counts of the
    call and its output."""
    y, fns, log_priors, transform, kw = sir_pmmh_args(path)
    pf_impl = kw["pf_impl"]
    counts, out = run_pmmh(
        f"{path}-{pf_wrapper}", y, fns, log_priors,
        {"lam": 0.5, "gamma": 0.2}, transform, control, m, burn_in,
        "pilot_m 2000->200 and pilot_reps 100->20 (bench.py's)"
        + ("" if m == PMMH_M else f"; m {PMMH_M}->{m}, burn_in "
           f"{PMMH_BURN_IN}->{burn_in}"),
        pf_wrapper=pf_wrapper, **kw)
    k34 = ("bssm_fused_resample", "bssm_gillespie")
    if pf_impl is not None:
        expect_launches(f"pmmh {path}", counts, ["bssm_sweep_sir"], k34)
    else:
        expect_launches(f"pmmh {path}", counts, k34, ["bssm_sweep_sir"])
    return counts, out


def functor_check(dev, what, entry, op, ys, theta, n, counts=None, reps=10,
                  transitions=None, trans_instr=(0, 0, 0),
                  weight_instr=GAUSS_WEIGHT_INSTR, init_instr=NORMAL_INSTR):
    """K1 with an event-free functor (``entry``) against the plain sweep of
    ``op`` on ``theta [C, P]`` and ``ys [T, d_y]`` on the card, every lane
    alive or ``counts [C]`` of them: agreement, a second launch bitwise
    equal (``kernel_vs_plain``), kernel ms (CUDA events over ``reps``
    host-issued launches, and CUDA-graph replay, which the ``kernels`` line
    takes: a launch takes the host about 0.2 ms to issue, near these
    kernels' own time), plain ms and the bound: the init normal, the
    transitions (``transitions`` a lane, ``trans_instr`` each) and a
    Gaussian weight (``weight_instr``) and a weight-and-selection stage a
    day."""
    c, p = theta.shape
    t, d_y = ys.shape[0], (1 if ys.ndim == 1 else ys.shape[1])
    # The counts as a device tensor: a graph capture copies nothing from
    # the host.
    alive = (torch.full((c,), float(n), device=dev) if counts is None
             else counts)
    err, bitwise, run = kernel_vs_plain(what, entry, op, words_for(c, 23, dev),
                                        ys, theta, alive, n)
    events_ms = cuda_ms(lambda: run(op), reps)
    kernel_ms = graph_ms(lambda: run(op), reps)
    plain_ms = cuda_ms(lambda: run(op.sweep_reference), 1)
    live = float(alive.sum())
    bytes_moved = 4 * (4 * c + t * d_y + p * c) + 4 * (c + c * (t + 1))
    bound_ms, bound_by = bound(
        bytes_moved, (live, init_instr),
        (live * (t if transitions is None else transitions), trans_instr),
        (live * t, instr(weight_instr, stage_instr(n))))
    say(what, shape=f"{c}x{n}x{t}", alive="all" if counts is None else
        f"{int(counts.min())}..{int(counts.max())}", bitwise_equal=bitwise,
        max_abs_err=err, kernel_ms=kernel_ms, kernel_ms_events=events_ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        share_of_bound=bound_ms / kernel_ms)
    return dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def spread_counts(dev, seed=16):
    """4096 per-chain particle counts spread over 50..1000, shuffled."""
    return torch.as_tensor(np.random.default_rng(seed).permutation(
        np.linspace(50, 1000, CHAINS).round()).astype(np.float32),
        device=dev)


def phase_sinusoidal_kernel(dev):
    """Phase 17: K1c at the bench width and at the README's lane bound."""
    from bayesssm_tpu_torch.models.sinusoidal import (
        _sinusoidal_op,
        simulate_sinusoidal,
    )

    _, y = simulate_sinusoidal(1405, 20)
    ys = torch.as_tensor(y, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(17)
    theta = torch.as_tensor(
        (np.array(SIN_THETA0) * np.exp(0.1 * rng.normal(size=(CHAINS, 3))))
        .astype(np.float32), device=dev)
    op = _sinusoidal_op()
    trans = instr(NORMAL_INSTR, SINF_INSTR, 4)
    row = functor_check(dev, "sinusoidal", "bssm_sweep_sinusoidal", op, ys,
                        theta, PARTICLES, trans_instr=trans)
    functor_check(dev, "sinusoidal_readme_bound", "bssm_sweep_sinusoidal",
                  op, ys, theta, 1024, counts=spread_counts(dev), reps=3,
                  trans_instr=trans)
    return row


def phase_lgss_mv(dev):
    """Phase 18: K1b-mv against its plain sweep, then the public
    ``lgss_mv_bpf_sweep`` as a user calls it, counted, with the Kalman
    check."""
    from bayesssm_tpu_torch.models.lgss import simulate_lgss_mv
    from bayesssm_tpu_torch.ops import _build
    from bayesssm_tpu_torch.ops.lgss_sweep import (
        _lgss_mv_op,
        lgss_mv_bpf_sweep,
    )
    from bayesssm_tpu_torch.utils.kalman import kalman_loglik_mv

    a, sx, sy, c, n, t = 0.9, 0.6, (0.4, 0.5), 512, 1024, 20
    _, y = simulate_lgss_mv(11, t_val=t, a=a, sigma_x=sx, sigma_y=0.4)
    ys = torch.as_tensor(y, dtype=torch.float32, device=dev)
    theta = torch.tensor([[a, sx, *sy]], device=dev).expand(c, 4).contiguous()
    gaps = GAPS * 2
    rows = {}
    for name, g in (("lgss_mv", None), ("lgss_mv_gapped", gaps)):
        op = _lgss_mv_op(1.0, 0.5, 1.0, "stratified", True, False, g)
        rows[name] = functor_check(
            dev, name, "bssm_sweep_lgss_mv", op, ys, theta, n,
            transitions=None if g is None else sum(g),
            trans_instr=instr(NORMAL_INSTR, 3),
            weight_instr=instr(GAUSS_WEIGHT_INSTR, GAUSS_WEIGHT_INSTR))
    words = words_for(c, 18, dev)
    _build.reset_launches()
    ll, _ = lgss_mv_bpf_sweep(words, ys, n, a, sx, sy,
                              resample_algorithm="SISR")
    ll_g, _ = lgss_mv_bpf_sweep(words, ys, n, a, sx, sy,
                                obs_times=np.cumsum(gaps),
                                resample_algorithm="SISR")
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    expect_launches("lgss_mv path", counts, ["bssm_sweep_lgss_mv"], "others")
    lls = ll.double().cpu().numpy()
    truth = kalman_loglik_mv(y, a, (1.0, 0.5), sx, sy, p0=1.0)
    se = lls.std() / np.sqrt(c)
    say("lgss_mv", path_launches=counts["bssm_sweep_lgss_mv"],
        kernel_mean=lls.mean(), kalman=truth, se=se,
        gapped_finite=bool(torch.isfinite(ll_g).all()))
    if not np.isfinite(lls).all() or abs(lls.mean() - truth) >= max(
            5 * se, 0.1) or not bool(torch.isfinite(ll_g).all()):
        raise AssertionError("LGSS-mv kernel mean is off the Kalman value")
    return rows["lgss_mv"], counts


def phase_sinusoidal_mh(dev):
    """Phase 19: ``bench.py --config sinusoidal`` on both paths."""
    y = bench_torch.observations("sinusoidal")
    counts = []
    for path, steps, per_step in (
            ("sweep", 64, {"bssm_sweep_sinusoidal": 1}),
            ("engine", 32, {"bssm_fused_resample": len(y)})):
        pf = bench_torch.sinusoidal_pf(y, PARTICLES, path)
        run = run_mh(dev, f"sinusoidal_{path}", pf, steps, per_step,
                     model="sinusoidal")
        counts.append(run[0])
        if "--profile" in sys.argv[1:]:
            profile_steps(f"sinusoidal-{path}", pf, *run[1:])
    return counts


def phase_readme_pmmh(control):
    """Phase 20: the README's ``pmmh()`` call at 4096 chains on both
    paths."""
    from bayesssm_tpu_torch.models.sinusoidal import (
        simulate_sinusoidal,
        sinusoidal_model,
        sinusoidal_sweep_pf_impl,
    )

    _, y = simulate_sinusoidal(1405, 20)
    fns, log_priors, transform = sinusoidal_model()
    init = [{"phi": 0.4, "sigma_x": 0.4, "sigma_y": 0.4},
            {"phi": 0.8, "sigma_x": 0.8, "sigma_y": 0.8}] * (CHAINS // 2)
    counts = []
    for path in ("sweep", "engine"):
        sweep = path == "sweep"
        run_counts, _ = run_pmmh(
            f"readme-{path}", y, fns, log_priors, init, transform, control,
            FILTER_PMMH_M, FILTER_PMMH_BURN_IN,
            "the README's call (tests/test_parity.py:59-91) with 2 chains "
            f"->{CHAINS}, m 500->{FILTER_PMMH_M}, burn_in 50->"
            f"{FILTER_PMMH_BURN_IN}, pilot_reps 50->20",
            pf_impl=sinusoidal_sweep_pf_impl() if sweep else None)
        expect_launches(f"readme {path}", run_counts,
                        ["bssm_sweep_sinusoidal" if sweep
                         else "bssm_fused_resample"], "others")
        counts.append(run_counts)
    return counts


def phase_sv_tauleap(dev, control):
    """Phase 21: ``pmmh()`` on stochastic volatility, and MH steps of
    tau-leaping SIR, through the engine."""
    from bayesssm_tpu_torch.models.stochastic_volatility import (
        simulate_sv,
        sv_model,
    )

    _, y = simulate_sv(1405)
    fns, log_priors, transform = sv_model()
    sv_counts, out = run_pmmh(
        "sv-engine", y, fns, log_priors,
        {"phi": 0.95, "sigma": 0.3, "mu": -1.0}, transform, control, 64, 16,
        "T = 50 (simulate_sv's default), m = 64, burn_in = 16")
    expect_launches("pmmh sv", sv_counts, ["bssm_fused_resample"], "others")
    sv_out = out
    phi = out.theta_chain["phi"]
    if not ((phi > 0) & (phi < 1)).all():
        raise AssertionError("pmmh sv: phi left (0, 1), so logit phi is "
                             "not finite")
    y_sir = bench_torch.observations("bpf")
    pf = bench_torch.sir_pf(y_sir, PARTICLES, "BPF", "tauleap")
    tau_counts = run_mh(dev, "tauleap_engine", pf, 8,
                        {"bssm_fused_resample": len(y_sir)})[0]
    return [sv_counts, tau_counts], sv_out


def load_example(name="torch_custom_sweep_kernel"):
    """``examples/<name>.py`` as a module: by default the user's SV
    callbacks and their ``pf_impl``."""
    import importlib.util

    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sv_move(rng, cols, th, y_t):
    """The RMPF move of ``tests/test_sweep_builder.py:43-48``, in torch."""
    lw = load_example().sv_log_weight
    x = cols[0]
    prop = x + 0.3 * rng.normal()
    log_ratio = lw((prop,), th, y_t) - lw((x,), th, y_t)
    accept = torch.log(rng.uniform()) < log_ratio
    return (torch.where(accept, prop, x),)


def generated_bound_args(op, n, t):
    """``functor_check``'s instruction arguments for a traced op: its
    IR's init, transitions (two a day for the APF) and, a day, the
    log-weight, the aux weight twice and the aux stage (APF) and the move
    (RMPF); ``functor_check`` adds the day's weight-and-selection
    stage."""
    fns = op.trace().fns
    weight = [ir_instr(fns["log_weight"])]
    transitions = None if op.gaps is None else sum(op.gaps)
    if "aux_log_weight" in fns:
        weight += [ir_instr(fns["aux_log_weight"])] * 2 + [stage_instr(n)]
        transitions = 2 * t
    if "move" in fns:
        weight.append(ir_instr(fns["move"]))
    return dict(transitions=transitions,
                trans_instr=ir_instr(fns["transition"]),
                weight_instr=instr(*weight), init_instr=ir_instr(fns["init"]))


def phase_generated(dev, control, engine_sv):
    """Phase 22: K1g, the functor generated from a user's callbacks."""
    from bayesssm_tpu_torch.models.sinusoidal import (
        _sinusoidal_op,
        _sweep_init,
        _sweep_log_weight,
        _sweep_transition,
        simulate_sinusoidal,
    )
    from bayesssm_tpu_torch.models.stochastic_volatility import (
        simulate_sv,
        sv_model,
    )
    from bayesssm_tpu_torch.ops import _build
    from bayesssm_tpu_torch.ops.sweep_builder import build_sweep_op
    from bayesssm_tpu_torch.ops.sweep_codegen import op_zoo, probe

    ex = load_example()
    entry = "bssm_sweep_generated"
    _, y = simulate_sv(1405)
    ys = torch.as_tensor(y, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(22)
    theta = np.array([0.95, 0.3, -1.0]) * np.exp(
        0.05 * rng.normal(size=(CHAINS, 3)))
    theta[:, 0] = np.minimum(theta[:, 0], 0.99)   # phi inside (0, 1)
    theta = torch.as_tensor(theta.astype(np.float32), device=dev)
    sv = (1, ex.sv_init, ex.sv_transition, ex.sv_log_weight, 3)
    gaps = (1, 2) * 20 + (1,) * 10          # 50 observations, 70 steps
    ops = {"generated_bpf": build_sweep_op(*sv),
           "generated_apf": build_sweep_op(
               *sv, aux_log_weight_fn=ex.sv_log_weight),
           "generated_rmpf": build_sweep_op(*sv, move_fn=sv_move,
                                            always_resample=True),
           "generated_gapped": build_sweep_op(*sv, obs_gaps=gaps)}
    t0 = time.perf_counter()
    for op in ops.values():
        _build.build_generated(op.generated_kernel().source)
    say("generated", build_s=time.perf_counter() - t0,
        libraries=len({op.generated_kernel().entry for op in ops.values()}))
    for tag, info in _build.build_info.get("generated", {}).items():
        for ln in info["ptxas"].splitlines():
            if re.search(r"registers|spill", ln):
                print(f"[generated] {tag} {ln.strip()}")
    rows = {what: functor_check(dev, what, entry, op, ys, theta, PARTICLES,
                                **generated_bound_args(op, PARTICLES, len(y)))
            for what, op in ops.items()}
    bpf = ops["generated_bpf"]
    functor_check(dev, "generated_bpf_lane_bound", entry, bpf, ys, theta,
                  1024, counts=spread_counts(dev), reps=3,
                  **generated_bound_args(bpf, 1024, len(y)))

    # (b) the generator against a functor known to be right: K1c.
    _, y_sin = simulate_sinusoidal(1405, 20)
    ys_sin = torch.as_tensor(y_sin, dtype=torch.float32, device=dev)
    th_sin = torch.as_tensor(
        (np.array(SIN_THETA0) * np.exp(0.1 * np.random.default_rng(17)
                                       .normal(size=(CHAINS, 3))))
        .astype(np.float32), device=dev)
    traced = build_sweep_op(1, _sweep_init, _sweep_transition,
                            _sweep_log_weight, 3)
    words = words_for(CHAINS, 23, dev)
    got = traced(words, ys_sin, th_sin, PARTICLES)
    want = _sinusoidal_op()(words, ys_sin, th_sin, PARTICLES)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    say("generated_sinusoidal_vs_k1c", shape=f"{CHAINS}x{PARTICLES}x20",
        bitwise_equal=same,
        max_abs_err=float((got[0] - want[0]).abs().max()))
    if not same:
        raise AssertionError("the generated sinusoidal functor differs "
                             "from K1c")

    # (e) every op the tracer maps, against PyTorch's own CUDA ops.
    gen = torch.Generator(device=dev).manual_seed(22)
    x = torch.randn((1 << 16, 2), device=dev, generator=gen) * torch.exp(
        3.0 * torch.randn((1 << 16, 2), device=dev, generator=gen))
    x[:8] = torch.tensor([[0.0, -0.0], [-0.0, 0.0], [1.0, 1.0],
                          [math.inf, 2.0], [-math.inf, -1.0],
                          [math.nan, 0.5], [0.5, math.nan], [1e-40, -3.0]],
                         device=dev)
    got = probe(op_zoo, x)
    want = torch.stack([o.to(torch.float32) for o in op_zoo(x.unbind(1))],
                       dim=1)
    torch.cuda.synchronize()
    same = (got.view(torch.int32) == want.view(torch.int32)) | (
        got.isnan() & want.isnan())
    bad = [j for j in range(got.shape[1]) if not bool(same[:, j].all())]
    say("generated_ops", ops=got.shape[1], rows=x.shape[0],
        bitwise_equal=not bad, differing_outputs=bad)
    if bad:
        raise AssertionError(f"op_zoo outputs {bad} differ on the card")

    # (d) the example's pmmh() on the sweep path, at phase 21's setting.
    fns, log_priors, transform = sv_model()
    counts, out = run_pmmh(
        "sv-sweep", y, fns, log_priors,
        {"phi": 0.95, "sigma": 0.3, "mu": -1.0}, transform, control, 64, 16,
        "T = 50 (simulate_sv's default), m = 64, burn_in = 16",
        pf_impl=ex.sv_pf_impl())
    expect_launches("pmmh sv sweep", counts, [entry], "others")
    t = out.timings
    say("generated_pmmh", sweep_samples_per_s=CHAINS * 63 / t["sampling"],
        sweep_tuning_s=t["tuning"],
        engine_samples_per_s=CHAINS * 63 / engine_sv.timings["sampling"],
        engine_tuning_s=engine_sv.timings["tuning"])
    return rows["generated_bpf"], counts

def device_ops(fn):
    """``(result, count)``: ``fn()`` and the number of operators it
    dispatched on CUDA tensors, views excluded (each one is a kernel
    launch or a copy the host issues)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view and any(
                    isinstance(t, torch.Tensor) and t.is_cuda
                    for t in tree_leaves((args, kwargs, out))):
                Count.n += 1
            return out

    with Count():
        result = fn()
    return result, Count.n


def phase_metropolis_indices(dev):
    """Phase 23 (a): ``metropolis_resample_indices`` at 4096 x 128, the
    default 256 steps, ``num_alive`` spread over 50..128, against the same
    function on the CPU for a seeded sample of chains, bit for bit."""
    from bayesssm_tpu_torch.ops.resampling import metropolis_resample_indices

    rng = np.random.default_rng(23)
    alive = rng.integers(50, PARTICLES + 1, size=CHAINS).astype(np.float32)
    w = rng.gamma(0.5, size=(CHAINS, PARTICLES)).astype(np.float32)
    w[np.arange(PARTICLES)[None, :] >= alive[:, None]] = 0.0
    w /= w.sum(axis=1, keepdims=True)
    words = words_for(CHAINS, 23, dev)
    w_d = torch.as_tensor(w, device=dev)
    a_d = torch.as_tensor(alive, device=dev)
    idx, ops = device_ops(
        lambda: metropolis_resample_indices(words, w_d, num_alive=a_d))
    rows = np.sort(rng.choice(CHAINS, size=METROPOLIS_CHECK_ROWS,
                              replace=False))
    sel = torch.as_tensor(rows)
    want = metropolis_resample_indices(
        words.cpu()[sel], torch.as_tensor(w[rows]),
        num_alive=torch.as_tensor(alive[rows]))
    got = idx.cpu()[sel]
    mismatched = int((got != want).any(dim=1).sum())
    inside = bool((idx < a_d[:, None].long()).all())
    ms = cuda_ms(lambda: metropolis_resample_indices(words, w_d,
                                                     num_alive=a_d), 3)
    say("metropolis_indices", chains=CHAINS, lanes=PARTICLES, steps=256,
        checked_chains=len(rows), mismatched_chains=mismatched,
        ms_per_call=ms, device_ops_per_call=ops, indices_alive=inside)
    if mismatched or not inside:
        raise AssertionError("Metropolis indices on the card differ from "
                             "the CPU's, or select a masked lane")


def phase_metropolis_engine_lgss(dev):
    """Phase 23 (b): the engine's LGSS BPF at 4096 x 128, SISR, with
    Metropolis resampling (no K3) against the stratified engine (K3 every
    day) at the same shape."""
    from bayesssm_tpu_torch.filters import bootstrap_filter
    from bayesssm_tpu_torch.models.lgss import lgss_model, simulate_lgss
    from bayesssm_tpu_torch.ops import _build

    a, sx, sy, t = 0.9, 0.6, 0.4, 20
    _, y = simulate_lgss(11, t_val=t, a=a, sigma_x=sx, sigma_y=sy)
    (init_fn, trans_fn, ll_fn), _, _ = lgss_model()
    stats = {}
    for method in ("stratified", "metropolis"):
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = bootstrap_filter(
            words_for(CHAINS, 24, dev), y, PARTICLES, init_fn, trans_fn,
            ll_fn, theta=dict(a=a, sigma_x=sx, sigma_y=sy),
            resample_algorithm="SISR", resample_fn=method,
            return_particles=False)
        lls = res.loglike.double().cpu().numpy()
        seconds = time.perf_counter() - t0
        k3 = _build.launches["bssm_fused_resample"]
        stats[method] = (lls.mean(), lls.std() / np.sqrt(CHAINS))
        say("metropolis_engine_lgss", method=method, chains=CHAINS,
            lanes=PARTICLES, days=t, mean=lls.mean(), se=stats[method][1],
            seconds=seconds, k3_launches=k3,
            finite=bool(np.isfinite(lls).all()))
        if not np.isfinite(lls).all() or k3 != (
                t if method == "stratified" else 0):
            raise AssertionError(f"the {method} LGSS engine: loglike not "
                                 f"finite, or K3 launched {k3} times")
    diff = stats["metropolis"][0] - stats["stratified"][0]
    se = math.hypot(stats["metropolis"][1], stats["stratified"][1])
    say("metropolis_engine_lgss", diff=diff, se=se,
        limit=max(5 * se, 0.3))
    if abs(diff) >= max(5 * se, 0.3):
        raise AssertionError("the Metropolis engine's mean loglike is off "
                             "the stratified engine's")


def phase_metropolis_pmmh(dev, control, engine_out):
    """Phase 23 (c): ``pmmh()`` with ``resample_fn="metropolis"`` on the
    SIR engine path: the pilot keeps stratified resampling and K3, phase 2
    runs K4 and Metropolis and no K3. The phase-2 filter is counted by a
    ``pf_impl`` around the default one. Returns the run's launch
    counts."""
    from bayesssm_tpu_torch.models.sir import simulate_sir, sir_model
    from bayesssm_tpu_torch.ops import _build
    from bayesssm_tpu_torch.pmmh.driver import sample_chains
    from bayesssm_tpu_torch.pmmh.tuning import _make_pf_loglike

    phase2 = {name: 0 for name in _build.launches}
    filters = []

    def counting_factory(*args, **kw):
        pf = _make_pf_loglike(*args, **kw)
        if args[7] != "metropolis":
            return pf

        def counted(*a):
            before = dict(_build.launches)
            out = pf(*a)
            for name, v in _build.launches.items():
                phase2[name] += v - before[name]
            return out

        filters.append(pf)
        return counted

    _, y = simulate_sir(seed=1405)
    fns, log_priors, transform = sir_model(500, 70,
                                           transition="gillespie_pallas")
    counts, out = run_pmmh(
        "engine-metropolis", y, fns, log_priors, {"lam": 0.5, "gamma": 0.2},
        transform, control, METROPOLIS_PMMH_M, METROPOLIS_PMMH_BURN_IN,
        f"pilot_m 2000->200 and pilot_reps 100->20 (bench.py's); m "
        f"{PMMH_M}->{METROPOLIS_PMMH_M}, burn_in {PMMH_BURN_IN}->"
        f"{METROPOLIS_PMMH_BURN_IN}",
        pf_impl=counting_factory, resample_fn="metropolis")
    expect_launches("pmmh metropolis (all)", counts,
                    ["bssm_fused_resample", "bssm_gillespie"],
                    ["bssm_sweep_sir"])
    expect_launches("pmmh metropolis (phase 2)", phase2, ["bssm_gillespie"],
                    "others")
    # Device ops of one MH step of phase 2, and of phase 11's engine step.
    state, prior_fns, transforms = bench_torch.sampler("sir", CHAINS,
                                                       PARTICLES, dev)
    steps = {}
    for what, pf in (("metropolis", filters[0]), ("stratified", engine_pf(
            dev))):
        warm = sample_chains(pf, state, 2, 1, prior_fns, transforms)
        _, steps[what] = device_ops(lambda: sample_chains(
            pf, warm.state, 2, 1, prior_fns, transforms))
    t = out.timings
    rate = CHAINS * (METROPOLIS_PMMH_M - 1) / t["sampling"]
    engine_rate = CHAINS * (PMMH_M - 1) / engine_out.timings["sampling"]
    say("metropolis_pmmh", tuning_s=t["tuning"], samples_per_s=rate,
        acceptance=float(out.acceptance_rate.mean()),
        phase2_launches={k: v for k, v in phase2.items() if v},
        device_ops_per_mh_step=steps["metropolis"],
        stratified_device_ops_per_mh_step=steps["stratified"],
        phase11_engine_samples_per_s=engine_rate)
    return counts


def phase_checkpoint(control):
    """Phase 24: ``pmmh()`` checkpoint/resume at 4096 chains on the SIR
    sweep path (K1) and on the engine (K3, K4): A uninterrupted, B with
    ``checkpoint_every``, C to half of m with a checkpoint, then resumed
    to m; B and C equal A bit for bit."""
    import tempfile
    import warnings

    from bayesssm_tpu_torch import default_tune_control, pmmh
    from bayesssm_tpu_torch.models.sir import (
        simulate_sir,
        sir_model,
        sir_sweep_pf_impl,
    )
    from bayesssm_tpu_torch.ops import _build
    from bayesssm_tpu_torch.utils.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    _, y = simulate_sir(seed=1405)
    fns, log_priors, transform = sir_model(500, 70,
                                           transition="gillespie_pallas")
    all_counts = []
    for path, m, burn_in, every, pilot in CHECKPOINT_RUNS:
        tune = control if pilot is None else default_tune_control(**pilot)
        # Launches of one MH step: K1 once, or K3 and K4 once a day.
        per_step = ({"bssm_sweep_sir": 1} if path == "sweep" else
                    {"bssm_fused_resample": len(y), "bssm_gillespie": len(y)})
        kernels = list(per_step)

        def run(m_run, **kw):
            _build.reset_launches()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                out = pmmh("bootstrap_filter", y, m_run, *fns, log_priors,
                           {"lam": 0.5, "gamma": 0.2}, burn_in,
                           num_chains=CHAINS, param_transform=transform,
                           seed=1405, tune_control=tune,
                           pf_impl=(sir_sweep_pf_impl(500, 70)
                                    if path == "sweep" else None),
                           print_summary=False, **kw)
            counts = dict(_build.launches)
            all_counts.append(counts)
            expect_launches(f"checkpoint {path}", counts, kernels, "others")
            return out, counts

        with tempfile.TemporaryDirectory() as tmp:
            ck_b = pathlib.Path(tmp) / "b.npz"
            ck_c = pathlib.Path(tmp) / "c.npz"
            a, _ = run(m)
            b, _ = run(m, checkpoint_every=every, checkpoint_path=ck_b)
            run(m // 2, checkpoint_path=ck_c)
            c, c_counts = run(m, checkpoint_path=ck_c, resume=True,
                              checkpoint_every=every)
            same = all(
                np.array_equal(a.theta_chain[q], x.theta_chain[q])
                for x in (b, c) for q in a.theta_chain)
            snap = load_checkpoint(ck_b)
            leftovers = sorted(p.name for p in pathlib.Path(tmp).iterdir()
                               if ".tmp" in p.name)
            t0 = time.perf_counter()
            for _ in range(3):
                save_checkpoint(
                    pathlib.Path(tmp) / "timed.npz", keys=snap["keys"],
                    theta=snap["theta"], loglike=snap["loglike"],
                    samples=snap["samples"], step=snap["step"],
                    meta=snap["meta"])
            write_s = (time.perf_counter() - t0) / 3
            size = ck_b.stat().st_size
        # The resumed run tunes nothing: its launches are those of its
        # m - m // 2 MH steps.
        resumed_ok = "tuning" not in c.timings and all(
            c_counts[k] == per_step.get(k, 0) * (m - m // 2)
            for k in c_counts)
        say("checkpoint", path=path, chains=CHAINS, m=m, every=every,
            pilot=pilot or "phase 11's",
            b_and_c_equal_a=same, snapshot_step=snap["step"],
            snapshot_samples=tuple(snap["samples"].shape),
            tmp_files_left=leftovers, resume_ok=resumed_ok,
            resume_launches={k: v for k, v in c_counts.items() if v},
            write_s=write_s, file_bytes=size,
            a_sampling_s=a.timings["sampling"],
            b_sampling_s=b.timings["sampling"])
        if not (same and snap["step"] == m
                and snap["samples"].shape == (CHAINS, m, 2)
                and not leftovers and resumed_ok):
            raise AssertionError(f"checkpoint/resume on the {path} path")
    return all_counts


def phase_host_resampling():
    """Phase 25: the port's host resampler, built with this machine's
    ``g++``, against the NumPy definition of the three schemes at 4096
    rows of 128 weights."""
    from bayesssm_tpu_torch.ops import host_resampling as host

    built = not host.library_path().exists()
    t0 = time.perf_counter()
    if not host.native_available():
        raise AssertionError("the host resampler did not build")
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(25)
    w = rng.gamma(0.5, size=(CHAINS, PARTICLES))
    w[rng.random(w.shape) < 0.1] = 0.0
    n = PARTICLES
    bad = 0
    t0 = time.perf_counter()
    for row, seed in enumerate(rng.integers(2**31, size=CHAINS)):
        cdf = np.cumsum(w[row])
        cdf = cdf / cdf[-1]
        cdf[-1] = 1.0
        for method in ("multinomial", "stratified", "systematic"):
            fn = getattr(host, f"host_resample_{method}")
            got = fn(w[row], np.random.default_rng(seed))
            draw = np.random.default_rng(seed)
            pos = {"multinomial": lambda: draw.uniform(size=n),
                   "stratified": lambda: (np.arange(n) + draw.uniform(
                       size=n)) / n,
                   "systematic": lambda: (np.arange(n) + draw.uniform())
                   / n}[method]()
            want = np.minimum(np.searchsorted(cdf, pos, side="left"), n - 1)
            bad += int(not np.array_equal(got, want))
    say("host_resampling", built=built, build_s=build_s, rows=CHAINS,
        lanes=n, mismatched_rows=bad,
        seconds_for_3_schemes=time.perf_counter() - t0)
    if bad:
        raise AssertionError("the host resampler differs from its NumPy "
                             "definition")


def sir_pmmh(path, control, pf_wrapper, m, burn_in, **kw):
    """``pmmh()`` on SIR at 4096 chains exactly as phases 11 and 15 call
    it (``run_pmmh``), with extra keyword arguments such as ``mesh``."""
    import warnings

    from bayesssm_tpu_torch import pmmh

    y, fns, log_priors, transform, args = sir_pmmh_args(path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # ESS/R-hat advice on short runs
        return pmmh(pf_wrapper, y, m, *fns, log_priors,
                    {"lam": 0.5, "gamma": 0.2}, burn_in, num_chains=CHAINS,
                    param_transform=transform, seed=1405,
                    tune_control=control, print_summary=False, **args, **kw)


def pmmh_digest(out) -> dict:
    """What phases 26 and 27 compare of a ``PMMHOutput``, as host arrays."""
    return {"theta": {q: np.asarray(v) for q, v in out.theta_chain.items()},
            "target_n": np.asarray(out.target_n),
            "acceptance": np.asarray(out.acceptance_rate),
            "timings": dict(out.timings)}


def same_digest(a, b) -> bool:
    """Whether two digests hold the same samples, counts and acceptance,
    bit for bit."""
    return (all(np.array_equal(a["theta"][q], b["theta"][q])
                for q in b["theta"])
            and np.array_equal(a["target_n"], b["target_n"])
            and np.array_equal(a["acceptance"], b["acceptance"]))


def same_run(digest, out) -> bool:
    """Whether a digest holds ``out``'s samples, counts and acceptance."""
    return same_digest(digest, pmmh_digest(out))


def _rank_entry(rank, world, backend, store, job, kwargs, results):
    """One child rank: joins the ``backend`` group on card 0, loads the
    kernel library the parent built, runs ``job(**kwargs)`` and sends back
    its result."""
    import datetime
    import traceback

    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        from bayesssm_tpu_torch.ops import _build

        _build.load_library()
        dist.init_process_group(
            backend, init_method=store, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        results.put((rank, "ok", job(**kwargs)))
    except BaseException:  # report any failure of the rank, then exit
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(what, world, backend, job, **kwargs):
    """``job(**kwargs)`` on ``world`` spawned ranks of one ``backend``
    group on card 0 (``file://`` rendezvous); returns each rank's result.
    A rank that raises, dies or outlives ``RANK_TIMEOUT_S`` fails the
    phase, and every rank is stopped."""
    import multiprocessing as mp
    import queue
    import tempfile

    torch.cuda.synchronize()
    torch.cuda.empty_cache()   # leave the children the card's memory
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got, error = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_entry,
                             args=(rank, world, backend,
                                   f"file://{tmp}/store", job, kwargs,
                                   results))
                 for rank in range(world)]
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + RANK_TIMEOUT_S
        try:
            while len(got) < world and error is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    error = f"outlived {RANK_TIMEOUT_S} s"
                    break
                try:
                    rank, status, payload = results.get(
                        timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, proc in enumerate(procs)
                            if proc.exitcode not in (None, 0)
                            and r not in got]
                    if dead:
                        error = (f"rank {dead[0]} exited with code "
                                 f"{procs[dead[0]].exitcode}")
                    continue
                if status == "error":
                    error = f"rank {rank} failed:\n{payload}"
                else:
                    got[rank] = payload
        finally:
            for proc in procs:
                if error is not None:
                    proc.kill()
                proc.join(timeout=30)
                if proc.is_alive():
                    proc.kill()
                    proc.join()
    if error is not None:
        raise AssertionError(f"{what}: {error}")
    return [got[r] for r in range(world)]


def job_one_rank_nccl(control):
    """Phase 26's rank: the RMPF ``pmmh()`` of phase 15 on a one-rank NCCL
    mesh, on the sweep path and on the engine."""
    import torch.distributed as dist

    from bayesssm_tpu_torch.ops import _build
    from bayesssm_tpu_torch.parallel import global_chain_mesh

    mesh = global_chain_mesh()
    out = {"backend": dist.get_backend(mesh.get_group("chains")),
           "mesh": tuple(mesh.shape)}
    for path in ("sweep", "engine"):
        _build.reset_launches()
        run = sir_pmmh(path, control, "resample_move_filter", FILTER_PMMH_M,
                       FILTER_PMMH_BURN_IN, mesh=mesh)
        out[path] = (pmmh_digest(run), dict(_build.launches))
    return out


def phase_nccl_one_rank(control, rmpf):
    """Phase 26: a child process joins a one-rank NCCL group, builds
    ``global_chain_mesh()`` and runs phase 15's RMPF ``pmmh()`` with
    ``mesh=`` on both paths; each output and its launches equal phase
    15's. Returns the launch counts."""
    t0 = time.perf_counter()
    (res,) = run_ranks("phase 26", 1, "nccl", job_one_rank_nccl,
                       control=control)
    counts = []
    for path in ("sweep", "engine"):
        digest, launched = res[path]
        want_out, want_counts = rmpf[path]
        same = same_run(digest, want_out)
        say("nccl_one_rank", path=f"{path}-resample_move_filter",
            chains=CHAINS, m=FILTER_PMMH_M, backend=res["backend"],
            mesh=res["mesh"], bitwise_equal_phase_15=same,
            launches={k: v for k, v in launched.items() if v},
            launches_equal_phase_15=launched == want_counts,
            tuning_s=digest["timings"]["tuning"],
            sampling_s=digest["timings"]["sampling"])
        if res["backend"] != "nccl" or not same or launched != want_counts:
            raise AssertionError(f"phase 26 ({path}): the one-rank NCCL "
                                 "mesh run differs from phase 15's")
        counts.append(launched)
    say("phase_26", seconds=time.perf_counter() - t0)
    return counts


@contextlib.contextmanager
def collective_clock():
    """Seconds and calls of the ``torch.distributed`` collectives that the
    port's mesh code issues inside the block, each timed from a device
    sync before it to one after it."""
    import torch.distributed as dist

    clock = {"s": 0.0, "calls": 0}
    saved = dist.all_gather, dist.all_reduce

    def timed(fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                clock["s"] += time.perf_counter() - t0
                clock["calls"] += 1
        return call

    dist.all_gather, dist.all_reduce = timed(saved[0]), timed(saved[1])
    try:
        yield clock
    finally:
        dist.all_gather, dist.all_reduce = saved


def sharded_sir_inputs():
    """Phase 27 (b)'s SIR observations, engine functions and theta (the
    simulation's lam = 0.5, gamma = 0.2 on every chain)."""
    from bayesssm_tpu_torch.models.sir import simulate_sir, sir_model

    _, y = simulate_sir(seed=1405)
    fns = sir_model(500, 70, transition="gillespie_pallas")[0]
    theta = {"lam": np.full(CHAINS, 0.5, np.float32),
             "gamma": np.full(CHAINS, 0.2, np.float32)}
    return y, fns, theta


def lgss_inputs():
    """Phase 9's LGSS shape and data: (y, theta, chains, particles)."""
    from bayesssm_tpu_torch.models.lgss import simulate_lgss

    a, sx, sy, c, n = 0.9, 0.6, 0.4, 512, 1024
    _, y = simulate_lgss(11, t_val=20, a=a, sigma_x=sx, sigma_y=sy)
    theta = {"a": np.full(c, a, np.float32),
             "sigma_x": np.full(c, sx, np.float32),
             "sigma_y": np.full(c, sy, np.float32)}
    return y, theta, c, n


def job_two_ranks_gloo(control):
    """Phase 27's rank, two ranks over gloo on card 0: (a) phase 15's
    sweep-path RMPF ``pmmh()`` on a 2 x 1 chains mesh; on a 1 x 2 particle
    mesh (b) the SIR RMPF ``sharded_particle_filter`` on the engine, (c)
    the LGSS ``sharded_bootstrap_filter`` and (d) the SIR BPF ``pmmh()``
    on the engine with its collectives timed."""
    from bayesssm_tpu_torch import default_tune_control
    from bayesssm_tpu_torch.models.lgss import lgss_model
    from bayesssm_tpu_torch.models.sir import sir_move_fn
    from bayesssm_tpu_torch.ops import _build, threefry
    from bayesssm_tpu_torch.parallel import (
        make_chain_mesh,
        sharded_bootstrap_filter,
        sharded_particle_filter,
    )

    out = {}
    _build.reset_launches()
    run = sir_pmmh("sweep", control, "resample_move_filter", FILTER_PMMH_M,
                   FILTER_PMMH_BURN_IN, mesh=make_chain_mesh(2))
    out["a"] = (pmmh_digest(run), dict(_build.launches))

    mesh = make_chain_mesh(2, particle_axis_size=2)
    y, fns, theta = sharded_sir_inputs()
    _build.reset_launches()
    t0 = time.perf_counter()
    ll, _ = sharded_particle_filter(
        threefry.key(SHARDED_SEED), y, SHARDED_PARTICLES, *fns, theta,
        num_chains=CHAINS, mesh=mesh, algorithm="RMPF",
        move_fn=sir_move_fn(500))
    ll = ll.cpu().numpy()
    out["b"] = (ll, dict(_build.launches), time.perf_counter() - t0)

    y, theta, c, n = lgss_inputs()
    ll, _ = sharded_bootstrap_filter(
        threefry.key(SHARDED_SEED), y, n, *lgss_model()[0], theta,
        num_chains=c, mesh=mesh, resample_algorithm="SISR")
    out["c"] = ll.cpu().numpy()

    with collective_clock() as clock:
        _build.reset_launches()
        run = sir_pmmh("engine", default_tune_control(**SHARDED_PILOT),
                       "bootstrap_filter", SHARDED_PMMH_M,
                       SHARDED_PMMH_BURN_IN, mesh=mesh)
    out["d"] = (pmmh_digest(run), dict(_build.launches), dict(clock))
    return out


def phase_gloo_two_ranks(dev, control, rmpf):
    """Phase 27: two ranks on card 0 over gloo (``job_two_ranks_gloo``).
    (a) equals phase 15's sweep RMPF bit for bit on both ranks; (b) K4
    once a day on each rank and no K3, finite log-likelihoods whose mean
    is within max(5 SE, 0.1) of the unsharded engine's at 256 particles;
    (c) within max(5 SE, 0.1) of the Kalman value; (d) finite samples,
    acceptance strictly inside (0, 1), target_n in [50, 1000]. The two
    ranks of the particle mesh return the same bits. Returns the launch
    counts of both ranks."""
    from bayesssm_tpu_torch.filters import resample_move_filter
    from bayesssm_tpu_torch.models.sir import sir_move_fn
    from bayesssm_tpu_torch.ops import threefry
    from bayesssm_tpu_torch.utils.kalman import kalman_loglik

    t0 = time.perf_counter()
    res = run_ranks("phase 27", 2, "gloo", job_two_ranks_gloo,
                    control=control)
    counts = []
    k34 = ("bssm_fused_resample", "bssm_gillespie")

    for rank, r in enumerate(res):                          # (a)
        digest, launched = r["a"]
        same = same_run(digest, rmpf["sweep"][0])
        say("gloo_two_ranks", part="a", rank=rank, mesh="2x1",
            path="sweep-resample_move_filter", chains=CHAINS,
            chains_on_rank=CHAINS // 2, bitwise_equal_phase_15=same,
            launches={k: v for k, v in launched.items() if v},
            tuning_s=digest["timings"]["tuning"],
            sampling_s=digest["timings"]["sampling"])
        expect_launches("phase 27 (a)", launched, ["bssm_sweep_sir"], k34)
        if not same:
            raise AssertionError("phase 27 (a): the chains mesh differs "
                                 "from phase 15's run")
        counts.append(launched)

    y, fns, theta = sharded_sir_inputs()                    # (b)
    keys = threefry.fold_in(threefry.key(SHARDED_SEED).to(dev),
                            torch.arange(CHAINS, device=dev))
    plain = resample_move_filter(
        keys, y, SHARDED_PARTICLES, *fns, sir_move_fn(500),
        theta={k: torch.as_tensor(v, device=dev) for k, v in theta.items()},
        return_particles=False).loglike.double().cpu().numpy()
    lls = [r["b"][0] for r in res]
    ll = lls[0].astype(np.float64)
    se = math.sqrt(ll.var() / ll.size + plain.var() / plain.size)
    for rank, r in enumerate(res):
        _, launched, secs = r["b"]
        say("gloo_two_ranks", part="b", rank=rank, mesh="1x2",
            filter="RMPF sharded_particle_filter", chains=CHAINS,
            particles=SHARDED_PARTICLES,
            lanes_on_rank=SHARDED_PARTICLES // 2, days=len(y),
            launches={k: v for k, v in launched.items() if v}, seconds=secs)
        if (launched["bssm_gillespie"] != len(y)
                or launched["bssm_fused_resample"] != 0):
            raise AssertionError("phase 27 (b): K4 must launch once a day "
                                 "on each rank and K3 never")
        counts.append(launched)
    say("gloo_two_ranks", part="b", sharded_mean=ll.mean(),
        unsharded_mean=plain.mean(), se=se,
        ranks_bitwise_equal=bool(np.array_equal(lls[0], lls[1])),
        finite=bool(np.isfinite(ll).all()))
    if (not np.isfinite(ll).all() or not np.array_equal(lls[0], lls[1])
            or abs(ll.mean() - plain.mean()) >= max(5 * se, 0.1)):
        raise AssertionError("phase 27 (b): the particle-sharded RMPF is "
                             "off the unsharded engine")

    y, theta, c, n = lgss_inputs()                          # (c)
    truth = kalman_loglik(y, 0.9, 1.0, 0.6, 0.4, p0=1.0)
    ll = res[0]["c"].astype(np.float64)
    se = ll.std() / math.sqrt(c)
    say("gloo_two_ranks", part="c", mesh="1x2",
        filter="LGSS sharded_bootstrap_filter SISR", chains=c,
        particles=n, mean=ll.mean(), kalman=truth, se=se,
        ranks_bitwise_equal=bool(np.array_equal(res[0]["c"], res[1]["c"])))
    if (not np.isfinite(ll).all()
            or not np.array_equal(res[0]["c"], res[1]["c"])
            or abs(ll.mean() - truth) >= max(5 * se, 0.1)):
        raise AssertionError("phase 27 (c): the sharded LGSS filter is off "
                             "the Kalman value")

    for rank, r in enumerate(res):                          # (d)
        digest, launched, clock = r["d"]
        samples = np.stack(list(digest["theta"].values()))
        acc = float(digest["acceptance"].mean())
        tn = digest["target_n"]
        days = launched["bssm_gillespie"]
        say("gloo_two_ranks", part="d", rank=rank, mesh="1x2",
            path="engine-bootstrap_filter pmmh", chains=CHAINS,
            m=SHARDED_PMMH_M, burn_in=SHARDED_PMMH_BURN_IN,
            cut=f"m {PMMH_M}->{SHARDED_PMMH_M}; pilot_m 200->"
            f"{SHARDED_PILOT['pilot_m']}, pilot_reps 20->"
            f"{SHARDED_PILOT['pilot_reps']}",
            tuning_s=digest["timings"]["tuning"],
            sampling_s=digest["timings"]["sampling"],
            collective_s=clock["s"], collective_calls=clock["calls"],
            filter_days=days, collective_s_per_day=clock["s"] / days,
            acceptance=acc, target_n_min=int(tn.min()),
            target_n_max=int(tn.max()),
            means={q: float(v.mean()) for q, v in digest["theta"].items()},
            launches={k: v for k, v in launched.items() if v})
        if (not np.isfinite(samples).all() or not 0.0 < acc < 1.0
                or tn.min() < 50 or tn.max() > 1000
                or launched["bssm_fused_resample"] != 0 or days == 0):
            raise AssertionError("phase 27 (d): the particle-sharded pmmh()")
        counts.append(launched)
    if not same_digest(res[0]["d"][0], res[1]["d"][0]):
        raise AssertionError("phase 27 (d): the two ranks' outputs differ")
    say("phase_27", seconds=time.perf_counter() - t0)
    return counts

# Phase 28: bench_torch.py's runs, as (arguments, launches a filter call):
# bench.py's default at full width on both SIR routes, then --quick for the
# other configurations and for tau-leaping. --config pmmh runs pmmh() four
# times; its launches are only checked to route through K1 alone.
BENCH_RUNS = (
    ([], {"bssm_sweep_sir": 1}),
    (["--transition", "gillespie_pallas"],
     {"bssm_gillespie": 10, "bssm_fused_resample": 10}),
    (["--quick", "--config", "apf"], {"bssm_sweep_sir": 1}),
    (["--quick", "--config", "rmpf"], {"bssm_sweep_sir": 1}),
    (["--quick", "--config", "sinusoidal"], {"bssm_sweep_sinusoidal": 1}),
    (["--quick", "--config", "pmmh"], None),
    (["--quick", "--transition", "tauleap"], {"bssm_fused_resample": 10}),
)
# Phase 29: (example, arguments of its main(), its pilot's
# default_tune_control arguments or None for the example's own, the
# kernels it must launch). The README call (3.8-7.6 s) and the SIR
# vignette (15.9-26.3 s) run their own settings. The SV example is
# host-bound on the engine at T = 100, 0.2-0.5 s an MH or pilot step at 2
# chains: at its own m 500 and pilot_m 500 it took 319.9 s
# (scripts/torch_bench_examples.py), at 200 and 200 here 189.1 s (H100
# 80GB HBM3, 700 W). It is cut to m 500 -> 50, burn_in 100 -> 10,
# pilot_m 500 -> 50 and pilot_burn_in 100 -> 10.
EXAMPLE_RUNS = (
    ("torch_sinusoidal_readme", dict(fused=True), None,
     ["bssm_sweep_sinusoidal"]),
    ("torch_stochastic_sir", {}, None,
     ["bssm_gillespie", "bssm_fused_resample"]),
    ("torch_stochastic_volatility", dict(m=50, burn_in=10),
     dict(pilot_m=50, pilot_burn_in=10, pilot_reps=20),
     ["bssm_fused_resample"]),
)


def phase_bench_entry(smi):
    """Phase 28: ``bench_torch.main(argv)`` in-process for each of
    ``BENCH_RUNS``, the launch counts set to 0 just before and read just
    after. Each record has the four keys with a finite positive value and
    ``vs_baseline``; each filter call of the timed loop (the warm-up call's
    initial evaluation and steps, then reps x calls x steps) launches what
    its route implies and nothing else. Returns the counts."""
    from bayesssm_tpu_torch.ops import _build

    counts = []
    for argv, per_call in BENCH_RUNS:
        args = bench_torch.parse_args(argv)
        _build.reset_launches()
        t0 = time.perf_counter()
        rec = bench_torch.main(argv)
        seconds = time.perf_counter() - t0
        run = dict(_build.launches)
        counts.append(run)
        say("bench_entry", argv=" ".join(argv) or "(defaults)",
            record=json.dumps(rec), seconds=f"{seconds:.2f}",
            launches={k: v for k, v in run.items() if v}, card=repr(smi))
        if (list(rec) != ["metric", "value", "unit", "vs_baseline"]
                or not rec["metric"].startswith("cuda_pmmh_samples_per_sec_")
                or not all(np.isfinite(rec[k]) and rec[k] > 0
                           for k in ("value", "vs_baseline"))):
            raise AssertionError(f"bench_torch {argv}: record {rec}")
        if per_call is None:
            expect_launches(f"bench_torch {argv}", run, ["bssm_sweep_sir"],
                            "others")
            continue
        filter_calls = 1 + args.steps * (1 + args.reps * args.calls)
        for name in run:
            if run[name] != per_call.get(name, 0) * filter_calls:
                raise AssertionError(
                    f"bench_torch {argv}: {name} launched {run[name]} "
                    f"times in {filter_calls} filter calls")
    return counts


def phase_examples(smi):
    """Phase 29: the three examples' ``main(device="cuda")``, the launch
    counts set to 0 just before each and read just after: the README call
    with ``--fused`` (K1c) held to ``tests/test_parity.py``'s 3-SE bands
    (``parity``) and target_n to [50, 1000]; the SIR vignette (K4 and K3)
    and stochastic volatility (K3): finite samples and an acceptance rate
    strictly inside (0, 1). Returns the counts."""
    import warnings

    from bayesssm_tpu_torch import default_tune_control
    from bayesssm_tpu_torch.ops import _build

    counts = []
    for name, kw, pilot, kernels in EXAMPLE_RUNS:
        ex = load_example(name)
        if pilot is not None:
            kw = dict(kw, tune_control=default_tune_control(**pilot))
        _build.reset_launches()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # ESS/R-hat advice, 2 chains
            out = ex.main(device="cuda", **kw)
        seconds = time.perf_counter() - t0
        run = dict(_build.launches)
        counts.append(run)
        expect_launches(name, run, kernels, "others")
        summ = out.summary()
        samples = np.stack(list(out.theta_chain.values()))
        acc = out.acceptance_rate
        say("example", name=name,
            **{k: v for k, v in kw.items() if k != "tune_control"},
            pilot=pilot,
            kept_samples=samples.shape[2], seconds=f"{seconds:.2f}",
            tuning_s=out.timings["tuning"],
            sampling_s=out.timings["sampling"],
            target_n=out.target_n.tolist(), acceptance=acc.tolist(),
            launches={k: v for k, v in run.items() if v}, card=repr(smi))
        for q, row in summ.items():
            say("example", name=name, param=q, mean=row["mean"],
                sd=row["sd"], ess=row["ESS"], rhat=row["Rhat"])
        if not np.isfinite(samples).all() or not 0.0 < acc.mean() < 1.0:
            raise AssertionError(f"{name}: samples not finite, or the "
                                 "acceptance rate is degenerate")
        if hasattr(ex, "parity"):
            if out.target_n.min() < 50 or out.target_n.max() > 1000:
                raise AssertionError(f"{name}: target_n outside [50, 1000]")
            for q, (mean, sd, ess, diff, band) in ex.parity(out).items():
                say("readme_parity", param=q, mean=mean, sd=sd, ess=ess,
                    anchor=ex.README_ANCHOR[q][0], diff=diff, band=band,
                    inside=bool(diff < band))
                if not diff < band:
                    raise AssertionError(
                        f"{name}: {q} mean {mean} is {diff} from the "
                        f"README's {ex.README_ANCHOR[q][0]}, outside the "
                        f"3-SE band {band}")
    return counts


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
    for name, occ in _build.occupancy().items():
        say("build", kernel=name, **occ)

    main_counts = []   # the launch counts of every path run
    select_row = phase_select(dev)
    phase_lgss(dev)
    sweep_row = phase_sir(dev)
    run_counts, main_pf, sweep_state, prior_fns, transforms = (
        phase_main_path(dev))
    main_counts.append(run_counts)
    k3_row = phase_fused_resample(dev)
    k4_row = phase_gillespie(dev)
    phase_gillespie_engine_days(dev)
    phase_engine_lgss(dev)
    run_counts, eng_pf, eng_state, prior_fns, transforms = (
        phase_engine_path(dev))
    main_counts.append(run_counts)
    if "--profile" in sys.argv[1:]:
        profile_steps("sweep", main_pf, sweep_state, prior_fns, transforms)
        profile_steps("engine", eng_pf, eng_state, prior_fns, transforms)

    from bayesssm_tpu_torch import default_tune_control

    control = default_tune_control(pilot_m=200, pilot_burn_in=50,
                                   pilot_reps=20)
    pmmh_outs = {}
    for path in ("sweep", "engine"):
        run_counts, pmmh_outs[path] = phase_pmmh(path, control)
        main_counts.append(run_counts)
        if "--profile" in sys.argv[1:]:
            profile_steps(f"pmmh-{path}",
                          *pmmh_phase2(dev, path, pmmh_outs[path]))

    phase_sweep_branches(dev)
    phase_fused_resample_aux(dev)
    main_counts += phase_filters_mh(dev)
    rmpf = {}   # phase 15's RMPF runs, which phases 26 and 27 repeat
    for wrapper in ("auxiliary_filter", "resample_move_filter"):
        for path in ("sweep", "engine"):
            run_counts, out = phase_pmmh(path, control, wrapper,
                                         FILTER_PMMH_M, FILTER_PMMH_BURN_IN)
            main_counts.append(run_counts)
            if wrapper == "resample_move_filter":
                rmpf[path] = (out, run_counts)
    phase_lane_bound(dev)
    sin_row = phase_sinusoidal_kernel(dev)
    mv_row, run_counts = phase_lgss_mv(dev)
    main_counts.append(run_counts)
    main_counts += phase_sinusoidal_mh(dev)
    main_counts += phase_readme_pmmh(control)
    run_counts, sv_out = phase_sv_tauleap(dev, control)
    main_counts += run_counts
    gen_row, run_counts = phase_generated(dev, control, sv_out)
    main_counts.append(run_counts)
    t_new = time.perf_counter()
    phase_metropolis_indices(dev)
    phase_metropolis_engine_lgss(dev)
    main_counts.append(
        phase_metropolis_pmmh(dev, control, pmmh_outs["engine"]))
    main_counts += phase_checkpoint(control)
    phase_host_resampling()
    say("phases_23_25", seconds=time.perf_counter() - t_new)
    # The children's launches count with the main path's.
    main_counts += phase_nccl_one_rank(control, rmpf)
    main_counts += phase_gloo_two_ranks(dev, control, rmpf)
    t_new = time.perf_counter()
    main_counts += phase_bench_entry(smi)
    main_counts += phase_examples(smi)
    say("phases_28_29", seconds=time.perf_counter() - t_new)
    total = {name: sum(c[name] for c in main_counts)
             for name in _build.launches}

    # select_index has no launch of its own on either path: it runs inside
    # every sweep and every fused-resample launch counted here.
    sweeps = ("bssm_sweep_sir", "bssm_sweep_sinusoidal",
              "bssm_sweep_lgss_mv", "bssm_sweep_generated")
    select_launches = (sum(total[k] for k in sweeps)
                       + total["bssm_fused_resample"])
    say("select", main_path_launches_of_its_kernels=select_launches)
    rows = (("bssm_sweep_sir", SWEEP_SOURCE, SWEEP_REPLACES,
             total["bssm_sweep_sir"], sweep_row),
            ("bssm_sweep_sinusoidal", SWEEP_SOURCE, SIN_REPLACES,
             total["bssm_sweep_sinusoidal"], sin_row),
            ("bssm_sweep_lgss_mv", SWEEP_SOURCE, LGSS_MV_REPLACES,
             total["bssm_sweep_lgss_mv"], mv_row),
            ("bssm_sweep_generated", SWEEP_SOURCE, GEN_REPLACES,
             total["bssm_sweep_generated"], gen_row),
            ("bssm_select", SELECT_SOURCE, SELECT_REPLACES, select_launches,
             select_row),
            ("bssm_fused_resample", RESAMPLE_SOURCE, RESAMPLE_REPLACES,
             total["bssm_fused_resample"], k3_row),
            ("bssm_gillespie", GILLESPIE_SOURCE, GILLESPIE_REPLACES,
             total["bssm_gillespie"], k4_row))
    print(json.dumps({"kernels": [
        {"name": name, "route": ROUTE, "source": source, "replaces": replaces,
         "launches": launches, **row}
        for name, source, replaces, launches, row in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
