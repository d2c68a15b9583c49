#!/usr/bin/env python3
"""Time the port's kernels in two checkouts on one NVIDIA GPU, in turns.

``python3 scripts/torch_kernel_ab.py OTHER_ROOT`` runs, in the order
other, this, this, other, one process per turn with its working directory
at that checkout's root. Each process builds that checkout's kernels,
runs its own ``chip_smoke.py`` phase that holds and times K2 alone
(``bssm_select``, phase 3), times K1 with the SIR functor by CUDA-graph
replay (BPF, APF, RMPF and gapped at phase 5's shape, and APF at phase
16's 1024-lane bound), then runs its phases that hold and time K3 (phase
7, and with the aux column, phase 13), times the engine's weight step of
one day on the engine's own day inputs (``engine_day_*`` lines: K3's one
launch where it takes the day's arguments, else the ops around K3), K4
(phase 8), the 1024-lane bound
(phase 16: K1 APF, K3 and K3 with the aux column, K4) and K1c (phase 17),
and last the MH samples/s of the engine path (phases 10 and 14, and 19's
sinusoidal model) beside the sweep path's (14, 19). Every timing first
calls its function for 1 s, so that both checkouts are timed at the
card's working clock. Each output line is
prefixed with ``[ab <root name> <turn>]``; a turn's ``[build]`` lines give
its registers per kernel. Fails without a CUDA device or when a turn
fails.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent

TURN = """
import re, sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from bayesssm_tpu_torch.ops import _build
dev = torch.device("cuda", 0)


def warmed_ms(fn, reps, warm_s=1.0):
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


cs.cuda_ms = warmed_ms   # every timing of both checkouts warms up alike
_build.load_library()
for ln in _build.build_info["ptxas"].splitlines():
    if re.search(r"registers|spill|Compiling entry", ln):
        print("[build]", ln.strip())
if hasattr(_build, "occupancy"):
    for name, occ in _build.occupancy().items():
        cs.say("build", kernel=name, **occ)


cs.phase_select(dev)


# K1 SIR timed by CUDA-graph replay with the counts on the card, as both
# checkouts' APIs take them.
def k1_sir(what, algorithm="BPF", gaps=None, n=cs.PARTICLES, counts=None):
    import numpy as np

    _, op, y2 = cs.sir_inputs(dev, algorithm, gaps)
    rng = np.random.default_rng(5)
    theta = torch.as_tensor((np.array([0.5, 0.2], np.float32) * np.exp(
        0.1 * rng.normal(size=(cs.CHAINS, 2)))).astype(np.float32),
        device=dev)
    alive = (torch.full((cs.CHAINS,), float(n), device=dev)
             if counts is None else counts)
    words = cs.words_for(cs.CHAINS, 1, dev)
    ms = cs.graph_ms(lambda: op(words, y2, theta, alive, max_particles=n),
                     3 if n > 128 else 10)
    cs.say(what, shape=f"{cs.CHAINS}x{n}x{y2.shape[0]}", kernel_ms=ms)


k1_sir("k1_sir")
for what, algorithm, gaps in (("k1_sir_apf", "APF", None),
                              ("k1_sir_rmpf", "RMPF", None),
                              ("k1_sir_gapped", "BPF", cs.GAPS)):
    k1_sir(what, algorithm, gaps)
k1_sir("k1_sir_apf_1024", "APF", n=1024, counts=cs.spread_counts(dev))
cs.phase_fused_resample(dev)
cs.phase_fused_resample_aux(dev)


# The engine's weight step of one day on the engine's own day inputs (a
# day's particles and raw log-weights from the model's callbacks, 4096
# chains): where K3 takes the day's arguments, its one launch; else the
# ops around K3 (mask, degenerate check, clamp, the key words' int32 form,
# log-likelihood, ESS record, zeroed weights, estimate).
def engine_day():
    import inspect
    import math
    from bayesssm_tpu_torch.models.sinusoidal import sinusoidal_model
    from bayesssm_tpu_torch.models.sir import sir_model
    from bayesssm_tpu_torch.ops import resampling_fused as rf
    from bayesssm_tpu_torch.ops import threefry

    whole = "loglike" in inspect.signature(
        rf.fused_weight_resample_seeded).parameters
    c = cs.CHAINS
    k0, k1, k2 = threefry.split(cs.words_for(c, 23, dev), (3,)).unbind(1)
    for what, n, alive_n, (init, trans, weight), th, y in (
            ("engine_day_sinusoidal", 1024, 1000, sinusoidal_model()[0],
             dict(phi=0.8, sigma_x=1.0, sigma_y=0.5), 0.3),
            ("engine_day_sir", 128, 128,
             sir_model(500, 70, transition="gillespie_pallas")[0],
             dict(lam=0.5, gamma=0.2), 12.0)):
        th = {k: torch.full((c,), v, device=dev) for k, v in th.items()}
        names = inspect.signature(init).parameters
        p0 = init(key=k0, num_particles=n,
                  **{k: v for k, v in th.items() if k in names})
        names = inspect.signature(trans).parameters
        parts = trans(key=k1, particles=p0,
                      **{k: v for k, v in th.items() if k in names},
                      **({"t": 1} if "t" in names else {}))
        names = inspect.signature(weight).parameters
        lw = weight(y=torch.tensor(y, device=dev), particles=parts,
                    **{k: v for k, v in th.items() if k in names},
                    **({"t": 1} if "t" in names else {}))
        p3 = parts if parts.ndim == 3 else parts[..., None]
        n_f = torch.full((c,), float(alive_n), device=dev)
        lane = torch.arange(n, dtype=torch.float32, device=dev)
        alive = lane < n_f[:, None]
        log_n, thr = torch.log(n_f), n_f / 2.0
        uni = torch.where(alive, 1.0 / n_f[:, None], 0.0)
        ll = torch.zeros(c, device=dev)
        dead = torch.zeros(c, dtype=torch.bool, device=dev)

        def k3_day():
            return rf.fused_weight_resample_seeded(
                lw, p3, k2, n_f, uni, thr, "stratified", False, loglike=ll,
                dead=dead, log_n=log_n, estimate=True)

        def ops_around_k3():
            m = torch.where(alive, lw, -math.inf)
            dd = dead | (torch.amax(m, dim=1) < -1e8)
            out, w, ess, lse = rf.fused_weight_resample_seeded(
                torch.clamp_min(m, -1e30), p3, k2, n_f, uni, thr,
                "stratified", False)
            ll2 = torch.where(dd, -math.inf, ll + (lse - log_n))
            rec = torch.where(dd, 0.0, torch.where(ess < thr, n_f, ess))
            w = torch.where(dd[:, None], 0.0, w)
            if parts.ndim == 2:
                return ll2, rec, (w * out[..., 0]).sum(dim=1)
            return ll2, rec, torch.einsum("cn,cnd->cd", w, out)

        ms = cs.graph_ms(k3_day if whole else ops_around_k3, 20)
        cs.say(what, shape=f"{c}x{n}x{p3.shape[2]}", alive=alive_n,
               route="k3_day" if whole else "ops_around_k3", day_ms=ms)


engine_day()
cs.phase_gillespie(dev)
cs.phase_lane_bound(dev)
cs.phase_sinusoidal_kernel(dev)
cs.phase_engine_path(dev)
cs.phase_filters_mh(dev)
cs.phase_sinusoidal_mh(dev)
"""


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    other = pathlib.Path(sys.argv[1]).resolve()
    for turn, root in enumerate((other, ROOT, ROOT, other)):
        proc = subprocess.run([sys.executable, "-c", TURN], cwd=root,
                              capture_output=True, text=True, timeout=900)
        for line in proc.stdout.splitlines():
            print(f"[ab {root.name} {turn}] {line}", flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
