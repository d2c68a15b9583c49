#!/usr/bin/env python3
"""Time the port's kernels in two checkouts on one NVIDIA GPU, in turns.

``python3 scripts/torch_kernel_ab.py OTHER_ROOT`` runs, in the order
other, this, this, other, one process per turn with its working directory
at that checkout's root. Each process builds that checkout's kernels,
runs its own ``chip_smoke.py`` phase that holds and times K2 alone
(``bssm_select``, phase 3), times K1 with the SIR functor by CUDA-graph
replay (BPF, APF, RMPF and gapped at phase 5's shape, and APF at phase
16's 1024-lane bound), then runs its phases that hold and time K3 (phase
7, and with the aux column, phase 13), K4 (phase 8), the 1024-lane bound
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
