#!/usr/bin/env python3
"""Bring-up check of the PyTorch + CUDA port (``bayesssm_tpu_torch``) on one
NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It builds the
CUDA kernels from ``bayesssm_tpu_torch/csrc`` with ``nvcc``, holds each one
against its plain PyTorch version on the card, and drives the port's main
path — stochastic-SIR PMMH, 4096 chains x 128 particles, T = 10 — through
``sample_chains`` and ``sir_sweep_pf_impl``. Phases:

1. device name, count, and ``nvidia-smi`` name and power limit;
2. kernel build: seconds, registers and spills from ``-Xptxas -v``;
3. ``bssm_select`` against searchsorted + gather, bitwise, N in {128, 1024};
4. LGSS sweep kernel against the plain sweep (C=512, N=1024, T=20, SISR):
   >= 99% of chains within 1e-3 in loglike, mean within max(5 SE, 0.1) of
   the exact Kalman value;
5. SIR sweep kernel against the plain sweep at 4096 x 128 x 10: >= 99% of
   chains within 1e-3, all finite, a second launch bitwise equal; kernel
   and plain ms per sweep;
6. the main path: one warm-up MH step, then 64 timed steps (samples/s on
   the host clock up to ``torch.cuda.synchronize()``), the plain sweep
   over 4 steps, and an acceptance rate strictly inside (0, 1).

Any failure raises (exit code not 0). Without a CUDA device it fails
before printing any result. The last line is one JSON object
``{"ok": true, "device": {...}}``; the line before it is nvidia-smi's, and
the one before that the per-kernel JSON.
"""

from __future__ import annotations

import json
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
CHAINS, PARTICLES = 4096, 128
AGREE_TOL = 1e-3       # |d loglike| per chain, kernel vs plain sweep
AGREE_SHARE = 0.99     # share of chains that must agree within AGREE_TOL


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
    log_priors, transform = sir_model()
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
    return launches


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

    phase_select(dev)
    phase_lgss(dev)
    err, kernel_ms, plain_ms = phase_sir(dev)
    launches = phase_main_path(dev)

    print(json.dumps({"kernels": [{
        "name": "bssm_sweep_sir", "route": ROUTE, "source": SWEEP_SOURCE,
        "replaces": SWEEP_REPLACES, "launches": launches,
        "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
