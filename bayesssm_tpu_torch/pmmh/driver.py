"""PMMH sampling phase (port of the sampling half of
``bayesssm_tpu/pmmh/driver.py``).

Chains are the leading axis of every tensor: ``theta [C, P]``, proposal
factors ``[C, P, P]``, particle counts ``[C]`` and two uint32 seed words
per chain ``[C, 2]`` (int64 tensors holding uint32 values). One MH step is
one batched filter sweep over all chains. Pilot tuning
(``pmmh/tuning.py``) and the public ``pmmh()`` are not ported yet; the
phase-1 results the JAX PMMH driver holds (``driver.py:436-474``) enter
through :func:`chain_state_from_numpy`.

Per-step randomness is a device-side lowbias32 stream (``ops/rng.py``),
never a host loop over chains. For chain words ``(w0, w1)``, MH step ``s``
(``s = 0`` is the initial filter evaluation) and word index ``j``:

    k_s     = hash(w0 ^ hash(w1 + s * 0x85EBCA6B))
    word_j  = hash(k_s ^ hash((j + 1) * 0x9E3779B9))

Words 0 and 1 seed the step's filter sweep; words ``2 + 2q`` and
``3 + 2q`` give the ``q``-th proposal normal by Box-Muller from the
uniforms ``(word >> 8) * 2**-24``; word ``2 + 2P`` gives the accept
uniform. Chain words derive from a root seed's two words ``(r0, r1)`` and
the chain id ``i`` as ``w0 = hash(r0 ^ hash(r1 + i * 0x9E3779B9))``,
``w1 = hash(w0 ^ ((i + 1) * 0x85EBCA6B))``. The JAX PMMH driver's threefry
keys give other numbers, so the two samplers agree in distribution; the
tests hand both the same normals, uniforms and filter words.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from bayesssm_tpu_torch.ops.rng import MASK32, box_muller, hash32, mul32
from bayesssm_tpu_torch.pmmh.priors import sum_log_priors
from bayesssm_tpu_torch.pmmh.transforms import (
    back_transform_params,
    log_jacobian,
    transform_params,
)

__all__ = [
    "ChainState",
    "chain_state_from_numpy",
    "init_chain_state",
    "chain_words",
    "step_words",
    "mh_step",
    "sample_chains",
    "SampleResult",
]

_GOLDEN = 0x9E3779B9
_STEP_MUL = 0x85EBCA6B
_INV24 = 1.0 / (1 << 24)


def _proposal_factor(cov: np.ndarray) -> np.ndarray:
    """PSD-tolerant factor L with L L^T = cov (eigen-based, like
    MASS::mvrnorm's eigendecomposition proposal)."""
    cov = 0.5 * (cov + cov.T)
    eigval, eigvec = np.linalg.eigh(cov)
    eigval = np.clip(eigval, 0.0, None)
    return (eigvec * np.sqrt(eigval)[None, :]).astype(np.float32)


def _particle_lane_bound(max_n: int) -> int:
    """Static particle-lane bound: next power of two >= max(max_n, 128),
    as the sweep's block scan and reductions need; masked lanes keep each
    chain at its own count."""
    bound = 128
    while bound < max_n:
        bound *= 2
    return bound


@dataclasses.dataclass
class ChainState:
    """Sampler state on one device. ``ll`` is ``None`` until the initial
    filter evaluation; ``se`` holds state estimates only when requested."""

    theta: torch.Tensor       # [C, P] float32
    factors: torch.Tensor     # [C, P, P] float32
    n: torch.Tensor           # [C] float32 particle counts
    words: torch.Tensor       # [C, 2] int64 uint32 seed words
    ll: torch.Tensor | None = None
    se: torch.Tensor | None = None
    step: int = 0


def chain_state_from_numpy(theta, prop_factors, target_n, seed_words,
                           device) -> ChainState:
    """The port's sampler state from the JAX PMMH driver's phase-1 outputs:
    ``theta_mean [C, P]``, ``prop_factors [C, P, P]`` (from
    ``_proposal_factor``), ``target_n [C]`` and the chains' key words
    ``[C, 2]`` (``jax.random.key_data``)."""
    words = np.array(seed_words).astype(np.uint32).astype(np.int64)
    theta = np.array(theta, np.float32)
    factors = np.array(prop_factors, np.float32)
    n = np.array(target_n, np.float32)
    c, p = theta.shape
    if factors.shape != (c, p, p) or n.shape != (c,) or words.shape != (c, 2):
        raise ValueError(
            "expected theta [C, P], prop_factors [C, P, P], target_n [C] "
            f"and seed_words [C, 2]; got {theta.shape}, {factors.shape}, "
            f"{n.shape}, {words.shape}"
        )
    return ChainState(
        theta=torch.as_tensor(theta, device=device),
        factors=torch.as_tensor(factors, device=device),
        n=torch.as_tensor(n, device=device),
        words=torch.as_tensor(words, device=device),
    )


def chain_words(seed: int, num_chains: int, device) -> torch.Tensor:
    """``[C, 2]`` per-chain words from an integer root seed (module
    docstring)."""
    r0 = int(seed) & MASK32
    r1 = (int(seed) >> 32) & MASK32
    cid = torch.arange(num_chains, dtype=torch.int64, device=device)
    w0 = hash32(r0 ^ hash32((r1 + mul32(cid, _GOLDEN)) & MASK32))
    w1 = hash32(w0 ^ mul32(cid + 1, _STEP_MUL))
    return torch.stack([w0, w1], dim=1)


def init_chain_state(theta0, prop_factors, target_n, seed: int,
                     device) -> ChainState:
    """Sampler state from starting values (``[P]`` or ``[C, P]``), the
    proposal factors ``[C, P, P]``, particle counts ``[C]`` and a root
    seed."""
    factors = np.asarray(prop_factors, np.float32)
    c, p = factors.shape[:2]
    theta = np.broadcast_to(np.asarray(theta0, np.float32), (c, p))
    words = chain_words(seed, c, "cpu").numpy()
    return chain_state_from_numpy(theta, factors,
                                  np.broadcast_to(target_n, (c,)), words,
                                  device)


def step_words(words: torch.Tensor, step: int, count: int) -> torch.Tensor:
    """``[C, count]`` stream words of MH step ``step`` (module docstring)."""
    s_mix = mul32(torch.tensor(step, dtype=torch.int64), _STEP_MUL).item()
    k = hash32(words[:, 0] ^ hash32((words[:, 1] + s_mix) & MASK32))
    j = torch.arange(1, count + 1, dtype=torch.int64, device=words.device)
    return hash32(k[:, None] ^ hash32(mul32(j, _GOLDEN))[None, :])


def _uniform(word: torch.Tensor) -> torch.Tensor:
    return (word >> 8).to(torch.float32) * _INV24


def mh_step(pf, theta, ll, factor, n_chain, eps, u_acc, seed_words,
            prior_fns, transforms, jacobian_convention="consistent",
            se=None):
    """One random-walk MH step for every chain (``driver.py:484-518``).

    ``eps [C, P]`` standard normals, ``u_acc [C]`` uniforms and
    ``seed_words [C, 2]`` for the filter are given. A proposal outside the
    prior support, or a NaN ratio, is rejected. ``se`` (state estimates)
    is carried only when given. Returns ``(theta, ll, se, accept)``.
    """
    z = transform_params(theta, transforms)
    zp = z + (factor * eps[:, None, :]).sum(dim=-1)
    theta_prop = back_transform_params(zp, transforms)
    lp_prop = sum_log_priors(theta_prop, prior_fns)
    ll_prop, se_prop = pf(seed_words, theta_prop, n_chain)
    log_ratio = (
        ll_prop + lp_prop
        + log_jacobian(theta_prop, transforms, jacobian_convention)
    ) - (
        ll + sum_log_priors(theta, prior_fns)
        + log_jacobian(theta, transforms, jacobian_convention)
    )
    log_ratio = torch.where(
        torch.isnan(log_ratio) | ~torch.isfinite(lp_prop), -math.inf,
        log_ratio,
    )
    accept = torch.log(u_acc) < log_ratio
    theta = torch.where(accept[:, None], theta_prop, theta)
    ll = torch.where(accept, ll_prop, ll)
    if se is not None:
        keep = accept.reshape((-1,) + (1,) * (se.ndim - 1))
        se = torch.where(keep, se_prop, se)
    return theta, ll, se, accept


def _init_eval(pf, state: ChainState, return_latent_state_est: bool):
    """The initial filter evaluation at the chains' starting theta, with
    the step-0 stream words (``driver.py:520-529``)."""
    ll, se = pf(step_words(state.words, 0, 2), state.theta, state.n)
    return ll, (se if return_latent_state_est else None)


@dataclasses.dataclass
class SampleResult:
    samples: np.ndarray            # [C, m - burn_in, P]
    acceptance_rate: np.ndarray    # [C], over the m - 1 MH steps
    state: ChainState
    latent: np.ndarray | None      # [C, m - burn_in, T+1(, d)] if requested


def sample_chains(pf, state: ChainState, m: int, burn_in: int, prior_fns,
                  transforms, jacobian_convention: str = "consistent",
                  return_latent_state_est: bool = False) -> SampleResult:
    """Run ``m`` samples per chain: the initial filter evaluation (sample
    0, ``_init_eval``) and ``m - 1`` MH steps.

    ``pf(seed_words, theta, n) -> (loglike, state_est)`` is a batched
    filter such as ``sir_sweep_pf_impl(...)(...)``. Burn-in samples never
    enter the output buffer; the kept samples stay on the device and are
    copied to the host once, at the end.
    """
    if not isinstance(m, (int, np.integer)) or m < 1:
        raise ValueError("m must be an integer >= 1")
    if not isinstance(burn_in, (int, np.integer)) or not 0 <= burn_in <= m - 1:
        raise ValueError("burn_in must be an integer in [0, m - 1]")
    c, p = state.theta.shape
    dev = state.theta.device
    theta, ll = state.theta, state.ll
    se = state.se if return_latent_state_est else None
    if ll is None:
        ll, se = _init_eval(pf, state, return_latent_state_est)
    elif return_latent_state_est and se is None:
        raise ValueError(
            "return_latent_state_est=True, but the state was sampled "
            "without state estimates; continue with it set to False"
        )
    keep = m - burn_in
    samples = torch.empty((c, keep, p), dtype=torch.float32, device=dev)
    latent = ([None] * keep) if return_latent_state_est else None
    accepts = torch.zeros(c, dtype=torch.int64, device=dev)

    def record(s):
        if s >= burn_in:
            samples[:, s - burn_in] = theta
            if latent is not None:
                latent[s - burn_in] = se

    record(0)
    for s in range(1, m):
        w = step_words(state.words, state.step + s, 3 + 2 * p)
        u = _uniform(w[:, 2:2 + 2 * p])
        eps = box_muller(u[:, 0::2], u[:, 1::2])
        theta, ll, se, accept = mh_step(
            pf, theta, ll, state.factors, state.n, eps,
            _uniform(w[:, 2 + 2 * p]), w[:, :2], prior_fns, transforms,
            jacobian_convention, se=se,
        )
        accepts += accept
        record(s)

    new_state = dataclasses.replace(state, theta=theta, ll=ll, se=se,
                                    step=state.step + m - 1)
    return SampleResult(
        samples=samples.cpu().numpy(),
        acceptance_rate=accepts.cpu().numpy() / max(m - 1, 1),
        state=new_state,
        latent=(torch.stack(latent, dim=1).cpu().numpy()
                if latent is not None else None),
    )
