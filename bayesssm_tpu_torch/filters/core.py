"""The generic SMC engine behind the particle filters (port of
``bayesssm_tpu/filters/core.py``): the bootstrap (BPF), auxiliary (APF)
and resample-move (RMPF) filters.

One call filters ``C`` chains at once. The reference's per-observation loop
is a Python loop over the ``T`` days on batched tensors, and every
data-dependent branch (adaptive resampling, the degenerate-weight exit) is
a ``where`` per chain, as in the JAX engine.

**Calling convention.** Chains are the leading axis:

* ``key`` is ``[C, 2]``: each chain's two uint32 key words (the
  ``jax.random.key_data`` of its key) in an int64 tensor, whose device is
  the device the filter runs on. Every draw derives from it through
  ``ops/threefry.py`` exactly as the JAX engine derives its draws from the
  key: ``split(key)`` for the initial draw (:350), ``split(key, (T, 5))``
  for the days (:669) and ``fold_in`` in the gap loop (:461). So a chain's
  output depends only on its own key.
* Model functions are called with keywords, and declare the ones they use
  (``utils/signatures.py``): ``key`` (``[C, 2]`` words), ``particles``
  (``[C, N]`` or ``[C, N, d]``), each ``theta`` value as a ``[C]`` float32
  tensor, ``y`` (the day's observation: a 0-d tensor, or ``[d_y]``), ``t``
  (the observation time, an int) and, for ``init_fn``, ``num_particles``
  (the static lane count ``N``). They return ``[C, N]`` or ``[C, N, d]``
  particles, or ``[C, N]`` log-weights. A ``move_fn`` may instead be
  written for one particle (``utils/signatures.py::adapt_move_fn``).
* ``num_particles`` is an int, or a ``[C]`` tensor of per-chain counts
  with a static lane bound ``max_particles``: lanes at or above a chain's
  count carry ``-inf`` log-weight and are never selected (masked lanes).

**Weight step.** ``use_fused`` takes the JAX package's values:

* ``False`` — the portable path: ``normalize_log_weights``, ESS and
  ``ops/resampling.py`` (lower-bound search);
* ``True`` or ``"interpret"`` — the fused step (``ops/resampling_fused.py``,
  K3) with positions drawn from ``k_res`` by ``_positions``, the stream of
  the portable path;
* ``"interpret-inkernel"`` — the fused step drawing its positions from
  ``k_res``'s words itself;
* ``"auto"`` — the in-kernel fused step when the tensors lie on a CUDA
  device and the JAX gate holds (a lane count that is a multiple of 128
  and at most 1024, not SIS, not Metropolis, float32 particles), the
  portable path otherwise.

``resample_fn="metropolis"`` (``ops/resampling.py::
metropolis_resample_indices``) runs on the portable path only: K3 selects
by inverse CDF, so an explicit fused route with it raises ``ValueError``
with the JAX engine's message.

A fused step launches its CUDA kernel on CUDA tensors and runs its plain
version on CPU tensors; no value selects the plain version on the card.
On a fused route in float32 without ``carry_weights``, that one call is
the day's whole weight step: it takes the raw log-weights and the running
log-likelihood and dead flags, and returns the log-likelihood, the ESS
record, the zeroed weights of dead chains and (but for RMPF, whose move
comes after it) the state estimate, so no PyTorch op runs between the
weight function and the next day's transition (``engine.k3_days`` counts
such a day, RMPF's too).

**APF.** After the gap loop the auxiliary log-weights select ancestors
(a forced resample drawn from ``k_aux``), the particles take a second
transition from ``k_trans2`` (quirk Q2), and the day's log-weights are
``weight - aux_anc``, the ancestors' aux log-weights. Degenerate aux
weights kill the chain as degenerate weights do. On the fused routes the
aux log-weights, clamped at -1e30, ride through the weight-step kernel as
an extra particle column, so the kernel carries them to the ancestors.

**RMPF.** Every day resamples (SISR, whatever ``resample_algorithm``
says), then ``move_fn`` rejuvenates the particles with ``k_move``.

Reproduced semantics: Q2 (the APF's second transition), Q3 (cumulative
``loglike_history``), Q4 (ESS at t = 0 is ``num_particles``, and after a
resample the recorded ESS is ``num_particles``), Q5 (state estimates
after a resample use the uniform weights), fresh weights each day unless
``carry_weights``, and degenerate weights (every log-weight below -1e8)
giving ``-inf`` with zeroed weights and ESS from that day on.

**Particle sharding.** ``particle_axis`` names a mesh axis of
``particle_axis_size`` ranks over which each chain's particles are
sharded; the call runs on every rank of that axis inside
``parallel.mesh.use_mesh(mesh)`` (``parallel/collectives.py``), as the
JAX engine runs inside ``shard_map``. Each rank holds ``n_loc = N /
particle_axis_size`` lanes (global lanes ``shard * n_loc + j``), and the
model functions see ``num_particles = n_loc``. The model streams (the
initial draw, the gap loop, the APF's second transition, the move) fold
in the shard index; the resampling keys stay the same on every shard. The
weight step's maximum, sums and ESS are completed over the axis, the
resampling is ``sharded_resample_indices`` with ``sharded_gather``, and
the state estimate is summed over the shards, so every shard returns the
global log-likelihood, ESS and state estimate. The fused weight step is
single-shard, so it is off under sharding (as in JAX): ``"auto"`` takes
the collective portable path there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from bayesssm_tpu_torch.ops import threefry
from bayesssm_tpu_torch.ops.resampling import (
    RESAMPLE_METHODS,
    _positions,
    gather_particles,
    resample_indices,
    sharded_gather,
    sharded_resample_indices,
)
from bayesssm_tpu_torch.ops.resampling_fused import (
    FUSED_FLOOR,
    MAX_FUSED_LANES,
    fused_weight_resample,
    fused_weight_resample_seeded,
)
from bayesssm_tpu_torch.ops.weights import (
    DEGENERATE_LOG_WEIGHT,
    effective_sample_size,
    normalize_log_weights,
)
from bayesssm_tpu_torch.utils.signatures import adapt_fn, adapt_move_fn
from bayesssm_tpu_torch.utils.timing import count, host_copy, span, spanned

__all__ = ["particle_filter_core", "FilterResult", "FilterConfig",
           "obs_times_to_gaps"]

ALGORITHMS = ("BPF", "APF", "RMPF")
RESAMPLE_ALGORITHMS = ("SIS", "SISR", "SISAR")


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """Validated filter configuration; ``particle_filter_core(...,
    config=cfg)`` takes every field from it and ignores the matching
    keyword arguments."""

    algorithm: str = "BPF"
    resample_algorithm: str = "SISAR"
    resample_fn: str = "stratified"
    threshold: Optional[float] = None
    return_particles: bool = True
    max_particles: Optional[int] = None
    carry_weights: bool = False
    use_fused: str | bool = "auto"
    particle_axis: Optional[str] = None
    particle_axis_size: int = 1

    def __post_init__(self):
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"algorithm must be one of {ALGORITHMS}")
        if self.resample_algorithm not in RESAMPLE_ALGORITHMS:
            raise ValueError(
                f"resample_algorithm must be one of {RESAMPLE_ALGORITHMS}"
            )
        if self.resample_fn not in RESAMPLE_METHODS:
            raise ValueError(f"resample_fn must be one of {RESAMPLE_METHODS}")
        if self.threshold is not None and not self.threshold >= 0:
            raise ValueError("threshold must be non-negative")
        if self.max_particles is not None and self.max_particles < 1:
            raise ValueError("max_particles must be a positive integer")
        if self.particle_axis_size < 1:
            raise ValueError("particle_axis_size must be >= 1")

    def kwargs(self) -> dict:
        """The fields as ``particle_filter_core`` keyword arguments."""
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class FilterResult:
    """The reference filter's return list, with a leading chain axis."""

    state_est: torch.Tensor          # [C, T+1, d] (or [C, T+1])
    ess: torch.Tensor                # [C, T+1]
    loglike: torch.Tensor            # [C]
    loglike_history: torch.Tensor    # [C, T], cumulative (Q3)
    algorithm: str = "BPF"
    resample_algorithm: str = "SISAR"
    particles_history: Optional[torch.Tensor] = None  # [C, T+1, N(, d)]
    weights_history: Optional[torch.Tensor] = None    # [C, T+1, N]


def _resolve_obs_times(obs_times, num_obs: int) -> np.ndarray:
    """Validate observation times (the reference's assertions)."""
    if obs_times is None:
        return np.arange(1, num_obs + 1, dtype=np.int64)
    try:
        ot_raw = np.asarray(obs_times)
        if not np.issubdtype(ot_raw.dtype, np.number):
            raise TypeError
    except (TypeError, ValueError):
        raise ValueError("obs_times must be numeric integers") from None
    if not np.all(ot_raw == np.floor(ot_raw)):
        raise ValueError("obs_times must be integers")
    ot = ot_raw.astype(np.int64)
    if ot.ndim != 1 or ot.shape[0] != num_obs:
        raise ValueError("obs_times must have one entry per observation")
    if (ot < 1).any() or (np.diff(ot) <= 0).any():
        raise ValueError("obs_times must be >= 1 and strictly increasing")
    return ot


def obs_times_to_gaps(obs_times, num_obs: int) -> tuple:
    """Per-observation transition counts ``ot[i] - ot[i-1]`` (with
    ``ot[-1] = 0``) from validated observation times."""
    ot = _resolve_obs_times(obs_times, num_obs)
    return tuple(np.diff(ot, prepend=0).tolist())


def _observations(y, device, dtype=torch.float32) -> torch.Tensor:
    host_copy(y, device)
    if isinstance(y, torch.Tensor):
        if y.dtype == torch.bool or y.is_complex():
            raise ValueError("y must be numeric")
        ys = y.to(device=device, dtype=dtype)
    else:
        try:
            y_host = np.asarray(y)
            if not np.issubdtype(y_host.dtype, np.number):
                raise TypeError
        except (TypeError, ValueError):
            raise ValueError("y must be numeric") from None
        ys = torch.as_tensor(y_host, dtype=dtype, device=device)
    if ys.ndim == 1:
        ys = ys[:, None]
    if ys.ndim != 2:
        raise ValueError("y must be a [T] vector or [T, d_y] matrix")
    if ys.shape[0] < 1:
        raise ValueError("y must contain at least one observation")
    return ys


def _per_chain(v, c: int, dtype, dev) -> torch.Tensor:
    """A scalar or ``[C]`` value as a contiguous ``[C]`` tensor on ``dev``;
    a Python number becomes a fill, not a host-to-device copy."""
    if isinstance(v, torch.Tensor):
        host_copy(v, dev)
        return v.to(device=dev, dtype=dtype).expand(c).contiguous()
    v = np.asarray(v)
    if v.ndim == 0:
        return torch.full((c,), float(v), dtype=dtype, device=dev)
    host_copy(v, dev)
    return torch.as_tensor(v, dtype=dtype, device=dev).expand(c).contiguous()


def _weighted_sum(weights: torch.Tensor, particles: torch.Tensor):
    """``sum_n w[c, n] * p[c, n, ...]``: the state estimate per chain."""
    if particles.ndim == 2:
        return (weights * particles).sum(dim=1)
    return torch.einsum("cn,cnd->cd", weights, particles)


@spanned("filter")
def particle_filter_core(
    key,
    y,
    num_particles,
    init_fn,
    transition_fn,
    weight_fn,
    aux_weight_fn=None,
    move_fn=None,
    theta: Optional[dict] = None,
    obs_times=None,
    algorithm: str = "BPF",
    resample_algorithm: str = "SISAR",
    resample_fn: str = "stratified",
    threshold: Optional[float] = None,
    return_particles: bool = True,
    max_particles: Optional[int] = None,
    carry_weights: bool = False,
    use_fused: str | bool = "auto",
    particle_axis: Optional[str] = None,
    particle_axis_size: int = 1,
    config: Optional[FilterConfig] = None,
) -> FilterResult:
    """Run one particle filter for each chain of ``key [C, 2]`` (module
    docstring). Returns a :class:`FilterResult` with a leading chain
    axis."""
    if config is not None:
        cfg = config.kwargs()
        algorithm = cfg["algorithm"]
        resample_algorithm = cfg["resample_algorithm"]
        resample_fn = cfg["resample_fn"]
        threshold = cfg["threshold"]
        return_particles = cfg["return_particles"]
        max_particles = cfg["max_particles"]
        carry_weights = cfg["carry_weights"]
        use_fused = cfg["use_fused"]
        particle_axis = cfg["particle_axis"]
        particle_axis_size = cfg["particle_axis_size"]
    if algorithm not in ALGORITHMS:
        raise ValueError(f"algorithm must be one of {ALGORITHMS}")
    if resample_algorithm not in RESAMPLE_ALGORITHMS:
        raise ValueError(
            f"resample_algorithm must be one of {RESAMPLE_ALGORITHMS}")
    if resample_fn not in RESAMPLE_METHODS:
        raise ValueError(f"resample_fn must be one of {RESAMPLE_METHODS}")
    if algorithm == "APF" and aux_weight_fn is None:
        raise ValueError("APF requires aux_weight_fn")
    if algorithm == "RMPF" and move_fn is None:
        raise ValueError("RMPF requires a move_fn")

    theta = dict(theta or {})
    if max_particles is None:
        if not isinstance(num_particles, (int, np.integer)):
            raise ValueError(
                "max_particles is required when num_particles is traced"
            )
        if num_particles < 1:
            raise ValueError("num_particles must be a positive integer")
        max_particles = int(num_particles)
    n_static = int(max_particles)

    sharded = particle_axis is not None
    if sharded:
        if particle_axis_size < 1 or n_static % particle_axis_size:
            raise ValueError(
                "num_particles/max_particles must be divisible by "
                "particle_axis_size"
            )
        from bayesssm_tpu_torch.parallel.collectives import (
            axis_index,
            pmax,
            psum,
        )

        n = n_static // particle_axis_size
    else:
        n = n_static

    init = adapt_fn(init_fn, "init_fn", required=("num_particles",))
    trans = adapt_fn(transition_fn, "transition_fn", required=("particles",))
    weight = adapt_fn(weight_fn, "weight_fn", required=("particles", "y"))
    auxw = (adapt_fn(aux_weight_fn, "aux_weight_fn",
                     required=("particles", "y"))
            if aux_weight_fn is not None else None)
    move = adapt_move_fn(move_fn) if move_fn is not None else None

    words = threefry.as_key_words(key)
    if words.ndim != 2:
        raise ValueError(
            f"key must be [C, 2] chain key words (got shape "
            f"{tuple(words.shape)})")
    c = words.shape[0]
    dev = words.device
    ys = _observations(y, dev)
    num_obs, d_y = ys.shape
    ot = _resolve_obs_times(obs_times, num_obs)
    gaps = np.diff(np.concatenate([[0], ot]))
    plain_gaps = bool((gaps == 1).all())

    theta = {name: _per_chain(v, c, torch.float32, dev)
             for name, v in theta.items()}

    def canon(p, who):
        p = torch.as_tensor(p)
        if p.ndim == 2:
            if p.shape[1] != n:
                raise ValueError(f"{who} must return num_particles")
        elif p.ndim == 3:
            if p.shape[1] != n:
                raise ValueError(f"{who} must return num_particles rows")
        else:
            raise ValueError(f"{who} must return a [C, n] or [C, n, d] "
                             "array")
        if p.shape[0] != c:
            raise ValueError(f"{who} must return one row per chain")
        return p

    with span("keys"):
        key_run, k_init = threefry.split(words).unbind(1)
        step_keys = threefry.split(key_run, (num_obs, 5))   # [C, T, 5, 2]
    p_idx = axis_index(particle_axis) if sharded else None
    if sharded:
        # Per-shard model streams; the resampling keys stay shard-identical.
        k_init = threefry.fold_in(k_init, p_idx)
    particles0 = canon(init(key=k_init, num_particles=n, **theta), "init_fn")
    dtype = particles0.dtype
    if dtype == torch.float64:
        # A float64 model filters in float64, its observations too.
        ys = _observations(y, dev, dtype)

    n_f = _per_chain(num_particles, c, dtype, dev)
    lane = torch.arange(n, dtype=dtype, device=dev)
    if sharded:
        lane = lane + float(p_idx * n)      # global lane ids
    alive = lane < n_f[:, None]
    log_n = torch.log(n_f)
    if threshold is None:
        thr = n_f / 2.0 if resample_algorithm == "SISAR" else None
    else:
        thr = _per_chain(threshold, c, dtype, dev)
    uniform_w = torch.where(alive, 1.0 / n_f[:, None], 0.0)
    log_uniform_w = torch.where(alive, -log_n[:, None], -math.inf)

    # The weight-step gate of the JAX engine (:390-409), with "the Pallas
    # kernel can compile" read as "the tensors are on a CUDA device"; the
    # static lane count is the global one.
    inkernel_rng = use_fused in ("auto", "interpret-inkernel")
    if use_fused == "auto":
        fused_enabled = (
            dev.type == "cuda"
            and n_static % 128 == 0
            and n_static <= MAX_FUSED_LANES
            and resample_algorithm != "SIS"
            and resample_fn != "metropolis"
            and dtype == torch.float32
        )
    elif use_fused == "interpret-inkernel":
        fused_enabled = True
    else:
        fused_enabled = bool(use_fused)
    if fused_enabled and resample_fn == "metropolis":
        raise ValueError(
            "the fused Pallas path implements inverse-CDF selection only; "
            "use_fused must be False/'auto' with resample_fn='metropolis'"
        )
    if sharded:
        # K3's CDF and selection are single-shard: the sharded weight step
        # runs the collective portable path (JAX core.py:423-429).
        fused_enabled = False
    always_resample = algorithm == "RMPF" or resample_algorithm == "SISR"
    zero_thr = torch.zeros_like(n_f)
    thr_arg = thr if thr is not None else zero_thr

    def fused_step(lw_safe, p3, key_words, threshold, always, **day):
        """K3 (or its plain version) on ``[C, N, d]`` particles; ``day``
        holds the engine's day arguments where K3 takes the whole day."""
        if inkernel_rng:
            return fused_weight_resample_seeded(
                lw_safe, p3, key_words, n_f, uniform_w, threshold,
                method=resample_fn, always_resample=always, **day)
        pos = _positions(key_words, resample_fn, n, n_f)
        return fused_weight_resample(lw_safe, p3, pos, uniform_w, threshold,
                                     always_resample=always,
                                     num_alive=n_f if day else None, **day)

    # K3 takes the day's whole weight step (mask, degenerate check,
    # log-likelihood, ESS record, zeroed weights and, unless a move follows,
    # the state estimate) where the fused step runs on float32 with fresh
    # weights each day; carried weights combine with the last day's
    # weights first and keep the steps around K3.
    k3_day = fused_enabled and not carry_weights and dtype == torch.float32
    k3_estimate = k3_day and algorithm != "RMPF"

    def log_weights(fn, who, particles, y_i, t_i):
        lw = torch.as_tensor(fn(y=y_i, particles=particles, t=t_i, **theta))
        if lw.shape[-1] != n:
            raise ValueError(f"{who} must return num_particles")
        return lw

    particles = particles0
    lnw_prev = log_uniform_w
    loglike = torch.zeros(c, dtype=dtype, device=dev)
    dead = torch.zeros(c, dtype=torch.bool, device=dev)
    states, esses, lls, p_hist, w_hist = [], [], [], [], []
    for t in range(num_obs):
        with span("day"):
            with span("keys"):
                y_i = ys[t, 0] if d_y == 1 else ys[t]
                t_i = int(ot[t])
                k_gap, k_aux, k_trans2, k_res, k_move = step_keys[
                    :, t].unbind(1)
                if sharded:
                    k_gap = threefry.fold_in(k_gap, p_idx)
                    k_trans2 = threefry.fold_in(k_trans2, p_idx)
                    k_move = threefry.fold_in(k_move, p_idx)

            # --- propagate through observation-time gaps ---
            with span("transition"):
                if plain_gaps:
                    particles = canon(
                        trans(key=k_gap, particles=particles, t=t_i,
                              **theta),
                        "transition_fn")
                else:
                    gap_i = int(gaps[t])
                    for s in range(gap_i):
                        particles = canon(
                            trans(key=threefry.fold_in(k_gap, s),
                                  particles=particles,
                                  t=t_i - gap_i + s + 1, **theta),
                            "transition_fn")

            if algorithm == "APF":
                with span("weight_step"):
                    aux_lw = torch.where(
                        alive, log_weights(auxw, "aux_weight_fn", particles,
                                           y_i, t_i).to(dtype),
                        -math.inf)
                    # Degenerate aux weights kill the chain: without this
                    # the fused path's -1e30 clamp cancels in lw - aux_anc
                    # and a dead proposal would give a huge spurious
                    # log-likelihood.
                    aux_max = torch.amax(aux_lw, dim=1)
                    if sharded:
                        aux_max = pmax(aux_max, particle_axis)
                    dead = dead | (aux_max < DEGENERATE_LOG_WEIGHT)
                    aux_base = aux_lw + lnw_prev if carry_weights else aux_lw
                    if fused_enabled:
                        p3 = (particles if particles.ndim == 3
                              else particles[..., None])
                        aux_col = torch.clamp_min(aux_lw,
                                                  FUSED_FLOOR)[..., None]
                        p_ext = fused_step(
                            torch.clamp_min(aux_base, FUSED_FLOOR),
                            torch.cat([p3, aux_col], dim=-1), k_aux,
                            zero_thr, True)[0]
                        aux_anc = p_ext[..., -1]
                        particles = (p_ext[..., :-1] if particles.ndim == 3
                                     else p_ext[..., 0])
                    elif sharded:
                        aux_w, _, _ = normalize_log_weights(
                            aux_base, axis_name=particle_axis)
                        anc = sharded_resample_indices(
                            k_aux, aux_w, resample_fn, particle_axis, n_f)
                        particles = sharded_gather(particles, anc,
                                                   particle_axis)
                        aux_anc = sharded_gather(aux_lw, anc, particle_axis)
                    else:
                        aux_w, _, _ = normalize_log_weights(aux_base)
                        anc = resample_indices(k_aux, aux_w,
                                               method=resample_fn,
                                               num_alive=n_f, validate=False)
                        particles = gather_particles(particles, anc)
                        aux_anc = torch.gather(aux_lw, 1, anc)
                # Q2: a second transition after the auxiliary resample.
                with span("transition"):
                    particles = canon(
                        trans(key=k_trans2, particles=particles, t=t_i,
                              **theta),
                        "transition_fn")

            with span("weight_step"):
                lw = log_weights(weight, "weight_fn", particles, y_i, t_i)
                if algorithm == "APF":
                    lw = lw - aux_anc
                if k3_day:
                    p3 = (particles if particles.ndim == 3
                          else particles[..., None])
                    p3, weights, _, _, loglike, ess_rec, state = fused_step(
                        lw.expand(c, n), p3, k_res, thr_arg, always_resample,
                        loglike=loglike, dead=dead, log_n=log_n,
                        estimate=k3_estimate)
                    if particles.ndim == 2:
                        p3 = p3[..., 0]
                        state = None if state is None else state[:, 0]
                    particles = p3
                else:
                    lw = torch.where(alive, lw.to(dtype), -math.inf)
                    # --- degenerate-weight detection ---
                    lw_max = torch.amax(lw, dim=1)
                    if sharded:
                        lw_max = pmax(lw_max, particle_axis)
                    dead = dead | (lw_max < DEGENERATE_LOG_WEIGHT)
                    if carry_weights:
                        # After an APF step the aux resample consumed the
                        # carried weights.
                        combined = lw + (log_uniform_w if algorithm == "APF"
                                         else lnw_prev)
                    else:
                        combined = lw

                    if fused_enabled:
                        p3 = (particles if particles.ndim == 3
                              else particles[..., None])
                        p3, weights, ess, lse = fused_step(
                            torch.clamp_min(combined, FUSED_FLOOR), p3, k_res,
                            thr_arg, always_resample)
                        particles = p3 if particles.ndim == 3 else p3[..., 0]
                        incr = lse if carry_weights else lse - log_n
                        loglike = torch.where(dead, -math.inf, loglike + incr)
                        if always_resample:
                            ess_rec = n_f
                        else:
                            ess_rec = torch.where(ess < thr_arg, n_f, ess)
                    else:
                        weights, lse, mx = normalize_log_weights(
                            combined, axis_name=particle_axis)
                        incr = ((mx + lse) if carry_weights
                                else (mx + lse - log_n))
                        loglike = torch.where(dead, -math.inf, loglike + incr)
                        ess = effective_sample_size(weights,
                                                    axis_name=particle_axis)
                        if resample_algorithm == "SIS" and not always_resample:
                            ess_rec = ess
                        else:
                            if sharded:
                                idx = sharded_resample_indices(
                                    k_res, weights, resample_fn, particle_axis,
                                    n_f)
                                resampled = sharded_gather(particles, idx,
                                                           particle_axis)
                            else:
                                idx = resample_indices(k_res, weights,
                                                       method=resample_fn,
                                                       num_alive=n_f,
                                                       validate=False)
                                resampled = gather_particles(particles, idx)
                            if always_resample:
                                particles, weights, ess_rec = (resampled,
                                                               uniform_w, n_f)
                            else:
                                do = ess < thr
                                do_p = do.reshape(
                                    (c,) + (1,) * (particles.ndim - 1))
                                particles = torch.where(do_p, resampled,
                                                        particles)
                                weights = torch.where(do[:, None], uniform_w,
                                                      weights)
                                ess_rec = torch.where(do, n_f, ess)

            if algorithm == "RMPF":
                with span("transition"):
                    particles = canon(
                        move(key=k_move, particles=particles, y=y_i, t=t_i,
                             **theta),
                        "move_fn")

            with span("estimate"):
                if not k3_day:
                    # Dead chains: zero weights so the state estimate and
                    # ESS are 0.
                    weights = torch.where(dead[:, None], 0.0, weights)
                    ess_rec = torch.where(dead, 0.0, ess_rec)
                if carry_weights:
                    pos_w = weights > 0
                    lnw_prev = torch.where(
                        pos_w, torch.log(torch.where(pos_w, weights, 1.0)),
                        -math.inf)

                if not k3_estimate:
                    state = _weighted_sum(weights, particles)
                states.append(psum(state, particle_axis) if sharded
                              else state)
                esses.append(ess_rec)
                lls.append(loglike)
                if return_particles:
                    p_hist.append(particles)
                    w_hist.append(weights)
                count("engine.days")
                if k3_day:
                    count("engine.k3_days")

    state0 = _weighted_sum(uniform_w, particles0)
    if sharded:
        state0 = psum(state0, particle_axis)
    return FilterResult(
        state_est=torch.stack([state0, *states], dim=1),
        ess=torch.stack([n_f, *esses], dim=1),
        loglike=loglike,
        loglike_history=torch.stack(lls, dim=1),
        algorithm=algorithm,
        resample_algorithm=resample_algorithm,
        particles_history=(torch.stack([particles0, *p_hist], dim=1)
                           if return_particles else None),
        weights_history=(torch.stack([uniform_w, *w_hist], dim=1)
                         if return_particles else None),
    )
