"""Whole-sweep particle filter: the batched plain version and its CUDA kernel.

Port of ``bayesssm_tpu/ops/sweep_builder.py`` (BPF with fresh weights,
``carry_weights=False``). One call runs all T days of a bootstrap filter
for a batch of chains laid out as ``[C, N]`` tensors: on-chip-style
counter RNG (``ops/rng.py``), masked lanes (a chain's ``num_particles`` may
be below the static lane bound ``max_particles``), max-shifted weights,
ESS and the likelihood increment, stratified or systematic positions, the
Hillis-Steele CDF with a running max, selection (``ops/merge_select.py``),
adaptive (SISAR), forced (SISR) or no (SIS) resampling, state estimates,
and the degenerate-weight ``-inf`` contract.

Model callbacks (the JAX sweep builder's contract, batched): ``init_fn(rng,
theta)`` and ``transition_fn(rng, cols, theta, t)`` return tuples of
``[C, N]`` float32 columns, ``log_weight_fn(cols, theta, y_t)`` returns the
unmasked ``[C, N]`` log-density; ``theta`` is a tuple of ``[C, N]``
broadcasts of the per-chain parameters; ``rng`` is a
:class:`~bayesssm_tpu_torch.ops.rng.SweepRng` with one counter per chain.

Two implementations stand behind one op:

* :meth:`SweepOp.sweep_reference` — a Python loop over T on ``[C, N]``
  tensors that runs the callbacks. Sums over particles are a fixed
  pairwise tree (:func:`tree_sum`), the order of the kernel's shared-memory
  reduction, so the kernel can be held to it chain by chain.
* the CUDA kernel ``csrc/sweep.cu`` (one thread block per chain), for
  models that name a :class:`KernelModel` (SIR and LGSS).

Calling the op routes by device: CPU tensors run the plain version, CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bayesssm_tpu_torch.ops import _build
from bayesssm_tpu_torch.ops.merge_select import select_cols_reference
from bayesssm_tpu_torch.ops.rng import SweepRng, lane_keys

__all__ = [
    "KernelModel",
    "SweepOp",
    "build_sweep_op",
    "build_sweep_pf_impl",
    "tree_sum",
    "running_cdf",
    "cdf_ext",
    "chain_params",
]

_NEG = -1e30
_DEGENERATE = -1e8
_SENTINEL = 1.5
_MODE = {"adaptive": 0, "always": 1, "never": 2}


class KernelModel(NamedTuple):
    """The CUDA functor that runs a model's callbacks in the kernel:
    ``entry`` is the C entry point (``bssm_sweep_sir``/``bssm_sweep_lgss``)
    and ``consts`` its model constants, in the C signature's order."""

    entry: str
    consts: tuple


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """``[C, N] -> [C, 1]`` sum in halving order (``x[:h] + x[h:]``), the
    kernels' block reduction. A lane count that is not a power of two is
    padded with zeros up to one, as the kernels' idle threads are."""
    n = x.shape[-1]
    if n & (n - 1):
        pad = (1 << (n - 1).bit_length()) - n
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
        n += pad
    while n > 1:
        n //= 2
        x = x[..., :n] + x[..., n:]
    return x


def chain_params(words: torch.Tensor, *vals) -> torch.Tensor:
    """``[C, P]`` float32 parameters on the device of ``words [C, 2]``;
    each value is a scalar or a ``[C]`` tensor."""
    c = words.shape[0]
    return torch.stack([
        torch.as_tensor(v, dtype=torch.float32, device=words.device)
        .expand(c) for v in vals
    ], dim=1)


def _shift(x: torch.Tensor, s: int) -> torch.Tensor:
    """Lane ``l`` reads ``x[l - s]``; lanes below ``s`` read 0."""
    return torch.cat([torch.zeros_like(x[:, :s]), x[:, :-s]], dim=1)


def running_cdf(w: torch.Tensor) -> torch.Tensor:
    """Hillis-Steele inclusive scan, then a running max, in the doubling
    order of the JAX kernels (``sweep_builder.py:244-254``,
    ``resampling_pallas.py:111-129``)."""
    n = w.shape[-1]
    cdf = w
    s = 1
    while s < n:
        cdf = cdf + _shift(cdf, s)
        s *= 2
    s = 1
    while s < n:
        cdf = torch.maximum(cdf, _shift(cdf, s))
        s *= 2
    return cdf


def cdf_ext(w: torch.Tensor, lane_f: torch.Tensor,
            alive: torch.Tensor) -> torch.Tensor:
    """:func:`running_cdf` pinned to the 1.5 sentinel from the last alive
    lane on (``sweep_builder.py:255-257``)."""
    return torch.where(lane_f >= alive - 1.0, _SENTINEL, running_cdf(w))


class SweepOp:
    """``op(seed_words [C, 2], y [T] or [T, d_y], theta [C, P],
    num_particles, max_particles=None, threshold=None) -> (loglike [C],
    state_est [C, T+1] or [C, T+1, d])``.

    ``seed_words`` holds each chain's two uint32 key words in an int64
    tensor; ``num_particles`` and ``threshold`` are scalars or ``[C]``
    tensors (default threshold: half the alive count).
    """

    def __init__(self, num_state_cols, init_fn, transition_fn,
                 log_weight_fn, num_params, method, mode, num_obs_cols,
                 kernel):
        self.d = int(num_state_cols)
        self.p = int(num_params)
        self.d_y = int(num_obs_cols)
        self.init_fn = init_fn
        self.transition_fn = transition_fn
        self.log_weight_fn = log_weight_fn
        self.method = method
        self.mode = mode
        self.kernel = kernel

    def _prepare(self, seed_words, y, theta, num_particles, max_particles,
                 threshold):
        if max_particles is None:
            max_particles = int(num_particles)
        n = int(max_particles)
        if n < 128 or n > 1024 or n & (n - 1):
            raise ValueError(
                "max_particles must be a power of two in [128, 1024] "
                f"(got {n}); the sweep's block scan and reductions halve "
                "the lane count"
            )
        theta = torch.as_tensor(theta, dtype=torch.float32)
        if theta.ndim != 2 or theta.shape[1] != self.p:
            raise ValueError(
                f"theta must be [C, {self.p}] (got {tuple(theta.shape)})"
            )
        dev = theta.device
        c = theta.shape[0]
        ys = torch.as_tensor(y, dtype=torch.float32, device=dev)
        if self.d_y == 1:
            ys = ys.reshape(-1, 1)
        elif ys.ndim != 2 or ys.shape[1] != self.d_y:
            raise ValueError(
                f"y must be [T, {self.d_y}] for num_obs_cols={self.d_y} "
                f"(got shape {tuple(ys.shape)})"
            )
        words = torch.as_tensor(seed_words, dtype=torch.int64, device=dev)
        if words.shape != (c, 2):
            raise ValueError(
                f"seed_words must be [C, 2] = [{c}, 2] "
                f"(got {tuple(words.shape)})"
            )
        alive = torch.as_tensor(num_particles, dtype=torch.float32,
                                device=dev).expand(c).contiguous()
        thr = (
            torch.as_tensor(threshold, dtype=torch.float32, device=dev)
            .expand(c).contiguous()
            if threshold is not None else alive / 2.0
        )
        return words, ys.contiguous(), theta.contiguous(), alive, thr, n

    def _shape_est(self, est: torch.Tensor) -> torch.Tensor:
        return est[..., 0] if self.d == 1 else est

    def __call__(self, seed_words, y, theta, num_particles,
                 max_particles=None, threshold=None):
        args = self._prepare(seed_words, y, theta, num_particles,
                             max_particles, threshold)
        if args[2].device.type == "cpu":
            ll, est = self._reference(*args)
        else:
            if self.kernel is None:
                raise NotImplementedError(
                    "this sweep's callbacks have no CUDA kernel; only "
                    "models with a KernelModel (SIR, LGSS) run on the card"
                )
            ll, est = _build.launch_sweep(
                self.kernel, *args, d=self.d, mode=_MODE[self.mode],
                systematic=self.method == "systematic",
            )
        return ll, self._shape_est(est)

    def sweep_reference(self, seed_words, y, theta, num_particles,
                        max_particles=None, threshold=None):
        """The plain PyTorch sweep on any device (the kernel's twin)."""
        ll, est = self._reference(*self._prepare(
            seed_words, y, theta, num_particles, max_particles, threshold
        ))
        return ll, self._shape_est(est)

    def _positions(self, rng, lane_f, alive, alive_mask):
        u = rng.uniform()
        if self.method == "systematic":
            u = u[:, 0:1]
        pos = (lane_f + u) / alive
        return torch.where(alive_mask, pos, 1.0)

    def _reference(self, words, ys, theta, alive_v, thr_v, n):
        c = theta.shape[0]
        dev = theta.device
        rng = SweepRng(lane_keys(words, n))
        th = tuple(theta[:, j:j + 1].expand(c, n) for j in range(self.p))
        lane_f = torch.arange(n, dtype=torch.float32, device=dev)[None, :]
        alive = alive_v[:, None]
        thr = thr_v[:, None]
        alive_mask = lane_f < alive
        w_res = torch.where(alive_mask, 1.0 / alive, 0.0)

        cols = tuple(self.init_fn(rng, th))
        if len(cols) != self.d:
            raise ValueError("init_fn must return num_state_cols columns")
        loglike = torch.zeros((c, 1), dtype=torch.float32, device=dev)
        dead = torch.zeros((c, 1), dtype=torch.bool, device=dev)
        est = [torch.cat([tree_sum(w_res * x) for x in cols], dim=1)]
        for t in range(ys.shape[0]):
            y_t = (ys[t, 0] if self.d_y == 1
                   else tuple(ys[t, j] for j in range(self.d_y)))
            cols = tuple(self.transition_fn(rng, cols, th, t))
            lw = torch.where(alive_mask, self.log_weight_fn(cols, th, y_t),
                             _NEG)
            mx = torch.amax(lw, dim=1, keepdim=True)
            dead = dead | (mx < _DEGENERATE)
            shifted = torch.exp(lw - mx)
            ssum = tree_sum(shifted)
            w = shifted / ssum
            ess = 1.0 / tree_sum(w * w)
            loglike = loglike + mx + torch.log(ssum) - torch.log(alive)
            if self.mode == "never":
                est_w = w
            else:
                pos = self._positions(rng, lane_f, alive, alive_mask)
                res = select_cols_reference(cdf_ext(w, lane_f, alive), pos,
                                            cols)
                res = tuple(torch.where(alive_mask, r, 0.0) for r in res)
                if self.mode == "always":
                    cols, est_w = res, w_res
                else:
                    do = ess < thr
                    cols = tuple(torch.where(do, r, x)
                                 for r, x in zip(res, cols))
                    est_w = torch.where(do, w_res, w)
            live_f = 1.0 - dead.to(torch.float32)
            est.append(torch.cat([tree_sum(est_w * x) * live_f
                                  for x in cols], dim=1))
        ll = torch.where(dead, -math.inf, loglike)[:, 0]
        return ll, torch.stack(est, dim=1)


def build_sweep_op(
    num_state_cols: int,
    init_fn,
    transition_fn,
    log_weight_fn,
    num_params: int,
    aux_log_weight_fn=None,
    move_fn=None,
    resample_fn: str = "stratified",
    always_resample: bool = False,
    never_resample: bool = False,
    num_obs_cols: int = 1,
    obs_gaps=None,
    kernel: KernelModel | None = None,
) -> SweepOp:
    """Build the batched whole-sweep op (module docstring).

    Same argument checks as the JAX sweep builder (``sweep_builder.py:580-597``).
    APF (``aux_log_weight_fn``), RMPF (``move_fn``) and irregular
    ``obs_gaps`` are not ported yet (ROADMAP Queue 1, "APF and RMPF
    through the engine, then in K1").
    """
    if resample_fn not in ("stratified", "systematic"):
        raise ValueError(
            "the sweep builder resamples by inverse-CDF selection over "
            "sorted positions (stratified/systematic)"
        )
    if always_resample and never_resample:
        raise ValueError(
            "always_resample and never_resample are mutually exclusive"
        )
    if obs_gaps is not None:
        obs_gaps = tuple(int(g) for g in obs_gaps)
        if any(g < 1 for g in obs_gaps):
            raise ValueError("obs_gaps entries must be >= 1")
        if any(g != 1 for g in obs_gaps):
            raise NotImplementedError(
                "irregular obs_gaps are not ported yet (ROADMAP Queue 1, "
                "APF and RMPF through the engine, then in K1)"
            )
    if aux_log_weight_fn is not None or move_fn is not None:
        raise NotImplementedError(
            "the APF and RMPF sweep days are not ported yet (ROADMAP "
            "Queue 1, APF and RMPF through the engine, then in K1)"
        )
    mode = ("always" if always_resample
            else "never" if never_resample else "adaptive")
    return SweepOp(num_state_cols, init_fn, transition_fn, log_weight_fn,
                   num_params, resample_fn, mode, num_obs_cols, kernel)


def build_sweep_pf_impl(
    num_state_cols: int,
    init_fn,
    transition_fn,
    log_weight_fn,
    param_names,
    num_obs_cols: int = 1,
    obs_transform=None,
    kernel: KernelModel | None = None,
):
    """PMMH ``pf_impl`` factory over :func:`build_sweep_op` (BPF only).

    The factory takes the arguments of the JAX ``pf_impl`` hook and returns
    ``pf(seed_words [C, 2], theta [C, P], n=num_particles) -> (loglike,
    state_est)``, with ``theta`` in the sampler's parameter order; the
    callbacks see it in ``param_names`` order.
    """
    expected = tuple(param_names)

    def factory(y, num_particles, param_names, model_fns, obs_times,
                algorithm, resample_algorithm, resample_fn, carry_weights,
                max_particles=None):
        del model_fns
        if algorithm not in ("BPF", "APF", "RMPF"):
            raise ValueError(
                "the sweep builder supports BPF, APF or RMPF only"
            )
        if algorithm != "BPF":
            raise NotImplementedError(
                f"{algorithm} sweeps are not ported yet (ROADMAP Queue 1, "
                "APF and RMPF through the engine, then in K1)"
            )
        if obs_times is not None:
            raise NotImplementedError(
                "obs_times are not ported yet (ROADMAP Queue 1, APF and "
                "RMPF through the engine, then in K1)"
            )
        if carry_weights:
            raise ValueError(
                "the sweep builder implements the reference fresh-weight "
                "semantics (carry_weights=False)"
            )
        if resample_algorithm not in ("SIS", "SISR", "SISAR"):
            raise ValueError("resample_algorithm must be SIS, SISR or SISAR")
        names = list(param_names)
        if len(names) != len(expected) or sorted(names) != sorted(expected):
            raise ValueError(
                f"sweep built for parameters {expected}, got "
                f"{tuple(names)}"
            )
        perm = [names.index(q) for q in expected]
        op = build_sweep_op(
            num_state_cols, init_fn, transition_fn, log_weight_fn,
            len(expected), resample_fn=resample_fn,
            always_resample=resample_algorithm == "SISR",
            never_resample=resample_algorithm == "SIS",
            num_obs_cols=num_obs_cols, kernel=kernel,
        )
        ys = torch.as_tensor(y, dtype=torch.float32)
        if obs_transform is not None:
            ys = obs_transform(ys)
        on_device = {}

        def pf(seed_words, theta, n=num_particles):
            theta = torch.as_tensor(theta, dtype=torch.float32)
            if perm != list(range(len(perm))):
                theta = theta[:, perm]
            if theta.device not in on_device:
                on_device[theta.device] = ys.to(theta.device)
            return op(
                seed_words, on_device[theta.device], theta, n,
                max_particles=(max_particles if max_particles is not None
                               else n),
            )

        return pf

    return factory
