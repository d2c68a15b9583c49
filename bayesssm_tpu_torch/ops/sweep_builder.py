"""Whole-sweep particle filter: the batched plain version and its CUDA kernel.

Port of ``bayesssm_tpu/ops/sweep_builder.py`` (fresh weights,
``carry_weights=False``). One call runs all T days of a bootstrap,
auxiliary or resample-move filter for a batch of chains laid out as
``[C, N]`` tensors: on-chip-style counter RNG (``ops/rng.py``), masked
lanes (a chain's ``num_particles`` may be below the static lane bound
``max_particles``), max-shifted weights, ESS and the likelihood increment,
stratified or systematic positions, the Hillis-Steele CDF with a running
max, selection (``ops/merge_select.py``), adaptive (SISAR), forced (SISR)
or no (SIS) resampling, state estimates, and the degenerate-weight
``-inf`` contract.

Model callbacks (the JAX sweep builder's contract, batched): ``init_fn(rng,
theta)`` and ``transition_fn(rng, cols, theta, t)`` return tuples of
``[C, N]`` float32 columns, ``log_weight_fn(cols, theta, y_t)`` returns the
unmasked ``[C, N]`` log-density; ``theta`` is a tuple of ``[C, N]``
broadcasts of the per-chain parameters; ``rng`` is a
:class:`~bayesssm_tpu_torch.ops.rng.SweepRng` with one counter per chain.
Two optional callbacks select the other filters:

* ``aux_log_weight_fn(cols, theta, y_t)`` — the APF day: the masked aux
  log-weights select ancestors (a forced resample with its own position
  draw), the ancestors' aux log-weights are recomputed from the selected
  state (selection copies are exact, so this equals a gather), the state
  takes a second transition (quirk Q2), and the day's log-weights are
  ``log_weight - aux_anc``;
* ``move_fn(rng, cols, theta, y_t)`` — the RMPF day: after the day's
  selection the move rejuvenates the state; masked lanes keep theirs.

``pack_fn(cols)`` / ``unpack_fn(packed)`` (given together) route fewer
columns through selection, as the JAX builder's do: selection moves
``pack_fn(cols)``, then ``unpack_fn`` restores the state and masked lanes
are zeroed again. Copies are exact, so packing changes no result when
``unpack_fn(pack_fn(cols))`` is exact.

``obs_gaps`` (one transition count per observation) turns the day's
transition into a loop of ``gaps[t]`` transitions at the absolute times
``times[t] - gaps[t] + s``, ``times = cumsum(gaps)``; the APF's second
transition takes ``times[t] - 1``.

Two implementations stand behind one op:

* :meth:`SweepOp.sweep_reference` — a Python loop over T on ``[C, N]``
  tensors that runs the callbacks. Sums over particles are a fixed
  pairwise tree (:func:`tree_sum`), the order of the kernel's shared-memory
  reduction, so the kernel can be held to it chain by chain.
* the CUDA kernel ``csrc/sweep.cuh`` (one thread block per chain) with a
  model functor: for a :class:`KernelModel` named by the model (SIR, LGSS,
  LGSS with two observation columns, the sinusoidal model), its
  hand-written functor in ``csrc/models.cuh``; for any other callbacks, a
  functor generated from them (``ops/sweep_codegen.py``: traced once per
  op at its first CUDA call, compiled by ``nvcc`` once per distinct
  model, launches counted under ``bssm_sweep_generated``).

Calling the op routes by device: CPU tensors run the plain version, CUDA
tensors launch the kernel. A callback's own loop runs through
``rng.event_loop`` (``ops/rng.py``), which traces: the plain sweep runs it
over ``[C, N]`` masked, K1 lane by lane. Callbacks the tracer cannot take
(indexing, reductions, Python control flow on values, the
counter-threading ``rng`` methods, a draw from ``rng`` inside a loop, a
loop inside a loop) raise ``ValueError`` naming the operation on CUDA
tensors; the plain sweep on CPU tensors runs the first four as before.

A call opens the spans ``prepare`` (its checks and copies) and, on a card,
``launch`` (``_build.launch_sweep``); the first CUDA call of an op with no
hand-written functor traces and emits its functor inside ``codegen``
(``utils/timing.py``).
"""

from __future__ import annotations

import math
import threading
from typing import NamedTuple

import numpy as np
import torch

from bayesssm_tpu_torch.ops import _build, sweep_codegen
from bayesssm_tpu_torch.ops.merge_select import select_cols_reference
from bayesssm_tpu_torch.ops.rng import SweepRng, lane_keys
from bayesssm_tpu_torch.utils.timing import DeviceTally, host_copy, span

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
_ALGORITHM = {"BPF": 0, "APF": 1, "RMPF": 2}


class KernelModel(NamedTuple):
    """The CUDA functor that runs a model's callbacks in the kernel:
    ``entry`` is the C entry point (``bssm_sweep_sir``, ``bssm_sweep_lgss``,
    ``bssm_sweep_lgss_mv``, ``bssm_sweep_sinusoidal``) and ``consts`` its
    model constants, in the C signature's order. A functor generated from
    traced callbacks has ``source`` (its C++), no constants, and the entry
    ``_build.generated_entry(source)``; its launches take the op's device
    tally, which a callback's ``rng.event_loop`` adds into."""

    entry: str
    consts: tuple = ()
    source: str | None = None


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
                 kernel, aux_log_weight_fn=None, move_fn=None, gaps=None,
                 pack_fn=None, unpack_fn=None):
        self.d = int(num_state_cols)
        self.p = int(num_params)
        self.d_y = int(num_obs_cols)
        self.init_fn = init_fn
        self.transition_fn = transition_fn
        self.log_weight_fn = log_weight_fn
        self.aux_log_weight_fn = aux_log_weight_fn
        self.move_fn = move_fn
        self.pack_fn = pack_fn
        self.unpack_fn = unpack_fn
        self.method = method
        self.mode = mode
        self.kernel = kernel
        self.gaps = gaps
        self.times = (None if gaps is None
                      else tuple(int(v) for v in np.cumsum(gaps)))
        self._gap_tables = {}  # device -> int32 [2, T] (gaps, times)
        self.algorithm = ("APF" if aux_log_weight_fn is not None
                          else "RMPF" if move_fn is not None else "BPF")
        self._generated = None  # the traced functor, made at first use
        self._tallies = {}  # (device, thread) -> its DeviceTally

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
        host_copy(y, dev)
        ys = torch.as_tensor(y, dtype=torch.float32, device=dev)
        if self.d_y == 1:
            ys = ys.reshape(-1, 1)
        elif ys.ndim != 2 or ys.shape[1] != self.d_y:
            raise ValueError(
                f"y must be [T, {self.d_y}] for num_obs_cols={self.d_y} "
                f"(got shape {tuple(ys.shape)})"
            )
        if self.gaps is not None and len(self.gaps) != ys.shape[0]:
            raise ValueError(
                f"obs_gaps has {len(self.gaps)} entries but y has "
                f"{ys.shape[0]} observations"
            )
        host_copy(seed_words, dev)
        words = torch.as_tensor(seed_words, dtype=torch.int64, device=dev)
        if words.shape != (c, 2):
            raise ValueError(
                f"seed_words must be [C, 2] = [{c}, 2] "
                f"(got {tuple(words.shape)})"
            )
        host_copy(num_particles, dev)
        alive = torch.as_tensor(num_particles, dtype=torch.float32,
                                device=dev).expand(c).contiguous()
        if threshold is not None:
            host_copy(threshold, dev)
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
        with span("prepare"):
            args = self._prepare(seed_words, y, theta, num_particles,
                                 max_particles, threshold)
        if args[2].device.type == "cpu":
            ll, est = self._reference(*args)
        else:
            kernel = self.kernel or self.generated_kernel()
            with span("launch"):
                ll, est = _build.launch_sweep(
                    kernel, *args, d=self.d, mode=_MODE[self.mode],
                    systematic=self.method == "systematic",
                    algorithm=_ALGORITHM[self.algorithm],
                    gap_table=self._gap_table(args[2].device),
                    transitions=None if self.times is None
                    else self.times[-1],
                    tally=None if kernel.source is None
                    else self._tally(args[2].device),
                )
        return ll, self._shape_est(est)

    def trace(self) -> sweep_codegen.TracedModel:
        """The callbacks traced into the IR of ``ops/sweep_codegen.py``
        (raises ``ValueError`` naming what does not trace)."""
        return sweep_codegen.trace_model(
            self.d, self.p, self.d_y, self.init_fn, self.transition_fn,
            self.log_weight_fn, self.aux_log_weight_fn, self.move_fn,
            self.pack_fn, self.unpack_fn)

    def generated_kernel(self) -> KernelModel:
        """The functor generated from the callbacks, traced once per op;
        ``nvcc`` runs at its first launch."""
        if self._generated is None:
            with span("codegen"):
                source = sweep_codegen.emit_functor(self.trace())
            self._generated = KernelModel(_build.generated_entry(source),
                                          (), source)
        return self._generated

    def _tally(self, dev):
        """The ``[2]`` int64 tally ``sweep.loop_iters``,
        ``sweep.loop_slots`` that the calling thread's launches of the
        generated functor on ``dev`` add into, made there once, fed
        (``utils/timing.py::DeviceTally``)."""
        key = (dev, threading.get_ident())
        if key not in self._tallies:
            self._tallies[key] = DeviceTally(
                ("sweep.loop_iters", "sweep.loop_slots"), dev)
        return self._tallies[key].feed()

    def _gap_table(self, dev):
        """The kernel's ``[2, T]`` int32 gaps and times on ``dev``, copied
        there once."""
        if self.gaps is None:
            return None
        if dev not in self._gap_tables:
            self._gap_tables[dev] = torch.tensor(
                [self.gaps, self.times], dtype=torch.int32, device=dev)
        return self._gap_tables[dev]

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

        def masked(lw):
            return torch.where(alive_mask, lw, _NEG)

        def select(w, pos, cols):
            route = cols if self.pack_fn is None else self.pack_fn(cols)
            res = select_cols_reference(cdf_ext(w, lane_f, alive), pos,
                                        route)
            res = tuple(torch.where(alive_mask, r, 0.0) for r in res)
            if self.unpack_fn is not None:
                res = tuple(torch.where(alive_mask, o, 0.0)
                            for o in self.unpack_fn(res))
            return res

        cols = tuple(self.init_fn(rng, th))
        if len(cols) != self.d:
            raise ValueError("init_fn must return num_state_cols columns")
        loglike = torch.zeros((c, 1), dtype=torch.float32, device=dev)
        dead = torch.zeros((c, 1), dtype=torch.bool, device=dev)
        est = [torch.cat([tree_sum(w_res * x) for x in cols], dim=1)]
        for t in range(ys.shape[0]):
            y_t = (ys[t, 0] if self.d_y == 1
                   else tuple(ys[t, j] for j in range(self.d_y)))
            if self.gaps is None:
                cols = tuple(self.transition_fn(rng, cols, th, t))
            else:
                gap, t_end = self.gaps[t], self.times[t]
                for s in range(gap):
                    cols = tuple(self.transition_fn(rng, cols, th,
                                                    t_end - gap + s))
            if self.aux_log_weight_fn is not None:
                aux_lw = masked(self.aux_log_weight_fn(cols, th, y_t))
                mxa = torch.amax(aux_lw, dim=1, keepdim=True)
                dead = dead | (mxa < _DEGENERATE)
                sha = torch.exp(aux_lw - mxa)
                pos_a = self._positions(rng, lane_f, alive, alive_mask)
                cols = select(sha / tree_sum(sha), pos_a, cols)
                aux_anc = torch.maximum(
                    masked(self.aux_log_weight_fn(cols, th, y_t)),
                    torch.tensor(_NEG, device=dev))
                t_q2 = t if self.gaps is None else self.times[t] - 1
                cols = tuple(self.transition_fn(rng, cols, th, t_q2))
                lw = masked(masked(self.log_weight_fn(cols, th, y_t))
                            - aux_anc)
            else:
                lw = masked(self.log_weight_fn(cols, th, y_t))
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
                res = select(w, pos, cols)
                if self.mode == "always":
                    cols, est_w = res, w_res
                else:
                    do = ess < thr
                    cols = tuple(torch.where(do, r, x)
                                 for r, x in zip(res, cols))
                    est_w = torch.where(do, w_res, w)
            if self.move_fn is not None:
                moved = self.move_fn(rng, cols, th, y_t)
                cols = tuple(torch.where(alive_mask, m, x)
                             for m, x in zip(moved, cols))
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
    interpret: bool = False,
    num_obs_cols: int = 1,
    pack_fn=None,
    unpack_fn=None,
    num_packed_cols: int = 1,
    obs_gaps=None,
    kernel: KernelModel | None = None,
) -> SweepOp:
    """Build the batched whole-sweep op (module docstring).

    Takes every argument of the JAX ``build_sweep_op``, with its checks
    (``sweep_builder.py:580-597``). ``aux_log_weight_fn`` makes every day
    an APF day and ``move_fn`` an RMPF day (give at most one); ``obs_gaps``
    of all ones is the contiguous grid. ``interpret`` is accepted and
    ignored (the device picks the implementation), and so is
    ``num_packed_cols`` (the JAX kernel's VMEM budget; the count is
    ``pack_fn``'s). ``kernel`` names a hand-written functor; without it the
    card runs a functor generated from the callbacks.
    """
    del interpret, num_packed_cols
    if resample_fn not in ("stratified", "systematic"):
        raise ValueError(
            "the sweep builder resamples by inverse-CDF selection over "
            "sorted positions (stratified/systematic)"
        )
    if (pack_fn is None) != (unpack_fn is None):
        raise ValueError("pack_fn and unpack_fn must be given together")
    if always_resample and never_resample:
        raise ValueError(
            "always_resample and never_resample are mutually exclusive"
        )
    if aux_log_weight_fn is not None and move_fn is not None:
        raise ValueError(
            "aux_log_weight_fn (APF) and move_fn (RMPF) are two filters; "
            "give one of them"
        )
    if obs_gaps is not None:
        obs_gaps = tuple(int(g) for g in obs_gaps)
        if any(g < 1 for g in obs_gaps):
            raise ValueError("obs_gaps entries must be >= 1")
        if all(g == 1 for g in obs_gaps):
            obs_gaps = None  # contiguous: no gap loop
    mode = ("always" if always_resample
            else "never" if never_resample else "adaptive")
    return SweepOp(num_state_cols, init_fn, transition_fn, log_weight_fn,
                   num_params, resample_fn, mode, num_obs_cols, kernel,
                   aux_log_weight_fn=aux_log_weight_fn, move_fn=move_fn,
                   gaps=obs_gaps, pack_fn=pack_fn, unpack_fn=unpack_fn)


def build_sweep_pf_impl(
    num_state_cols: int,
    init_fn,
    transition_fn,
    log_weight_fn,
    param_names,
    aux_log_weight_fn=None,
    move_fn=None,
    interpret: bool = False,
    num_obs_cols: int = 1,
    pack_fn=None,
    unpack_fn=None,
    num_packed_cols: int = 1,
    obs_transform=None,
    kernel: KernelModel | None = None,
):
    """PMMH ``pf_impl`` factory over :func:`build_sweep_op`: BPF, APF when
    ``aux_log_weight_fn`` is given, RMPF when ``move_fn`` is given (RMPF
    forces SISR and never SIS), and ``obs_times`` as gap counts. Takes
    every argument of the JAX ``build_sweep_pf_impl`` (``interpret`` and
    ``num_packed_cols`` are ignored, as in :func:`build_sweep_op`).

    The factory takes the arguments of the JAX ``pf_impl`` hook and returns
    ``pf(seed_words [C, 2], theta [C, P], n=num_particles) -> (loglike,
    state_est)``, with ``theta`` in the sampler's parameter order; the
    callbacks see it in ``param_names`` order.
    """
    del interpret, num_packed_cols
    if (pack_fn is None) != (unpack_fn is None):
        raise ValueError("pack_fn and unpack_fn must be given together")
    expected = tuple(param_names)

    def factory(y, num_particles, param_names, model_fns, obs_times,
                algorithm, resample_algorithm, resample_fn, carry_weights,
                max_particles=None):
        from bayesssm_tpu_torch.filters.core import obs_times_to_gaps

        del model_fns
        if algorithm not in ("BPF", "APF", "RMPF"):
            raise ValueError(
                "the sweep builder supports BPF, APF or RMPF only"
            )
        if algorithm == "APF" and aux_log_weight_fn is None:
            raise ValueError("APF requires the builder's aux_log_weight_fn")
        if algorithm == "RMPF" and move_fn is None:
            raise ValueError("RMPF requires the builder's move_fn")
        ys = torch.as_tensor(y, dtype=torch.float32)
        obs_gaps = (None if obs_times is None
                    else obs_times_to_gaps(obs_times, ys.shape[0]))
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
            len(expected),
            aux_log_weight_fn=aux_log_weight_fn if algorithm == "APF"
            else None,
            move_fn=move_fn if algorithm == "RMPF" else None,
            resample_fn=resample_fn,
            always_resample=(algorithm == "RMPF"
                             or resample_algorithm == "SISR"),
            never_resample=(resample_algorithm == "SIS"
                            and algorithm != "RMPF"),
            num_obs_cols=num_obs_cols, pack_fn=pack_fn, unpack_fn=unpack_fn,
            obs_gaps=obs_gaps, kernel=kernel,
        )
        if obs_transform is not None:
            ys = obs_transform(ys)
        on_device = {}

        def pf(seed_words, theta, n=num_particles):
            with span("filter"):
                theta = torch.as_tensor(theta, dtype=torch.float32)
                if perm != list(range(len(perm))):
                    theta = theta[:, perm]
                if theta.device not in on_device:
                    host_copy(ys, theta.device)
                    on_device[theta.device] = ys.to(theta.device)
                return op(
                    seed_words, on_device[theta.device], theta, n,
                    max_particles=(max_particles if max_particles is not None
                                   else n),
                )

        return pf

    return factory
