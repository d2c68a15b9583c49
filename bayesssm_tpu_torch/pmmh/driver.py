"""Particle marginal Metropolis-Hastings driver (port of
``bayesssm_tpu/pmmh/driver.py``).

Chains are the leading axis of every tensor: ``theta [C, P]``, proposal
factors ``[C, P, P]``, particle counts ``[C]`` and two uint32 seed words
per chain ``[C, 2]`` (int64 tensors holding uint32 values). One MH step is
one batched filter call over all chains. :func:`pmmh` runs the two phases
of the JAX driver with one host sync between them:

  phase 1 (tuning)   — every chain's pilot RWM chain and pilot variance
                       run, as one batched pilot (``pmmh/tuning.py``);
  host sync          — the pilot means, covariances and particle counts
                       come to the host; the delta-method proposal factors
                       (:func:`chain_state_from_pilot`) and the lane bound
                       ``_particle_lane_bound(max target_n)`` are computed;
  phase 2 (sampling) — :func:`sample_chains`, in chunks of at most 256 MH
                       steps whose samples go to the host as each chunk
                       finishes.

**The RNG contract of** :func:`pmmh`. The root key is
``threefry.key(seed)`` (``jax.random.key(seed)``'s words), or a ``[2]``
key-word array given as ``seed``. Chain ``c``'s key is
``fold_in(root, c)``. Phase 1 threads the JAX key schedule exactly
(``pmmh/tuning.py``), so each chain's pilot agrees with an un-vmapped JAX
``run_pilot_chain`` on the same key. Phase 2 splits the chain key once,
``key, k0 = split(key)``: the initial filter evaluation at the pilot mean
takes ``k0``, as the JAX driver's ``_init_eval`` does, and ``key``'s words
become the chain words of the MH stream below. Each filter is called with
the words of its key: the engine takes them as threefry keys, the sweep
as its two seed words. So phase 1 and the first log-likelihood agree with
the JAX driver per key, and the MH steps agree in distribution.

The MH steps draw from a device-side lowbias32 stream (``ops/rng.py``),
never a host loop over chains. For chain words ``(w0, w1)``, MH step ``s``
(``s = 0`` is the initial filter evaluation of :func:`sample_chains`
when its state carries no log-likelihood) and word index ``j``:

    k_s     = hash(w0 ^ hash(w1 + s * 0x85EBCA6B))
    word_j  = hash(k_s ^ hash((j + 1) * 0x9E3779B9))

Words 0 and 1 seed the step's filter sweep; words ``2 + 2q`` and
``3 + 2q`` give the ``q``-th proposal normal by Box-Muller from the
uniforms ``(word >> 8) * 2**-24``; word ``2 + 2P`` gives the accept
uniform. Chain words derive from a root seed's two words ``(r0, r1)`` and
the chain id ``i`` as ``w0 = hash(r0 ^ hash(r1 + i * 0x9E3779B9))``,
``w1 = hash(w0 ^ ((i + 1) * 0x85EBCA6B))`` (:func:`init_chain_state`).
The JAX PMMH driver's threefry keys give other numbers, so the two
samplers agree in distribution; the tests hand both the same normals,
uniforms and filter words. A step's words depend only on the chain words
and the step's index, so how the steps are cut into chunks changes no
sample.

**CUDA graphs.** Every MH step of :func:`sample_chains` is one
:class:`_MHStep`: two halves around the filter, ``propose`` (words,
draws, proposal, prior) and ``accept`` (:func:`mh_accept`, the update).
The filter stays a plain call on fresh copies of the proposal and its
words: a filter is any callable, and the benchmark's and users' filters
run Python on every call, time it, or keep what they are given. On a
CUDA device the halves (~225 small kernels) are captured as CUDA graphs
once per key (:func:`_graph_key`: device, shapes, the prior callables,
transforms and Jacobian convention), after the key's first step in the
process, and replayed across calls; elsewhere, for a key whose capture
raised, and in calls with state estimates or fewer than 2 MH steps, they
are called directly. Replayed kernels are the called ones: the same bits.

**Meshes.** ``pmmh(mesh=...)`` runs on every rank of a ``(chains,
particles)`` mesh (``parallel/mesh.py``), each rank on its own block of
chains, as the JAX driver runs its phases inside ``shard_map``: rank
``c`` of the chains axis takes chains ``c * C / cs .. (c + 1) * C / cs -
1``. Chain keys are ``fold_in(root, chain id)`` and the MH stream words
follow the chain keys, so a chain's draws do not depend on the rank that
runs it, and a chains-only mesh gives the no-mesh run's samples bit for
bit. The ranks of one particle group run the same chains with the
particle-sharded engine (``particle_axis``): their log-likelihoods, and
so every decision and trip count of the sampler, are equal. Collectives
over the chains axis run only where the outputs come together: the
pilot's results before phase 2 (the lane bound is the global one), the
samples at the end, every checkpoint snapshot and the timings. Every
rank returns the same full ``PMMHOutput``.
"""

from __future__ import annotations

import collections
import dataclasses
import pathlib
import threading
import warnings
from typing import Optional

import numpy as np
import torch

from bayesssm_tpu_torch.diagnostics.ess import ess_matrix
from bayesssm_tpu_torch.diagnostics.rhat import rhat_matrix
from bayesssm_tpu_torch.ops import threefry
from bayesssm_tpu_torch.ops.rng import MASK32, box_muller, hash32, mul32
from bayesssm_tpu_torch.output import PMMHOutput
from bayesssm_tpu_torch.pmmh.priors import sum_log_priors
from bayesssm_tpu_torch.pmmh.transforms import (
    back_transform_params,
    resolve_transforms,
    transform_params,
)
from bayesssm_tpu_torch.pmmh.tuning import (
    TuneControl,
    _make_pf_loglike,
    default_tune_control,
    mh_accept,
    run_pilot_chain,
)
from bayesssm_tpu_torch.utils.checkpoint import (
    FORMAT_VERSION,
    load_checkpoint,
    save_checkpoint,
)
from bayesssm_tpu_torch.utils.signatures import check_params_match
from bayesssm_tpu_torch.utils.timing import (
    PhaseTimer,
    count,
    host_copy,
    host_sync,
    span,
    spanned,
)

__all__ = [
    "pmmh",
    "ChainState",
    "chain_state_from_numpy",
    "chain_state_from_pilot",
    "init_chain_state",
    "chain_words",
    "step_words",
    "mh_propose",
    "mh_accept",
    "mh_step",
    "sample_chains",
    "SampleResult",
]

_GOLDEN = 0x9E3779B9
_STEP_MUL = 0x85EBCA6B
_INV24 = 1.0 / (1 << 24)
# Longest run of MH steps whose samples stay on the device before they go
# to the host.
SAMPLE_CHUNK = 256

_ALGO_BY_NAME = {
    "bootstrap_filter": "BPF",
    "auxiliary_filter": "APF",
    "resample_move_filter": "RMPF",
    "BPF": "BPF",
    "APF": "APF",
    "RMPF": "RMPF",
}


def _resolve_algorithm(pf_wrapper) -> str:
    """Accept a filter callable, its name, or an algorithm code."""
    if pf_wrapper is None:
        return "BPF"
    name = pf_wrapper if isinstance(pf_wrapper, str) else getattr(
        pf_wrapper, "__name__", str(pf_wrapper)
    )
    if name not in _ALGO_BY_NAME:
        raise ValueError(
            "pf_wrapper must be bootstrap_filter, auxiliary_filter, "
            "resample_move_filter (or 'BPF'/'APF'/'RMPF')"
        )
    return _ALGO_BY_NAME[name]


def _stack_init_params(pilot_init_params, num_chains, param_names):
    """Per-chain initial parameters as ``[chains, P]`` float32: one entry
    per chain, all with the same names; a single dict is broadcast."""
    if isinstance(pilot_init_params, dict):
        pilot_init_params = [pilot_init_params] * num_chains
    if len(pilot_init_params) != num_chains:
        raise ValueError(
            "pilot_init_params must have one entry per chain "
            f"(got {len(pilot_init_params)}, num_chains={num_chains})"
        )
    names0 = set(pilot_init_params[0])
    for entry in pilot_init_params[1:]:
        if set(entry) != names0:
            raise ValueError(
                "pilot_init_params entries must share the same parameter names"
            )
    if len(names0) == 0:
        raise ValueError("pilot_init_params must contain at least one parameter.")
    missing = [p for p in param_names if p not in names0]
    if missing:
        raise ValueError(
            "Parameters in functions do not match the names in pilot_init_params"
        )
    return np.array(
        [[float(entry[p]) for p in param_names] for entry in pilot_init_params],
        dtype=np.float32,
    )


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
    host_sync(torch.device(device), 4)
    return ChainState(
        theta=torch.as_tensor(theta, device=device),
        factors=torch.as_tensor(factors, device=device),
        n=torch.as_tensor(n, device=device),
        words=torch.as_tensor(words, device=device),
    )


def _delta_method_factors(theta_mean, theta_cov, transforms) -> np.ndarray:
    """``[C, P, P]`` proposal factors on the transformed scale: the
    untransformed pilot covariance through the delta method, ``J cov J^T``
    with ``J = diag(dz/dtheta)`` at the pilot mean (Q6), factored by
    :func:`_proposal_factor`."""
    theta_mean = np.asarray(theta_mean, np.float64)
    theta_cov = np.asarray(theta_cov, np.float64)
    c, p = theta_mean.shape
    factors = np.zeros((c, p, p), dtype=np.float32)
    for k in range(c):
        scale = np.ones(p)
        for j, t in enumerate(transforms):
            if t == "log":
                scale[j] = 1.0 / theta_mean[k, j]
            elif t == "logit":
                scale[j] = 1.0 / (theta_mean[k, j] * (1.0 - theta_mean[k, j]))
        cov_z = (scale[:, None] * theta_cov[k]) * scale[None, :]
        factors[k] = _proposal_factor(cov_z)
    return factors


def chain_state_from_pilot(theta_mean, theta_cov, target_n, transforms,
                           key_words, device) -> ChainState:
    """The phase-2 sampler state from pilot outputs (the port's or the JAX
    ``run_pilot_chain``'s, as arrays): ``theta_mean [C, P]`` (the chains'
    starting values), ``theta_cov [C, P, P]`` (untransformed), ``target_n
    [C]``, the resolved ``transforms`` and the chains' MH stream words
    ``key_words [C, 2]``. The proposal factors are the delta-method
    factors of the JAX driver (``driver.py:446-458``)."""
    factors = _delta_method_factors(theta_mean, theta_cov, transforms)
    return chain_state_from_numpy(np.asarray(theta_mean, np.float32),
                                  factors, target_n, key_words, device)


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


def step_words(words: torch.Tensor, step, count: int) -> torch.Tensor:
    """``[C, count]`` stream words of MH step ``step`` (module docstring):
    an int, or a 0-d int64 tensor on ``words``' device (a CUDA graph's step
    counter), which gives the same bits and copies nothing from the
    host."""
    if isinstance(step, torch.Tensor):
        s_mix = mul32(step, _STEP_MUL)
    else:
        s_mix = mul32(torch.tensor(step, dtype=torch.int64), _STEP_MUL).item()
    k = hash32(words[:, 0] ^ hash32((words[:, 1] + s_mix) & MASK32))
    j = torch.arange(1, count + 1, dtype=torch.int64, device=words.device)
    return hash32(k[:, None] ^ hash32(mul32(j, _GOLDEN))[None, :])


def _uniform(word: torch.Tensor) -> torch.Tensor:
    return (word >> 8).to(torch.float32) * _INV24


def mh_propose(theta, factor, eps, prior_fns, transforms):
    """The first half of :func:`mh_step`: ``(theta_prop [C, P], lp_prop
    [C])``, the random-walk proposal on the transformed scale and its log
    prior."""
    z = transform_params(theta, transforms)
    zp = z + (factor * eps[:, None, :]).sum(dim=-1)
    theta_prop = back_transform_params(zp, transforms)
    return theta_prop, sum_log_priors(theta_prop, prior_fns)


def mh_step(pf, theta, ll, factor, n_chain, eps, u_acc, seed_words,
            prior_fns, transforms, jacobian_convention="consistent",
            se=None):
    """One random-walk MH step for every chain (``driver.py:484-518``):
    :func:`mh_propose`, the filter, :func:`mh_accept`.

    ``eps [C, P]`` standard normals, ``u_acc [C]`` uniforms and
    ``seed_words [C, 2]`` for the filter are given. ``se`` (state
    estimates) is carried only when given. Returns ``(theta, ll, se,
    accept)``.
    """
    theta_prop, lp_prop = mh_propose(theta, factor, eps, prior_fns,
                                     transforms)
    ll_prop, se_prop = pf(seed_words, theta_prop, n_chain)
    theta, ll, accept = mh_accept(theta, ll, theta_prop, lp_prop, ll_prop,
                                  u_acc, prior_fns, transforms,
                                  jacobian_convention)
    if se is not None:
        keep = accept.reshape((-1,) + (1,) * (se.ndim - 1))
        se = torch.where(keep, se_prop, se)
    return theta, ll, se, accept


# The MH steps (:class:`_MHStep`) of the keys (:func:`_graph_key`) used
# last, the least recently used dropped first beyond MH_GRAPH_KEYS keys.
MH_GRAPH_KEYS = 8
_STEPS: collections.OrderedDict = collections.OrderedDict()
_STEPS_LOCK = threading.Lock()


def _graph_key(theta, ll, prior_fns, transforms, jacobian_convention):
    """What the two graphs bake in: the device, the shapes and dtypes of
    the state, the prior callables by identity, the transforms and the
    Jacobian convention."""
    return (theta.device, tuple(theta.shape), theta.dtype, tuple(ll.shape),
            ll.dtype, tuple(map(id, prior_fns)), tuple(transforms),
            jacobian_convention)


def _capture(propose, accept, dev):
    """``((graph, proposal), (graph, mask))``: ``propose()`` and then
    ``accept(proposal)`` captured into CUDA graphs on a side stream of
    ``dev`` that share one memory pool; None on a device without CUDA
    graphs. Raises what the capture raises. The host waits once, for the
    device's queue, first."""
    if dev.type != "cuda":
        return None
    with span("mh_capture"):
        host_sync(dev)
        torch.cuda.synchronize(dev)
        stream, pool, args, captured = torch.cuda.Stream(dev), (), (), []
        for fn in (propose, accept):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(stream):
                graph.capture_begin(*pool, capture_error_mode="thread_local")
                try:
                    out = fn(*args)
                finally:
                    graph.capture_end()
            captured.append((graph, out))
            pool, args = (graph.pool(),), (out,)
    return captured


class _MHStep:
    """One key's MH step (module docstring): the state a call's steps
    update, and the two halves around the filter, replayed as CUDA graphs
    where they were captured and called directly elsewhere.

    ``propose()`` draws the step's words from the step counter on the
    device, proposes, prices the proposal (``proposal``) and advances the
    counter; ``accept(ll_prop)`` decides, updates ``theta``, ``ll`` and
    ``accepts`` and leaves the decisions in ``mask``. A direct half binds
    what it computes; a replay writes it into the tensors the capture
    bound (``bound``), which :meth:`load` copies a call's state into. The
    halves are captured after the key's first direct step whose filter
    output has the key's dtype and shape (``ll_like``). ``graphs`` is None
    until then, and empty for good where the device has none, where the
    capture raised, and for a step outside the cache.
    """

    def __init__(self, ll, prior_fns, transforms, convention, graphs=None):
        self.ll_like = (ll.dtype, ll.shape)
        self.prior_fns = tuple(prior_fns)   # held: the key has their ids
        self.transforms, self.convention = transforms, convention
        self.graphs = graphs
        self.busy = False       # a call holds the step

    @classmethod
    def claim(cls, theta, ll, mh_steps, prior_fns, transforms, convention,
              latent) -> "_MHStep":
        """The key's cached step, held for one call; an uncached one,
        which never captures, for a call with state estimates or fewer
        than 2 MH steps, or when another call holds the key's."""
        if latent or mh_steps < 2:
            return cls(ll, prior_fns, transforms, convention, ())
        key = _graph_key(theta, ll, prior_fns, transforms, convention)
        with _STEPS_LOCK:
            step = _STEPS.get(key)
            if step is None:
                step = _STEPS[key] = cls(ll, prior_fns, transforms,
                                         convention)
                while len(_STEPS) > MH_GRAPH_KEYS:
                    _STEPS.popitem(last=False)
            _STEPS.move_to_end(key)
            if step.busy:
                return cls(ll, prior_fns, transforms, convention, ())
            step.busy = True
        return step

    def load(self, state: ChainState, theta, ll) -> None:
        """Start a call from ``theta`` and ``ll``, its MH steps counted
        from ``state.step + 1``."""
        self._bind(dict(
            theta=theta, ll=ll, factors=state.factors, words=state.words,
            accepts=torch.zeros_like(theta[:, 0], dtype=torch.int64),
            step=torch.full((), state.step + 1, device=theta.device)))

    def _bind(self, live) -> None:
        """Bind ``live``, or copy it into the tensors the graphs hold."""
        self.replaying = bool(self.graphs)
        if self.replaying:
            vars(self).update(self.bound)
            for name, value in live.items():
                getattr(self, name).copy_(value)
        else:
            vars(self).update(live)

    def _propose(self):
        # The step's words (module docstring): the filter's, the
        # proposal's normals, the accept uniform.
        p = self.theta.shape[1]
        w = step_words(self.words, self.step, 3 + 2 * p)
        u = _uniform(w[:, 2:2 + 2 * p])
        theta_prop, lp_prop = mh_propose(
            self.theta, self.factors, box_muller(u[:, 0::2], u[:, 1::2]),
            self.prior_fns, self.transforms)
        self.step.add_(1)
        return w[:, :2], theta_prop, lp_prop, _uniform(w[:, 2 + 2 * p])

    def _accept(self, proposal):
        _, theta_prop, lp_prop, u_acc = proposal
        theta, ll, mask = mh_accept(self.theta, self.ll, theta_prop, lp_prop,
                                    self.ll_prop, u_acc, self.prior_fns,
                                    self.transforms, self.convention)
        self.accepts.add_(mask)
        return theta, ll, mask

    def _accept_in_place(self, proposal):
        theta, ll, mask = self._accept(proposal)
        self.theta.copy_(theta)
        self.ll.copy_(ll)
        return mask

    def propose(self):
        """The step's proposal: ``(filter words [C, 2], theta_prop [C,
        P])``."""
        if self.replaying:
            self.graphs[0].replay()
        else:
            self.proposal = self._propose()
        return self.proposal[:2]

    def accept(self, ll_prop) -> None:
        """Decide on the proposal given its log-likelihoods ``ll_prop``."""
        fits = (ll_prop.dtype, ll_prop.shape) == self.ll_like
        if self.replaying and fits:
            self.ll_prop.copy_(ll_prop)
            self.graphs[1].replay()
            count("mh_graph.step")
            return
        # A filter output the accept graph cannot take as it is, such as
        # float64 log-likelihoods, ends the replays for the rest of the
        # call: the state is bound from here on, in the output's dtype.
        self.replaying = False
        self.ll_prop = ll_prop
        self.theta, self.ll, self.mask = self._accept(self.proposal)
        if self.graphs is None and fits:
            self._capture_halves()

    def _capture_halves(self) -> None:
        """Capture both halves on tensors of their own, then go on from
        the live state: replayed if the capture took, directly if not."""
        live = {name: getattr(self, name) for name in
                ("theta", "ll", "accepts", "factors", "words", "step")}
        bound = {name: torch.empty_like(t) for name, t in live.items()}
        bound["ll_prop"] = torch.empty_like(self.ll)
        vars(self).update(bound)
        try:
            graphs = _capture(self._propose, self._accept_in_place,
                              self.theta.device)
        except RuntimeError:
            # Work a graph cannot hold, such as a prior that copies a
            # number from the host: the direct halves do the same work.
            count("mh_graph.fallback")
            graphs = None
        if graphs:
            count("mh_graph.capture")
            (propose, proposal), (accept, mask) = graphs
            self.bound = dict(bound, proposal=proposal, mask=mask)
            self.graphs = (propose, accept)
        else:
            self.graphs = ()
        self._bind(live)


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
    accepted: np.ndarray           # [C] int64 accepted MH steps


@spanned("sample_chains")
def sample_chains(pf, state: ChainState, m: int, burn_in: int, prior_fns,
                  transforms, jacobian_convention: str = "consistent",
                  return_latent_state_est: bool = False) -> SampleResult:
    """Run ``m`` samples per chain: the initial filter evaluation (sample
    0, ``_init_eval``) and ``m - 1`` MH steps.

    ``pf(seed_words, theta, n) -> (loglike, state_est)`` is a batched
    filter such as ``sir_sweep_pf_impl(...)(...)``. Burn-in samples never
    enter the output buffer; the kept samples stay on the device and are
    copied to the host once, at the end. Every MH step is the key's
    :class:`_MHStep` around ``pf``: its halves replayed as CUDA graphs
    where they were captured and called directly elsewhere (module
    docstring), with the same bits.
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

    def record(s, theta):
        if s >= burn_in:
            samples[:, s - burn_in] = theta
            if latent is not None:
                latent[s - burn_in] = se

    record(0, theta)
    step = _MHStep.claim(theta, ll, m - 1, prior_fns, transforms,
                         jacobian_convention, return_latent_state_est)
    try:
        step.load(state, theta, ll)
        for s in range(1, m):
            with span("mh_step"):
                seed_words, theta_prop = step.propose()
                # Fresh copies: a filter may keep what it is given.
                ll_prop, se_prop = pf(seed_words.clone(), theta_prop.clone(),
                                      state.n)
                step.accept(ll_prop)
                if se is not None:
                    se = torch.where(
                        step.mask.reshape((-1,) + (1,) * (se.ndim - 1)),
                        se_prop, se)
                record(s, step.theta)
        theta, ll = step.theta.clone(), step.ll.clone()
        host_sync(dev, 2 + (latent is not None))
        accepted = step.accepts.cpu().numpy()
    finally:
        step.busy = False
    count("mh_steps", m - 1)

    return SampleResult(
        samples=samples.cpu().numpy(),
        acceptance_rate=accepted / max(m - 1, 1),
        state=dataclasses.replace(state, theta=theta, ll=ll, se=se,
                                  step=state.step + m - 1),
        latent=(torch.stack(latent, dim=1).cpu().numpy()
                if latent is not None else None),
        accepted=accepted,
    )


def _root_key(seed):
    """``(root key words [2], the seed to report)`` from an int seed, or
    from ``[2]`` key words given in place of a JAX key."""
    if seed is None:
        seed = int(np.random.SeedSequence().generate_state(1)[0])
    if isinstance(seed, (int, np.integer)):
        return threefry.key(int(seed)), int(seed)
    root = threefry.as_key_words(seed)
    if root.shape != (2,):
        raise ValueError(
            "seed must be an int or the [2] words of one key (got shape "
            f"{tuple(root.shape)})")
    return root, None


def _sample_in_chunks(pf, state, m, keep_from, prior_fns, transforms,
                      jacobian_convention, return_latent_state_est,
                      chunk_size, verbose, done=1, samples=None,
                      latents=None, accepted=None, on_chunk=None,
                      gather=None):
    """Samples ``keep_from .. m - 1`` ``[C, m - keep_from, P]`` (and latent
    states) of ``m`` samples per chain, of which ``done`` exist: ``state``
    (its log-likelihood set) is sample ``done - 1``, and samples ``done ..
    m - 1`` come from :func:`sample_chains` called again on the returned
    state, chunk by chunk. Returns ``(samples, latent or None, accepted
    [C])``.

    A resumed run passes the blocks of samples (and latent states) it
    holds in ``samples``/``latents`` and its accepted steps in
    ``accepted``; the new blocks and counts are added to them.
    ``chunk_size`` ``None`` runs the samples before ``keep_from`` in one
    chunk and the rest in chunks of at most ``SAMPLE_CHUNK`` steps;
    otherwise every chunk is ``chunk_size`` steps, and ``verbose`` prints
    the JAX driver's progress line after each, over the chains that
    ``gather`` (by default the identity) collects from every rank.
    ``on_chunk(state, done, samples, latents, accepted)`` is called after
    each chunk.
    """
    samples = list(samples or [])
    latents = list(latents or [])
    if done == 1 and keep_from == 0:
        host_sync(state.theta, 1 + return_latent_state_est)
        samples.append(state.theta.cpu().numpy()[:, None])
        if return_latent_state_est:
            latents.append(state.se.cpu().numpy()[:, None])
    accepted = (np.zeros(state.theta.shape[0], dtype=np.int64)
                if accepted is None else accepted.copy())
    while done < m:
        if chunk_size is not None:
            length = min(chunk_size, m - done)
        elif done < keep_from:
            length = keep_from - done + 1
        else:
            length = min(SAMPLE_CHUNK, m - done)
        # Local sample j of the chunk is global sample done - 1 + j; j = 0
        # is the state it starts from, recorded already.
        first_keep = max(1, keep_from - done + 1)
        local_burn = min(first_keep, length)
        with span("chunk"):
            res = sample_chains(pf, state, length + 1, local_burn, prior_fns,
                                transforms, jacobian_convention,
                                return_latent_state_est)
            drop = first_keep - local_burn
            samples.append(res.samples[:, drop:])
            if return_latent_state_est:
                latents.append(res.latent[:, drop:])
            state = res.state
            accepted += res.accepted
            done += length
            if verbose:
                every = gather or (lambda x: x)
                chunk_acc = float(every(res.accepted).mean()) / length
                cum_acc = float(every(accepted).mean()) / max(done - 1, 1)
                print(
                    f"Sampling: {done}/{m} steps — acceptance "
                    f"chunk {chunk_acc:.3f}, cumulative {cum_acc:.3f}"
                )
            if on_chunk is not None:
                on_chunk(state, done, samples, latents, accepted)
    p = state.theta.shape[1]
    post = (np.concatenate(samples, axis=1) if samples
            else np.zeros((state.theta.shape[0], 0, p), np.float32))
    latent = (np.concatenate(latents, axis=1)
              if return_latent_state_est and latents else None)
    return post, latent, accepted


def _sharded_pf_factory(mesh, particle_axis: str, ps: int):
    """``_make_pf_loglike`` with the particle axis sharded over ``ps``
    ranks; each filter call runs inside ``use_mesh(mesh)``."""
    from bayesssm_tpu_torch.parallel.mesh import use_mesh

    def factory(*args, **kwargs):
        pf = _make_pf_loglike(*args, particle_axis=particle_axis,
                              particle_axis_size=ps, **kwargs)

        def pf_on_mesh(*call_args, **call_kwargs):
            with use_mesh(mesh):
                return pf(*call_args, **call_kwargs)

        return pf_on_mesh

    return factory


def _slowest_rank(timings: dict, mesh, dev) -> dict:
    """Each phase's seconds on the slowest rank of the mesh, so that every
    rank reports the same timings."""
    from bayesssm_tpu_torch.parallel.collectives import pmax
    from bayesssm_tpu_torch.parallel.mesh import use_mesh

    host_sync(dev, 2)           # the copies to the device and back
    secs = torch.tensor(list(timings.values()), dtype=torch.float64,
                        device=dev)
    with use_mesh(mesh):
        for axis in mesh.mesh_dim_names:
            secs = pmax(secs, axis)
    return dict(zip(timings, secs.cpu().tolist()))


def _resolve_device(device) -> torch.device:
    """``pmmh()``'s device: the current CUDA device unless the caller names
    one; no silent fallback to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "pmmh() runs on a CUDA device by default and found none; pass "
            'device="cpu" to run the chains on the CPU')
    return torch.device("cuda", torch.cuda.current_device())


@spanned("pmmh")
def pmmh(
    pf_wrapper,
    y,
    m: int,
    init_fn,
    transition_fn,
    log_likelihood_fn,
    log_priors: dict,
    pilot_init_params,
    burn_in: int,
    num_chains: int = 4,
    aux_log_likelihood_fn=None,
    move_fn=None,
    obs_times=None,
    resample_algorithm: str = "SISAR",
    resample_fn: str = "stratified",
    param_transform: Optional[dict] = None,
    tune_control: Optional[TuneControl] = None,
    verbose: bool = False,
    return_latent_state_est: bool = False,
    seed=None,
    jacobian_convention: str = "consistent",
    carry_weights: bool = False,
    mesh=None,
    chain_axis: str = "chains",
    particle_axis: str = "particles",
    print_summary: bool = True,
    checkpoint_every: Optional[int] = None,
    checkpoint_path=None,
    resume: bool = False,
    pf_impl=None,
    progress_every: Optional[int] = None,
    *,
    device=None,
) -> PMMHOutput:
    """Run PMMH with pilot tuning; returns a :class:`PMMHOutput`.

    The JAX function's arguments, defaults, checks and messages, plus the
    keyword-only ``device`` the chains run on: by default the current CUDA
    device. Without a card the call raises ``RuntimeError`` unless the
    caller asks for the CPU with ``device="cpu"``; it never falls back to
    the CPU by itself. ``seed`` is an int or the ``[2]`` words of a key;
    the module docstring states the RNG contract.

    ``pf_impl`` replaces ``_make_pf_loglike`` in both phases, e.g.
    ``sir_sweep_pf_impl(500, 70)`` for the whole-sweep kernel; its filter
    is trusted to match the requested algorithm, as in the JAX driver.

    Sampling runs in chunks: with ``progress_every`` (``min(500, m)``
    under ``verbose``) every chunk is that many steps, and ``verbose``
    prints the JAX driver's progress line after each; otherwise the
    burn-in runs in one chunk and the rest in chunks of at most 256 steps.
    Chunking changes no sample. ``timings`` holds the seconds of
    ``"tuning"`` (absent on resume), ``"compile"`` (building and loading
    the CUDA kernels, when this call did so; else 0) and ``"sampling"``.

    ``checkpoint_path`` cuts sampling into chunks of ``checkpoint_every``
    (else ``progress_every``, else all) steps and writes a snapshot after
    each (``utils/checkpoint.py``: the samples so far, burn-in included,
    the chain state and the tuned proposal). ``resume=True`` continues
    from the snapshot at ``checkpoint_path`` without tuning. A step's
    draws depend only on the chain words and the step's index (module
    docstring), so a resumed run equals the uninterrupted one bit for bit,
    whatever the chunks of either.

    ``mesh`` (a ``DeviceMesh`` from ``make_chain_mesh``,
    ``MeshConfig.build`` or ``global_chain_mesh``) runs the call on every
    rank of the mesh, each on its block of chains (module docstring);
    ``chain_axis`` and ``particle_axis`` name its axes. ``num_chains``
    must be divisible by the chains axis, and a particle axis larger than
    1 shards every filter's particles and refuses a ``pf_impl``, whose
    kernels are single-shard. A snapshot holds every chain whatever the
    mesh, and resumes on any mesh or none.
    """
    # ---------------- validation ----------------
    if not isinstance(m, (int, np.integer)) or m < 1:
        raise ValueError("m must be an integer >= 1")
    if not isinstance(burn_in, (int, np.integer)) or not (0 <= burn_in <= m - 1):
        raise ValueError("burn_in must be an integer in [0, m - 1]")
    if not isinstance(num_chains, (int, np.integer)) or num_chains < 1:
        raise ValueError("num_chains must be an integer >= 1")
    if not isinstance(log_priors, dict) or len(log_priors) == 0:
        raise ValueError("log_priors must be a non-empty dict of callables")
    if isinstance(y, torch.Tensor):
        host_sync(y)
        y_host = y.detach().cpu().numpy()
    else:
        y_host = np.asarray(y)
    if not np.issubdtype(y_host.dtype, np.number) or np.isnan(y_host).any():
        raise ValueError("y must be numeric with no missing values")

    algorithm = _resolve_algorithm(pf_wrapper)
    if algorithm == "APF" and aux_log_likelihood_fn is None:
        raise ValueError("APF requires aux_log_likelihood_fn")
    if algorithm == "RMPF" and move_fn is None:
        raise ValueError("RMPF requires a move_fn")

    param_names = list(log_priors.keys())
    prior_fns = [log_priors[p] for p in param_names]
    init_names = (
        pilot_init_params
        if isinstance(pilot_init_params, dict)
        else pilot_init_params[0]
    )
    check_params_match(
        init_fn, transition_fn, log_likelihood_fn, init_names, log_priors
    )
    theta0 = _stack_init_params(pilot_init_params, num_chains, param_names)

    transforms = resolve_transforms(param_transform, param_names)
    tune_control = tune_control or default_tune_control()

    # Initial parameters must lie inside the prior support.
    for j, fn in enumerate(prior_fns):
        lp = torch.as_tensor(fn(torch.as_tensor(theta0[:, j])))
        if not bool(torch.isfinite(lp).all()):
            raise ValueError(
                "Initial parameter values are invalid: some lie outside "
                "the prior support. Please provide valid starting values "
                "via pilot_init_params."
            )

    cs = ps = 1
    if mesh is not None:
        axes = tuple(mesh.mesh_dim_names or ())
        if chain_axis not in axes:
            raise ValueError(
                f"mesh has no axis {chain_axis!r} (axes {axes})")
        cs = mesh.size(axes.index(chain_axis))
        if particle_axis in axes:
            ps = mesh.size(axes.index(particle_axis))
        if ps > 1 and pf_impl is not None:
            raise ValueError(
                "pf_impl evaluators are single-shard; use a mesh whose "
                f"'{particle_axis}' axis has size 1"
            )
        if num_chains % cs:
            raise ValueError(
                "num_chains must be divisible by the mesh chains axis"
            )

    dev = _resolve_device(device)
    c_local = num_chains // cs
    rank = mesh.get_local_rank(chain_axis) if mesh is not None else 0
    lo = rank * c_local
    block = slice(lo, lo + c_local)

    def gather(x):
        """This rank's ``[c_local, ...]`` host array of per-chain values as
        the ``[num_chains, ...]`` array of every rank (through the chains
        group whenever there is a mesh, so a one-rank mesh's gathers run on
        its backend too)."""
        if mesh is None:
            return x
        from bayesssm_tpu_torch.parallel.collectives import all_gather
        from bayesssm_tpu_torch.parallel.mesh import use_mesh

        host_sync(dev, 2)       # the copies to the device and back
        local = torch.as_tensor(np.ascontiguousarray(x), device=dev)
        with use_mesh(mesh):
            return all_gather(local, chain_axis).cpu().numpy()

    # ---------------- resume path ----------------
    resume_state = None
    if resume:
        if checkpoint_path is None or not pathlib.Path(
                checkpoint_path).exists():
            raise ValueError(
                "resume=True requires an existing checkpoint_path"
            )
        resume_state = load_checkpoint(checkpoint_path)
        if resume_state["format_version"] != FORMAT_VERSION:
            raise ValueError(
                f"checkpoint {checkpoint_path} has format version "
                f"{resume_state['format_version']}: its key_data are the "
                "JAX driver's threefry keys, not this driver's chain "
                "words, so its chains cannot be continued here")
        if verbose:
            print(
                f"Resuming from {checkpoint_path} at step "
                f"{resume_state['step']}/{m}"
            )

    root_key, seed_out = _root_key(seed)
    host_copy(root_key, dev)
    chain_keys = threefry.fold_in(
        root_key.to(dev), torch.arange(lo, lo + c_local, device=dev))
    model_fns = (
        init_fn, transition_fn, log_likelihood_fn,
        aux_log_likelihood_fn, move_fn,
    )
    if ps > 1:
        pf_factory = _sharded_pf_factory(mesh, particle_axis, ps)
    else:
        pf_factory = pf_impl or _make_pf_loglike
    timer = PhaseTimer(verbose=verbose, device=dev)

    compile_s = 0.0
    if dev.type == "cuda":
        from bayesssm_tpu_torch.ops import _build

        if not _build.library_loaded():
            with timer.phase("compile"):
                _build.load_library()
            compile_s = timer.timings["compile"]

    # ---------------- phase 1: pilot tuning, batched over chains ---------
    if resume_state is None:
        if verbose:
            print(f"Running pilot chains for tuning ({num_chains} "
                  "chains)...")
        with timer.phase("tuning"):
            tuned = run_pilot_chain(
                chain_keys, y_host, param_names, model_fns, prior_fns,
                theta0[block], transforms, tune_control, obs_times=obs_times,
                algorithm=algorithm,
                jacobian_convention=jacobian_convention,
                carry_weights=carry_weights, pf_impl=pf_factory,
            )
        # The one host sync between the phases, over every chain.
        host_sync(dev, 3)
        theta_mean = gather(tuned["pilot_theta_mean"].cpu().numpy()).astype(
            np.float64)
        theta_cov = gather(tuned["pilot_theta_cov"].cpu().numpy()).astype(
            np.float64)
        target_n = gather(tuned["target_n"].cpu().numpy()).astype(np.int64)

        if verbose:
            for c in range(num_chains):
                print(f"Chain {c + 1}: pilot posterior mean "
                      f"{theta_mean[c]}")
                print(f"Chain {c + 1}: pilot covariance\n{theta_cov[c]}")
            print(f"Using {target_n} particles for PMMH:")
    else:
        meta = resume_state["meta"]
        theta_mean = np.asarray(meta["theta_mean"])
        target_n = np.asarray(meta["target_n"], dtype=np.int64)
        if target_n.shape != (num_chains,):
            raise ValueError(
                f"checkpoint {checkpoint_path} holds {target_n.shape[0]} "
                f"chains, not num_chains={num_chains}")

    # ---------------- phase 2: the main chains ----------------
    max_particles = _particle_lane_bound(int(target_n.max()))
    pf = pf_factory(
        y_host, None, param_names, model_fns, obs_times, algorithm,
        resample_algorithm, resample_fn, carry_weights,
        max_particles=max_particles,
    )
    if resume_state is None:
        mh_keys, k0 = threefry.split(chain_keys).unbind(1)
        with span("proposal_factors"):
            host_sync(mh_keys)
            state = chain_state_from_pilot(theta_mean[block],
                                           theta_cov[block], target_n[block],
                                           transforms, mh_keys.cpu().numpy(),
                                           dev)
        ll0, se0 = pf(k0, state.theta, state.n)
        state = dataclasses.replace(
            state, ll=ll0, se=se0 if return_latent_state_est else None)
        steps_done, prior, prior_latent, accepted0 = 1, [], [], None
    else:
        # A snapshot records latent-state history only when the run that
        # wrote it collected it, so the flip to collecting is refused.
        if (return_latent_state_est
                and "state_samples" not in resume_state):
            raise ValueError(
                "resume=True with return_latent_state_est=True, but the "
                "checkpoint was written without latent-state collection; "
                "resume with return_latent_state_est=False or restart"
            )
        state = chain_state_from_numpy(
            resume_state["theta"][block], meta["prop_factors"][block],
            target_n[block], resume_state["keys"][block], dev)
        state = dataclasses.replace(
            state,
            ll=torch.as_tensor(resume_state["loglike"][block], device=dev),
            se=(torch.as_tensor(resume_state["state_est"][block],
                                device=dev)
                if return_latent_state_est else None),
            step=int(meta["mh_step"]))
        steps_done = resume_state["step"]
        prior = [resume_state["samples"][block]]
        prior_latent = ([resume_state["state_samples"][block]]
                        if return_latent_state_est else [])
        accepted0 = np.asarray(meta["accept_total"])[block].astype(np.int64)

    if verbose:
        print("Running Particle MCMC chains with tuned settings...")
    if progress_every is None and verbose:
        progress_every = min(500, m)
    on_chunk = None
    chunk_size = progress_every
    keep_from = burn_in
    if checkpoint_path is not None:
        # Every chunk ends in a snapshot of all samples so far, burn-in
        # included, as the JAX driver writes it.
        chunk_size = (checkpoint_every or progress_every
                      or (m - steps_done) or 1)
        keep_from = 0

        def on_chunk(st, done, samples, latents, accepted):
            # Every rank gathers every chain and writes the same snapshot.
            def full(x):
                host_sync(x)
                return gather(x.cpu().numpy())

            save_checkpoint(
                checkpoint_path,
                keys=full(st.words),
                theta=full(st.theta),
                loglike=full(st.ll),
                state_est=full(st.se) if return_latent_state_est else None,
                samples=gather(np.concatenate(samples, axis=1)),
                state_samples=(gather(np.concatenate(latents, axis=1))
                               if return_latent_state_est else None),
                step=done,
                meta={
                    "theta_mean": theta_mean,
                    "target_n": target_n,
                    "prop_factors": full(st.factors),
                    "accept_total": gather(accepted).astype(np.float64),
                    "mh_step": st.step,
                },
            )

    with timer.phase("sampling"):
        post, state_chains, accept_total = _sample_in_chunks(
            pf, state, m, keep_from, prior_fns, transforms,
            jacobian_convention, return_latent_state_est, chunk_size,
            verbose, done=steps_done, samples=prior, latents=prior_latent,
            accepted=accepted0, on_chunk=on_chunk, gather=gather,
        )
    post = gather(post)
    accept_total = gather(accept_total)
    if state_chains is not None:
        state_chains = gather(state_chains)
    if keep_from != burn_in:
        post = post[:, burn_in:]
        if state_chains is not None:
            state_chains = state_chains[:, burn_in:]
    accept_rates = accept_total / max(m - 1, 1)

    # ---------------- post-processing ----------------
    theta_chain_dict = {
        p: post[:, :, j] for j, p in enumerate(param_names)
    }
    param_ess, param_rhat = {}, {}
    ess_message_shown = False
    for j, p in enumerate(param_names):
        mat = post[:, :, j].T  # [iters, chains]
        if num_chains > 1:
            param_ess[p] = float(ess_matrix(mat))
        else:
            param_ess[p] = float("nan")
            if not ess_message_shown:
                print(
                    "ESS cannot be computed with only one chain "
                    "Run at least 2 chains."
                )
                ess_message_shown = True
        param_rhat[p] = (float(rhat_matrix(mat)) if post.shape[1] >= 2
                         else float("nan"))

    timings = {**({"tuning": timer.timings["tuning"]}
                  if resume_state is None else {}),
               "compile": compile_s,
               "sampling": timer.timings["sampling"]}
    if mesh is not None:
        timings = _slowest_rank(timings, mesh, dev)
    result = PMMHOutput(
        theta_chain=theta_chain_dict,
        diagnostics={"ess": param_ess, "rhat": param_rhat},
        latent_state_chain=state_chains,
        acceptance_rate=accept_rates,
        target_n=target_n,
        seed=seed_out,
        timings=timings,
    )

    if print_summary:
        print(result)

    if any(
        not np.isnan(v) and v < 400 for v in param_ess.values()
    ):
        warnings.warn(
            "Some ESS values are below 400, indicating poor mixing. "
            "Consider running the chains for more iterations."
        )
    if any(
        not np.isnan(v) and v > 1.01 for v in param_rhat.values()
    ):
        warnings.warn(
            "\nSome Rhat values are above 1.01, indicating that the chains "
            "have not converged. \nConsider running the chains for more "
            "iterations and/or increase burn_in."
        )

    return result
