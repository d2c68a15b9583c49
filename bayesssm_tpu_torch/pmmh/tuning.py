"""Pilot-run tuning for PMMH (port of ``bayesssm_tpu/pmmh/tuning.py``).

* :func:`run_pilot_chain` — a non-adaptive random-walk Metropolis pilot
  chain of length ``pilot_m`` with per-parameter proposal SDs; a proposal
  outside the prior support is drawn again, at most
  ``MAX_PROPOSAL_TRIES`` times (Q7). Posterior mean and covariance are
  taken on the UNTRANSFORMED second half of the chain (Q6). Each step
  decides with :func:`mh_accept`, the sampler's rule.
* :func:`pilot_run` — ``pilot_reps`` filter evaluations at the pilot
  posterior mean; ``target_n = clamp(ceil(pilot_n * var), 50, 1000)``
  (Q10).

The JAX functions are single-chain and the JAX driver ``vmap``s them;
here every function takes a leading chain axis: keys are ``[C, 2]`` key
words (``ops/threefry.py``), theta is ``[C, P]``. A chain's results depend
only on its own key, and they follow the JAX key schedule draw for draw:
``split(key)`` for the first evaluation, ``split(key, 4)`` per pilot step,
the propose loop's own ``split``s, and ``split(key, pilot_reps)`` for
:func:`pilot_run`. Each filter is called with the words of its key.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading

import numpy as np
import torch

from bayesssm_tpu_torch.filters.core import particle_filter_core
from bayesssm_tpu_torch.ops import _build, threefry
from bayesssm_tpu_torch.pmmh.priors import sum_log_priors
from bayesssm_tpu_torch.pmmh.transforms import (
    back_transform_params,
    log_jacobian,
    transform_params,
)
from bayesssm_tpu_torch.utils import timing
from bayesssm_tpu_torch.utils.timing import (
    count,
    host_copy,
    host_sync,
    span,
    spanned,
)

__all__ = ["TuneControl", "default_tune_control", "mh_accept",
           "run_pilot_chain", "pilot_run", "_make_pf_loglike"]

_RESAMPLE_ALGOS = ("SISAR", "SISR", "SIS")
_RESAMPLE_FNS = ("stratified", "systematic", "multinomial")

# Cap on the reference's unbounded re-propose-until-valid loop (Q7).
MAX_PROPOSAL_TRIES = 100

TARGET_N_MIN = 50
TARGET_N_MAX = 1000

# Particle lanes one pilot_run filter call takes (rows x lanes): at the
# pilot's 128 lanes, 131,072 rows per call.
PILOT_LANES_PER_CALL = 1 << 24


@dataclasses.dataclass(frozen=True)
class TuneControl:
    """Validated pilot tuning configuration. ``pilot_target_var`` and
    ``pilot_burn_in`` are kept for parity with the reference's
    configuration and are never read by the tuning (Q10; the pilot chain
    always discards its first half)."""

    pilot_proposal_sd: float = 0.5
    pilot_n: int = 100
    pilot_m: int = 2000
    pilot_target_var: float = 1.0
    pilot_burn_in: int = 500
    pilot_reps: int = 100
    pilot_resample_algorithm: str = "SISAR"
    pilot_resample_fn: str = "stratified"


def default_tune_control(
    pilot_proposal_sd: float = 0.5,
    pilot_n: int = 100,
    pilot_m: int = 2000,
    pilot_target_var: float = 1.0,
    pilot_burn_in: int = 500,
    pilot_reps: int = 100,
    pilot_resample_algorithm: str = "SISAR",
    pilot_resample_fn: str = "stratified",
) -> TuneControl:
    """Create validated tuning controls (the JAX function's checks and
    messages)."""
    if not (pilot_proposal_sd >= 0 and np.isfinite(pilot_proposal_sd)):
        raise ValueError("pilot_proposal_sd must be a finite non-negative number")
    for name, val in [
        ("pilot_n", pilot_n),
        ("pilot_m", pilot_m),
        ("pilot_burn_in", pilot_burn_in),
        ("pilot_reps", pilot_reps),
    ]:
        if not isinstance(val, int) or val < 1:
            raise ValueError(f"{name} must be a positive integer")
    if not (pilot_target_var >= 0):
        raise ValueError("pilot_target_var must be non-negative")
    if pilot_resample_algorithm not in _RESAMPLE_ALGOS:
        raise ValueError(f"pilot_resample_algorithm must be one of {_RESAMPLE_ALGOS}")
    if pilot_resample_fn not in _RESAMPLE_FNS:
        raise ValueError(f"pilot_resample_fn must be one of {_RESAMPLE_FNS}")
    return TuneControl(
        pilot_proposal_sd=float(pilot_proposal_sd),
        pilot_n=int(pilot_n),
        pilot_m=int(pilot_m),
        pilot_target_var=float(pilot_target_var),
        pilot_burn_in=int(pilot_burn_in),
        pilot_reps=int(pilot_reps),
        pilot_resample_algorithm=pilot_resample_algorithm,
        pilot_resample_fn=pilot_resample_fn,
    )


# Filter keys (:class:`_FilterGraph`) a ``_make_pf_loglike`` closure
# keeps, the least recently used dropped first.
ENGINE_GRAPH_KEYS = 4


def _graphs_on(dev) -> bool:
    """Whether filter calls on ``dev`` can be CUDA graphs."""
    return dev.type == "cuda"


def _capture_graph(fn, args, stream, pool=()):
    """``(graph, out)``: ``out = fn(*args)`` captured into a CUDA graph on
    ``stream``, in the memory pool ``pool`` (``(graph.pool(),)`` of another
    graph) or one of its own. Raises what the capture raises."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        graph.capture_begin(*pool, capture_error_mode="thread_local")
        try:
            out = fn(*args)
        finally:
            graph.capture_end()
    return graph, out


def _capture_filter(run, inputs):
    """``(graph, outputs)``: ``run(*inputs)`` captured on a side stream of
    the device of ``inputs[0]``, after a wait for the device's queue."""
    dev = inputs[0].device
    torch.cuda.synchronize(dev)
    return _capture_graph(run, inputs, torch.cuda.Stream(dev))


def _tally() -> tuple:
    """The port's kernel launches (``ops/_build.py``) and the thread's
    counters, as they stand."""
    return dict(_build.launches), timing.counters()


def _gained(before) -> tuple:
    """``(launches, counters)`` that moved since ``_tally()`` gave
    ``before``, each name with what it gained."""
    return tuple({name: n - was.get(name, 0) for name, n in now.items()
                  if n != was.get(name, 0)}
                 for was, now in zip(before, _tally()))


def _add(gain, sign: int = 1) -> None:
    """Add ``sign`` times ``gain`` (from :func:`_gained`) to the launches
    and the counters."""
    launches, counters = gain
    for name, n in launches.items():
        _build.launches[name] = _build.launches.get(name, 0) + sign * n
    for name, n in counters.items():
        count(name, sign * n)


def _filter_key(words, theta, n):
    """What a filter graph bakes in besides its closure's own callbacks,
    configuration and ``y``: the device, the shapes and dtypes of the key
    words and thetas, and the particle count (an int, or a tensor's shape,
    dtype and device). None for a count of another kind."""
    if isinstance(n, torch.Tensor):
        count_key = (tuple(n.shape), n.dtype, n.device)
    elif isinstance(n, (int, np.integer)):
        count_key = int(n)
    else:
        return None
    return (words.device, tuple(words.shape), words.dtype,
            tuple(theta.shape), theta.dtype, count_key)


class _FilterGraph:
    """One key's filter call (:func:`_filter_key`) of a
    ``_make_pf_loglike`` closure. The key's first call runs directly, its
    second is captured as a CUDA graph, and every later call replays it:
    the direct call's kernels on the call's inputs, so the same bits.

    A replay copies the call's inputs into the tensors the graph reads
    (``inputs``), adds to the launch counts and counters what the captured
    call added (``gain``: a capture launches nothing, so it leaves them as
    they were) and returns copies of the graph's outputs, which the next
    replay overwrites. ``graph`` is None until the capture, and ``()`` for
    good where the key's direct call waited on the host (a loop that asks
    the host, such as tau-leap's ``binomial``, cannot be replayed) or the
    capture raised; both count ``engine_graph.fallback``.
    """

    def __init__(self):
        self.graph = None
        self.called = False     # the key's direct call has run
        self.busy = False       # a call holds the key

    def __call__(self, run, words, theta, n):
        if self.graph:
            with span("filter"):
                return self._replay(words, theta, n)
        if self.graph is None and self.called:
            with span("engine_capture"):
                if self._capture(run, words, theta, n):
                    return self._replay(words, theta, n)
        if self.called:
            return run(words, theta, n)
        self.called = True
        syncs = timing.counters().get("host_sync", 0)
        out = run(words, theta, n)
        if timing.counters().get("host_sync", 0) != syncs:
            self.graph = ()
            count("engine_graph.fallback")
        return out

    def _capture(self, run, words, theta, n) -> bool:
        inputs = (words.clone(), theta.clone(),
                  n.clone() if isinstance(n, torch.Tensor) else n)
        host_sync(words)            # _capture_filter waits for the queue
        before = _tally()
        try:
            self.graph, self.outputs = _capture_filter(run, inputs)
        except RuntimeError:
            # Work a graph cannot hold, such as a callback that copies a
            # number from the host: the direct call does the same work.
            self.graph = ()
        finally:
            self.gain = _gained(before)
            _add(self.gain, -1)
        if not self.graph:
            count("engine_graph.fallback")
            return False
        count("engine_graph.capture")
        self.inputs = inputs
        return True

    def _replay(self, words, theta, n):
        words_in, theta_in, n_in = self.inputs
        words_in.copy_(words)
        theta_in.copy_(theta)
        if isinstance(n_in, torch.Tensor):
            n_in.copy_(n)
        self.graph.replay()
        _add(self.gain)
        count("engine_graph.replay")
        return tuple(t.clone() for t in self.outputs)


def _make_pf_loglike(
    y,
    num_particles,
    param_names,
    model_fns,
    obs_times,
    algorithm,
    resample_algorithm,
    resample_fn,
    carry_weights,
    max_particles=None,
    particle_axis=None,
    particle_axis_size=1,
):
    """Build the batched ``pf(seed_words [C, 2], theta [C, P],
    n=num_particles) -> (loglike [C], state_est)`` that ``sample_chains``
    takes, for a fixed filter configuration.

    ``model_fns`` is ``(init_fn, transition_fn, log_likelihood_fn,
    aux_fn, move_fn)``; ``theta`` columns follow ``param_names``. The
    filter runs with ``use_fused="auto"``, the engine's default, as the
    JAX function's does: on CUDA tensors every SISR/SISAR day goes through
    the fused weight-step kernel. With ``particle_axis`` each call runs
    the particle-sharded engine on this rank's ``max_particles /
    particle_axis_size`` lanes, inside ``parallel.mesh.use_mesh`` (the
    fused step is then off, as in JAX).

    On a CUDA device a call is one CUDA graph of the whole filter, captured
    once per key (:class:`_FilterGraph`: the device, the shapes and dtypes
    of the words and thetas, the particle count) on the key's second call
    and replayed after it, as the JAX function compiles it once per shape:
    the callbacks run when the graph is captured. The closure keeps the
    last ``ENGINE_GRAPH_KEYS`` keys. A replay returns new tensors, runs in
    a ``filter`` span of its own with no day spans, and counts
    ``engine_graph.replay`` and what the captured call counted. Calls stay
    direct on the CPU, with ``particle_axis`` (collectives), while another
    call holds the key, and for a key whose direct call waited on the host
    or whose capture raised (``engine_graph.fallback``).
    """
    init_fn, transition_fn, log_likelihood_fn, aux_fn, move_fn = model_fns
    names = list(param_names)
    on_device = {}
    graphs: collections.OrderedDict = collections.OrderedDict()
    lock = threading.Lock()

    def run(words, theta_vec, n):
        theta = {name: theta_vec[:, j] for j, name in enumerate(names)}
        res = particle_filter_core(
            key=words,
            y=on_device[words.device],
            num_particles=n,
            init_fn=init_fn,
            transition_fn=transition_fn,
            weight_fn=log_likelihood_fn,
            aux_weight_fn=aux_fn,
            move_fn=move_fn,
            theta=theta,
            obs_times=obs_times,
            algorithm=algorithm,
            resample_algorithm=resample_algorithm,
            resample_fn=resample_fn,
            return_particles=False,
            max_particles=max_particles,
            carry_weights=carry_weights,
            particle_axis=particle_axis,
            particle_axis_size=particle_axis_size,
        )
        return res.loglike, res.state_est

    def claim(key):
        """The key's graph, held for one call; None while another call
        holds it."""
        with lock:
            entry = graphs.get(key)
            if entry is None:
                entry = graphs[key] = _FilterGraph()
                while len(graphs) > ENGINE_GRAPH_KEYS:
                    graphs.popitem(last=False)
            graphs.move_to_end(key)
            if entry.busy:
                return None
            entry.busy = True
            return entry

    def pf(seed_words, theta_vec, n=num_particles):
        theta_vec = torch.as_tensor(theta_vec, dtype=torch.float32)
        dev = theta_vec.device
        if dev not in on_device:
            host_copy(y, dev)
            on_device[dev] = torch.as_tensor(y, dtype=torch.float32,
                                             device=dev)
        words = torch.as_tensor(seed_words, device=dev)
        if particle_axis is not None or not _graphs_on(dev):
            return run(words, theta_vec, n)
        key = _filter_key(words, theta_vec, n)
        entry = None if key is None else claim(key)
        if entry is None:
            count("engine_graph.fallback")
            return run(words, theta_vec, n)
        try:
            return entry(run, words, theta_vec, n)
        finally:
            entry.busy = False

    pf.graphs = graphs
    return pf


def mh_accept(theta, ll, theta_prop, lp_prop, ll_prop, u_acc, prior_fns,
              transforms, jacobian_convention="consistent"):
    """The Metropolis-Hastings decision of every chain, given the
    proposal's log prior ``lp_prop`` and log-likelihood ``ll_prop`` and
    the uniforms ``u_acc``: ``(theta, ll, accept)``. A proposal outside
    the prior support, or a NaN ratio, is rejected. The pilot chain and
    the sampler (``driver.mh_step``) both decide with it."""
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
    return (torch.where(accept[:, None], theta_prop, theta),
            torch.where(accept, ll_prop, ll), accept)


def _propose_until_valid(key, z, proposal_sd, transforms, prior_fns,
                         theta_curr):
    """Bounded re-propose loop (Q7) for every chain of ``key [C, 2]``.

    Try ``i`` draws ``z' = z + sd * eps`` from the second key of the
    ``i``-th ``split``; a chain keeps its first proposal with a finite
    prior, and falls back to its current (always valid) theta when none of
    ``MAX_PROPOSAL_TRIES`` is. The host asks once per try whether any
    chain is still without one.
    """
    p = z.shape[-1]
    theta = theta_curr
    pending = torch.ones(z.shape[0], dtype=torch.bool, device=z.device)
    for _ in range(MAX_PROPOSAL_TRIES):
        key, k = threefry.split(key).unbind(1)
        zp = z + proposal_sd * threefry.normal(k, (p,))
        thp = back_transform_params(zp, transforms)
        valid = torch.isfinite(sum_log_priors(thp, prior_fns))
        theta = torch.where((pending & valid)[:, None], thp, theta)
        pending = pending & ~valid
        host_sync(pending)
        if not bool(pending.any()):
            break
    return theta


@spanned("pilot")
def run_pilot_chain(
    key,
    y,
    param_names,
    model_fns,
    prior_fns,
    init_theta,
    transforms,
    control: TuneControl,
    obs_times=None,
    algorithm: str = "BPF",
    jacobian_convention: str = "consistent",
    carry_weights: bool = False,
    pf_impl=None,
):
    """Run the pilot RWM chain and the pilot variance run of every chain
    of ``key [C, 2]`` (tensor key words; the chains run on its device)
    from ``init_theta [C, P]``; returns a dict of tensors with a leading
    chain axis: pilot_theta_mean [C, P], pilot_theta_cov [C, P, P]
    (untransformed scale, Q6), target_n [C], variance_estimate [C],
    pilot_theta_chain [C, pilot_m, P], pilot_loglike_chain [C, pilot_m]
    and pilot_accept_rate [C].

    ``pf_impl`` optionally replaces ``_make_pf_loglike`` (same signature),
    e.g. ``sir_sweep_pf_impl(...)`` for the whole-sweep kernel.
    """
    key = threefry.as_key_words(key)
    dev = key.device
    host_copy(init_theta, dev)
    init_theta = torch.as_tensor(init_theta, dtype=torch.float32, device=dev)
    proposal_sd = float(np.float32(control.pilot_proposal_sd))
    # The pilot filter's lanes are padded to a multiple of 128; masked
    # lanes keep the effective particle count at exactly pilot_n.
    lanes = ((control.pilot_n + 127) // 128) * 128
    pf = (pf_impl or _make_pf_loglike)(
        y,
        control.pilot_n,
        param_names,
        model_fns,
        obs_times,
        algorithm,
        control.pilot_resample_algorithm,
        control.pilot_resample_fn,
        carry_weights,
        max_particles=lanes,
    )

    key, k0 = threefry.split(key).unbind(1)
    ll0, _ = pf(k0, init_theta)

    theta, ll = init_theta, ll0
    thetas, lls = [theta], [ll]
    accepted = torch.zeros(key.shape[0], dtype=torch.float32, device=dev)
    for _ in range(control.pilot_m - 1):
        with span("step"):
            key, k_prop, k_pf, k_acc = threefry.split(key, 4).unbind(1)
            z = transform_params(theta, transforms)
            theta_prop = _propose_until_valid(k_prop, z, proposal_sd,
                                              transforms, prior_fns, theta)
            ll_prop, _ = pf(k_pf, theta_prop)
            theta, ll, accept = mh_accept(
                theta, ll, theta_prop, sum_log_priors(theta_prop, prior_fns),
                ll_prop, threefry.uniform(k_acc), prior_fns, transforms,
                jacobian_convention)
            thetas.append(theta)
            lls.append(ll)
            accepted = accepted + accept.to(torch.float32)
    theta_chain = torch.stack(thetas, dim=1)
    loglike_chain = torch.stack(lls, dim=1)

    # Posterior summaries on the untransformed second half (Q6).
    post = theta_chain[:, control.pilot_m // 2:]
    theta_mean = post.mean(dim=1)
    centered = post - theta_mean[:, None]
    theta_cov = torch.einsum("cmp,cmq->cpq", centered, centered) / (
        post.shape[1] - 1)

    with span("variance_run"):
        target_n, var_est = pilot_run(
            key, theta_mean, pf, control,
            max_rows=max(1, PILOT_LANES_PER_CALL // lanes))

    return {
        "pilot_theta_mean": theta_mean,
        "pilot_theta_cov": theta_cov,
        "target_n": target_n,
        "variance_estimate": var_est,
        "pilot_theta_chain": theta_chain,
        "pilot_loglike_chain": loglike_chain,
        "pilot_accept_rate": accepted / max(control.pilot_m - 1, 1),
    }


def pilot_run(key, theta_mean, pf, control: TuneControl, max_rows=None):
    """``Var(loglike)`` at ``theta_mean [C, P]`` over ``pilot_reps`` filter
    runs per chain, and the particle count it asks for: ``(target_n [C],
    variance [C])``.

    The ``C x pilot_reps`` runs are rows of one batched filter call, or of
    several calls of at most ``max_rows`` rows; row ``(c, r)`` always
    takes key ``r`` of ``split(key[c], pilot_reps)``. The variance is
    float32 with ddof = 1, mean first and then the sum of squares, as
    ``jnp.var`` takes it.
    """
    c, p = theta_mean.shape
    reps = control.pilot_reps
    keys = threefry.split(key, reps).reshape(c * reps, 2)
    thetas = theta_mean[:, None, :].expand(c, reps, p).reshape(c * reps, p)
    step = c * reps if max_rows is None else int(max_rows)
    lls = torch.cat([
        pf(keys[i:i + step], thetas[i:i + step])[0]
        for i in range(0, c * reps, step)
    ]).reshape(c, reps)
    mean = lls.sum(dim=1, keepdim=True) / reps
    centered = lls - mean
    var_est = (centered * centered).sum(dim=1) / (reps - 1)
    # -inf loglikes give an inf/NaN variance -> the maximum particle count.
    var_safe = torch.where(torch.isnan(var_est), math.inf, var_est)
    target = torch.ceil(control.pilot_n * var_safe)
    return torch.clamp(target, TARGET_N_MIN, TARGET_N_MAX), var_est
