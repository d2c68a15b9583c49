"""Per-key flips of the port's engine against the JAX engine, and what
causes them.

The port's batched engine (``bayesssm_tpu_torch/filters/core.py``) and an
un-vmapped jitted JAX ``particle_filter_core`` call per key draw the same
threefry streams, so a chain's log-likelihood agrees to float32 rounding
until a resample picks another ancestor for one slot. This module finds
the chains whose log-likelihoods differ by more than ``TOL`` and, for each,
the first resample call whose ancestors differ. There it prints, around
the slot whose ancestor changed: both libraries' CDF entries, normalised
weights and incoming log-weights with their difference in ulps
(``np.spacing``), and the position that slot took.

Both sides record the inputs and outputs of their engine's
``normalize_log_weights`` and ``resample_indices`` calls (the JAX side
through ``jax.debug.callback``, and only on a chain it reruns: its
log-likelihood must come out bit for bit as in the plain run). The JAX
side's weights and CDF on the divergent call come from JAX's own
``normalize_log_weights`` on the recorded log-weights, and ``jnp.cumsum``
of those weights (``ops/resampling.py:225``, the line
``resample_indices`` runs), jitted alone; JAX's ``resample_indices`` on
that day's key must reproduce the engine's ancestors.

Run from the repo root on the CPU (LGSS, 128 lanes, T = 20,
``use_fused=False``, 512 keys)::

    python tests/_engine_flips.py [--keys 512] [--show 3]

It imports the JAX package and the port, as the tests do.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import bayesssm_tpu.filters.core as j_core  # noqa: E402
import bayesssm_tpu_torch.filters.core as p_core  # noqa: E402
from bayesssm_tpu.models.lgss import lgss_model as j_lgss_model  # noqa: E402
from bayesssm_tpu.ops.resampling import (  # noqa: E402
    resample_indices as j_resample_indices,
)
from bayesssm_tpu.ops.weights import (  # noqa: E402
    normalize_log_weights as j_normalize_log_weights,
)
from bayesssm_tpu_torch.models.lgss import (  # noqa: E402
    lgss_model,
    simulate_lgss,
)
from bayesssm_tpu_torch.ops.resampling import _positions  # noqa: E402

A, SX, SY = 0.9, 0.6, 0.4
SY_AUX = float(np.sqrt(SX ** 2 + SY ** 2))
MOVE_SD = 0.2
N, T, SEED = 128, 20, 17
TOL = 1e-4
THETA = {"a": A, "sigma_x": SX, "sigma_y": SY}
VARIANTS = {
    "sisr-stratified": dict(resample_algorithm="SISR",
                            resample_fn="stratified"),
    "sisr-multinomial": dict(resample_algorithm="SISR",
                             resample_fn="multinomial"),
    "carry-weights": dict(carry_weights=True),
    "apf": dict(algorithm="APF", resample_algorithm="SISR"),
    "rmpf": dict(algorithm="RMPF"),
}


def observations() -> np.ndarray:
    return simulate_lgss(1405, t_val=T, a=A, sigma_x=SX,
                         sigma_y=SY)[1].astype(np.float32)


def key_data(keys: int, seed: int = SEED) -> np.ndarray:
    return np.asarray(jax.random.key_data(
        jax.random.split(jax.random.key(seed), keys)))


# ---- the two engines' model functions ------------------------------------

def p_aux(y, particles, a):
    z = (y - a[:, None] * particles) / SY_AUX
    return -0.5 * (float(np.log(2 * np.pi * SY_AUX ** 2)) + z * z)


def j_aux(y, particles, a):
    return -0.5 * (jnp.log(2 * jnp.pi * SY_AUX ** 2)
                   + ((y - a * particles) / SY_AUX) ** 2)


def p_move(key, particles, y, sigma_y):
    from bayesssm_tpu_torch.ops import threefry

    loglik = lgss_model()[0][2]
    k1, k2 = threefry.split(key).unbind(-2)
    shape = particles.shape[1:]
    prop = particles + MOVE_SD * threefry.normal(k1, shape)
    logr = (loglik(y, prop, sigma_y=sigma_y)
            - loglik(y, particles, sigma_y=sigma_y))
    accept = torch.log(threefry.uniform(k2, shape)) < logr
    return torch.where(accept, prop, particles)


def j_move(key, particles, y, sigma_y):
    loglik = j_lgss_model()[0][2]
    k1, k2 = jax.random.split(key)
    prop = particles + MOVE_SD * jax.random.normal(k1, particles.shape)
    logr = (loglik(y, prop, sigma_y=sigma_y)
            - loglik(y, particles, sigma_y=sigma_y))
    accept = jnp.log(jax.random.uniform(k2, particles.shape)) < logr
    return jnp.where(accept, prop, particles)


def _extra(kw, side):
    algo = kw.get("algorithm", "BPF")
    if algo == "APF":
        return {"aux_weight_fn": p_aux if side == "port" else j_aux}
    if algo == "RMPF":
        return {"move_fn": p_move if side == "port" else j_move}
    return {}


# ---- runs -----------------------------------------------------------------

def port_run(kd: np.ndarray, y: np.ndarray, kw: dict):
    """The port's engine on every key at once: ``[C]`` loglikes."""
    res = p_core.particle_filter_core(
        torch.as_tensor(kd.astype(np.int64)), y, N, *lgss_model()[0],
        theta=THETA, return_particles=False, use_fused=False,
        **_extra(kw, "port"), **kw)
    return res.loglike.numpy()


def _jax_fn(name: str):
    """A fresh jitted JAX filter for one key: traced at its first call,
    so inside ``_record_jax`` it records."""
    kw = VARIANTS[name]

    def run(words, y):
        return j_core.particle_filter_core(
            jax.random.wrap_key_data(words), y, N, *j_lgss_model()[0],
            theta=THETA, return_particles=False, use_fused=False,
            **_extra(kw, "jax"), **kw).loglike

    return jax.jit(run)


def jax_run(name: str, kd: np.ndarray, y: np.ndarray) -> np.ndarray:
    """One jitted JAX call per key (un-vmapped): ``[C]`` loglikes."""
    fn = _jax_fn(name)
    yj = jnp.asarray(y)
    return np.array([np.asarray(fn(jnp.asarray(w), yj)) for w in kd])


def flips(name: str, keys: int = 512):
    """``(port loglikes, JAX loglikes, indices of the chains that differ
    by more than TOL)`` for one variant."""
    y = observations()
    kd = key_data(keys)
    ll_p = port_run(kd, y, VARIANTS[name])
    ll_j = jax_run(name, kd, y)
    bad = np.nonzero(~(np.abs(ll_p - ll_j) <= TOL))[0]
    return ll_p, ll_j, bad


# ---- recording the weight steps ------------------------------------------

@contextlib.contextmanager
def _record_port(calls: list, method: str):
    """Record every ``normalize_log_weights`` and ``resample_indices`` call
    of the port's engine: ``(lw, weights)`` and ``(key, weights, alive,
    indices, positions)``."""
    norm, res = p_core.normalize_log_weights, p_core.resample_indices

    def normalize(lw, *a, **k):
        out = norm(lw, *a, **k)
        calls.append(("norm", lw.clone(), out[0].clone()))
        return out

    def resample(keys, weights, method=method, num_alive=None, **k):
        idx = res(keys, weights, method=method, num_alive=num_alive, **k)
        pos = _positions(keys, method, weights.shape[1], num_alive)
        calls.append(("res", keys.clone(), weights.clone(), idx.clone(),
                      pos.clone()))
        return idx

    p_core.normalize_log_weights, p_core.resample_indices = (normalize,
                                                             resample)
    try:
        yield
    finally:
        p_core.normalize_log_weights, p_core.resample_indices = norm, res


@contextlib.contextmanager
def _record_jax(calls: list):
    """The same record of the JAX engine, through ``jax.debug.callback``."""
    norm, res = j_core.normalize_log_weights, j_core.resample_indices

    def normalize(lw, *a, **k):
        out = norm(lw, *a, **k)
        jax.debug.callback(
            lambda x, w: calls.append(("norm", np.asarray(x),
                                       np.asarray(w))), lw, out[0])
        return out

    def resample(key, weights, method="systematic", num_alive=None):
        idx = res(key, weights, method=method, num_alive=num_alive)
        jax.debug.callback(
            lambda k, w, i: calls.append(("res", np.asarray(k),
                                          np.asarray(w), np.asarray(i))),
            jax.random.key_data(key), weights, idx)
        return idx

    j_core.normalize_log_weights, j_core.resample_indices = normalize, resample
    try:
        yield
    finally:
        j_core.normalize_log_weights, j_core.resample_indices = norm, res


def ulps(a, b) -> np.ndarray:
    """``(a - b)`` in units of ``b``'s float32 spacing."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return (a.astype(np.float64) - b) / np.spacing(np.abs(b))


def divergence(name: str, chain: int, keys: int = 512) -> dict:
    """The first divergent resample of one chain: the port's and JAX's
    weight-step records on it (module docstring)."""
    kw = VARIANTS[name]
    method = kw.get("resample_fn", "stratified")
    y = observations()
    kd = key_data(keys)
    p_calls, j_calls = [], []
    with _record_port(p_calls, method):
        ll_p = port_run(kd, y, kw)[chain]
    with _record_jax(j_calls):
        ll_j = float(_jax_fn(name)(jnp.asarray(kd[chain]), jnp.asarray(y)))
    jax.effects_barrier()
    plain = float(jax_run(name, kd[chain:chain + 1], y)[0])
    assert ll_j == plain, "the recorded JAX run is not the plain run"
    p_res = [c for c in p_calls if c[0] == "res"]
    j_res = [c for c in j_calls if c[0] == "res"]
    p_norm = [c for c in p_calls if c[0] == "norm"]
    j_norm = [c for c in j_calls if c[0] == "norm"]
    assert len(p_res) == len(j_res) and len(p_norm) == len(j_norm)
    # Each resample call follows its normalisation one for one.
    for call, (pr, jr) in enumerate(zip(p_res, j_res)):
        idx_p = pr[3][chain].numpy()
        idx_j = jr[3].astype(np.int64)
        if (idx_p != idx_j).any():
            break
    else:
        return {"variant": name, "chain": chain, "call": None,
                "ll_port": float(ll_p), "ll_jax": ll_j}
    lw_p = p_norm[call][1][chain].numpy()
    w_p = p_norm[call][2][chain].numpy()
    lw_j = j_norm[call][1]
    w_j = np.asarray(jax.jit(j_normalize_log_weights)(jnp.asarray(lw_j))[0])
    assert np.array_equal(w_j, j_norm[call][2]), "JAX weights rerun differ"
    cdf_j = np.asarray(jax.jit(lambda w: jnp.cumsum(w, axis=-1))(
        jnp.asarray(w_j)))
    cdf_p = torch.cumsum(torch.as_tensor(w_p), dim=-1).numpy()
    # JAX's CDF on the port's own weights: the summation order alone.
    cdf_jp = np.asarray(jax.jit(lambda w: jnp.cumsum(w, axis=-1))(
        jnp.asarray(w_p)))
    pos = p_res[call][4][chain].numpy()
    key_j = jax.random.wrap_key_data(jnp.asarray(j_res[call][1]))
    idx_rerun = np.asarray(jax.jit(
        functools.partial(j_resample_indices, method=method))(
            key_j, jnp.asarray(w_j)))
    idx_p = p_res[call][3][chain].numpy()
    idx_j = j_res[call][3].astype(np.int64)
    assert np.array_equal(idx_rerun, idx_j), "JAX resample rerun differs"
    assert np.array_equal(np.searchsorted(cdf_j, pos, side="left")
                          .clip(0, N - 1), idx_j), "positions differ"
    slots = np.nonzero(idx_p != idx_j)[0]
    rows = []
    for k in slots:
        lo, hi = sorted((int(idx_p[k]), int(idx_j[k])))
        # The entry the position falls on the two sides of: the lower of
        # the two ancestors. Lower-bound search: ancestor = first i with
        # cdf[i] >= pos, so cdf_port[lo] >= pos > cdf_jax[lo] or the
        # reverse.
        rows.append({
            "slot": int(k), "anc_port": int(idx_p[k]),
            "anc_jax": int(idx_j[k]), "pos": float(pos[k]), "entry": lo,
            "cdf_port": cdf_p[lo - 1:hi + 2].tolist(),
            "cdf_jax": cdf_j[lo - 1:hi + 2].tolist(),
            "cdf_ulps": ulps(cdf_p[lo], cdf_j[lo]).item(),
            "cdf_ulps_same_weights": ulps(cdf_p[lo], cdf_jp[lo]).item(),
            "between": bool(min(cdf_p[lo], cdf_j[lo]) < pos[k]
                            <= max(cdf_p[lo], cdf_j[lo])),
            "w_ulps": ulps(w_p[lo - 1:hi + 2], w_j[lo - 1:hi + 2]).tolist(),
            "lw_ulps": ulps(lw_p[lo - 1:hi + 2],
                            lw_j[lo - 1:hi + 2]).tolist(),
        })
    return {
        "variant": name, "chain": chain, "call": call,
        "calls_a_day": len(p_res) // T,
        "ll_port": float(ll_p), "ll_jax": ll_j,
        "lw_ulps_max": float(np.nanmax(np.abs(ulps(lw_p, lw_j)))),
        "w_ulps_max": float(np.nanmax(np.abs(ulps(w_p, w_j)))),
        "cdf_ulps_max": float(np.nanmax(np.abs(ulps(cdf_p, cdf_j)))),
        "slots": rows,
    }


def report(d: dict) -> None:
    print(f"  chain {d['chain']}: loglike port {d['ll_port']:.6f} "
          f"jax {d['ll_jax']:.6f}; first divergent resample call "
          f"{d['call']} (day {d['call'] // d['calls_a_day']}, "
          f"{d['calls_a_day']} a day); row max |ulps|: log-weights "
          f"{d['lw_ulps_max']:.0f}, weights {d['w_ulps_max']:.0f}, CDF "
          f"{d['cdf_ulps_max']:.0f}")
    for r in d["slots"]:
        print(f"    slot {r['slot']}: ancestor port {r['anc_port']} jax "
              f"{r['anc_jax']}, position {r['pos']!r}; CDF[{r['entry']}] "
              f"differs by {r['cdf_ulps']:+.0f} ulps "
              f"({r['cdf_ulps_same_weights']:+.0f} on the port's weights); "
              f"position between the two: {r['between']}")
        print(f"      CDF[{r['entry'] - 1}..] port {r['cdf_port']}")
        print(f"      CDF[{r['entry'] - 1}..] jax  {r['cdf_jax']}")
        print(f"      weights ulps {np.round(r['w_ulps'], 1).tolist()}; "
              f"log-weights ulps {np.round(r['lw_ulps'], 1).tolist()}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keys", type=int, default=512)
    ap.add_argument("--show", type=int, default=3,
                    help="flipped chains to dissect per variant")
    ap.add_argument("--variant", action="append", choices=list(VARIANTS))
    args = ap.parse_args(argv)
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    for name in args.variant or VARIANTS:
        ll_p, ll_j, bad = flips(name, args.keys)
        print(f"{name}: {len(bad)} of {args.keys} chains differ by more "
              f"than {TOL} in loglike (agree {1 - len(bad) / args.keys:.4f})"
              f"; chains {bad.tolist()}")
        for chain in bad[:args.show]:
            report(divergence(name, int(chain), args.keys))
    return 0


if __name__ == "__main__":
    sys.exit(main())
