"""K3's engine day (``ops/resampling_fused.py``) in its plain version on
the CPU: given the running log-likelihood, dead flags and ``log n``, one
call is the engine's whole weight step, equal to the ops that ran around
K3 before (``tests/_k3_parent_day.py``); without them it is the step as
it was. The engine's counters ``engine.days`` and ``engine.k3_days``."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from bayesssm_tpu_torch.filters import (
    auxiliary_filter,
    bootstrap_filter,
    resample_move_filter,
)
from bayesssm_tpu_torch.models.sinusoidal import (
    simulate_sinusoidal,
    sinusoidal_model,
)
from bayesssm_tpu_torch.models.sir import simulate_sir, sir_model
from bayesssm_tpu_torch.ops.merge_select import select_index
from bayesssm_tpu_torch.ops.resampling import _positions
from bayesssm_tpu_torch.ops.resampling_fused import (
    fused_weight_resample,
    fused_weight_resample_reference,
    fused_weight_resample_seeded,
    inkernel_positions,
)
from bayesssm_tpu_torch.ops.sweep_builder import running_cdf, tree_sum
from bayesssm_tpu_torch.utils import timing

from _k3_parent_day import (
    day_case,
    old_bootstrap_filter,
    old_weight_step,
)

torch.set_num_threads(1)


def _words(c, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(
        rng.integers(0, 2**32, (c, 2), dtype=np.uint64).astype(np.int64))


def _old_reference(lw, parts, uni, thr, *, positions=None, key_words=None,
                   num_alive=None, method=None, always_resample=False):
    """The plain weight step as it was before the engine's day."""
    n = lw.shape[1]
    mx = torch.amax(lw, dim=1, keepdim=True)
    shifted = torch.exp(lw - mx)
    s = tree_sum(shifted)
    w = shifted / s
    ess = (1.0 / tree_sum(w * w))[:, 0]
    lse = (mx + torch.log(s))[:, 0]
    lane = torch.arange(n)
    last_alive = torch.amax(torch.where(uni > 0.0, lane, 0), dim=1,
                            keepdim=True)
    cdf = torch.where(lane >= last_alive, 1.5, running_cdf(w))
    pos = (positions if method is None
           else inkernel_positions(key_words, method, n, num_alive))
    m = select_index(cdf, pos)
    res = torch.gather(parts, 1, m[..., None].expand_as(parts))
    if always_resample:
        return res, uni, ess, lse
    do = (ess < thr)[:, None]
    return (torch.where(do[..., None], res, parts),
            torch.where(do, uni, w), ess, lse)


def _same(a, b):
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


@pytest.mark.parametrize("route", ["seeded", "host"])
@pytest.mark.parametrize("always", [False, True])
@pytest.mark.parametrize("n, d", [(128, 2), (1024, 1), (20, 3)])
def test_the_day_arguments_given_as_nothing_reproduce_the_step(route, always,
                                                               n, d):
    lw, parts, uni, alive, words, _, _ = day_case(8, n, d, n - n // 8, n)
    lw = torch.clamp_min(torch.where(
        torch.arange(n) < alive[:, None], lw, -math.inf), -1e30)
    thr = alive / 2.0
    if route == "seeded":
        got = fused_weight_resample_seeded(
            lw, parts, words, alive, uni, thr, "systematic", always,
            loglike=None, dead=None, log_n=None)
        want = _old_reference(lw, parts, uni, thr, key_words=words,
                              num_alive=alive, method="systematic",
                              always_resample=always)
    else:
        pos = _positions(words, "stratified", n, alive)
        got = fused_weight_resample(lw, parts, pos, uni, thr, always,
                                    num_alive=None, loglike=None)
        want = _old_reference(lw, parts, uni, thr, positions=pos,
                              always_resample=always)
    assert len(got) == 4
    assert all(_same(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("always", [False, True])
@pytest.mark.parametrize("n, d, alive_n", [(128, 2, 128), (1024, 1, 1000),
                                            (128, 3, 100)])
def test_the_day_equals_the_engine_ops_around_the_step(always, n, d,
                                                       alive_n):
    c = 8
    lw, parts, uni, alive, words, loglike, dead = day_case(
        c, n, d, alive_n, 3 * n + d)
    thr = torch.zeros(c) if always else alive / 2.0
    log_n = torch.log(alive)
    dead_day = dead.clone()
    p, w, _, _, ll, rec, est = fused_weight_resample_seeded(
        lw, parts, words, alive, uni, thr, "stratified", always,
        loglike=loglike, dead=dead_day, log_n=log_n, estimate=True)
    p_o, w_o, rec_o, ll_o, dead_o = old_weight_step(
        lw, parts, words, loglike, dead, alive, log_n, uni, thr, always)
    for a, b in ((p, p_o), (w, w_o), (rec, rec_o), (ll, ll_o),
                 (dead_day, dead_o)):
        assert _same(a, b)
    assert dead_day[2] and dead_day[5] and not dead_day[0]
    assert ll[2] == -math.inf and rec[2] == 0 and not w[2].any()
    assert not est[2].any() and not est[5].any()
    ok = ~torch.isnan(est).any(dim=1)
    want = torch.einsum("cn,cnd->cd", w_o, p_o)
    torch.testing.assert_close(est[ok], want[ok], rtol=1e-5, atol=1e-6)
    # The estimate is the halving tree over the kernel's lanes.
    assert torch.equal(est[ok], tree_sum(
        (w[..., None] * p).transpose(1, 2))[..., 0][ok])
    # Host positions take the same day.
    pos = _positions(words, "stratified", n, alive)
    dead_h = dead.clone()
    got_h = fused_weight_resample(lw, parts, pos, uni, thr, always,
                                  num_alive=alive, loglike=loglike,
                                  dead=dead_h, log_n=log_n)
    want_h = fused_weight_resample_reference(
        torch.clamp_min(torch.where(torch.arange(n) < alive[:, None], lw,
                                    -math.inf), -1e30),
        parts, uni, thr, positions=pos, always_resample=always)
    assert got_h[6] is None and torch.equal(dead_h, dead_day)
    assert _same(got_h[0], want_h[0])
    assert _same(got_h[1], torch.where(dead_h[:, None], 0.0, want_h[1]))


def _sinusoidal():
    _, y = simulate_sinusoidal(1405, 6)
    fns, _, _ = sinusoidal_model()
    return y, fns, dict(phi=0.8, sigma_x=1.0, sigma_y=0.5)


def _sir():
    _, y = simulate_sir(seed=7, n_total=100, init_infected=10, t_max=4)
    fns, _, _ = sir_model(100, 10, transition="gillespie")
    return y, fns, dict(lam=0.4, gamma=0.25)


@pytest.mark.parametrize("model", [_sinusoidal, _sir])
@pytest.mark.parametrize("resample_algorithm", ["SISAR", "SISR"])
def test_the_engine_day_is_the_former_route_chain_for_chain(
        model, resample_algorithm):
    y, fns, theta = model()
    words = _words(16, 11)
    res = bootstrap_filter(words, y, 128, *fns, theta=theta,
                           resample_algorithm=resample_algorithm,
                           use_fused="interpret-inkernel")
    ll, lls, ess, ph, wh, st = old_bootstrap_filter(
        words, y, 128, *fns, theta=theta,
        always=resample_algorithm == "SISR")
    assert torch.equal(res.loglike, ll)
    assert torch.equal(res.loglike_history, lls)
    assert torch.equal(res.ess, ess)
    assert torch.equal(res.particles_history, ph)
    assert torch.equal(res.weights_history, wh)
    torch.testing.assert_close(res.state_est, st, rtol=1e-5, atol=1e-5)


def _days(run):
    before = timing.counters()
    run()
    after = timing.counters()
    return tuple(after.get(k, 0) - before.get(k, 0)
                 for k in ("engine.days", "engine.k3_days"))


@pytest.mark.parametrize("route, k3", [
    (dict(use_fused="interpret-inkernel"), True),
    (dict(use_fused="interpret"), True),
    (dict(use_fused=False), False),
    (dict(use_fused="interpret-inkernel", carry_weights=True), False),
])
def test_the_engine_counts_its_days_and_those_k3_took_whole(route, k3):
    y, fns, theta = _sinusoidal()
    days = _days(lambda: bootstrap_filter(_words(4, 2), y, 128, *fns,
                                          theta=theta, **route))
    assert days == (len(y), len(y) if k3 else 0)


def test_apf_takes_the_whole_day_and_rmpf_all_but_the_estimate():
    """Both count every day as K3's: RMPF's estimate follows its move, but
    its mask, dead check, log-likelihood and ESS record are K3's."""
    from bayesssm_tpu_torch.models.sir import (
        sir_aux_log_likelihood_fn,
        sir_move_fn,
    )

    y, fns, theta = _sir()
    words = _words(4, 5)
    apf = _days(lambda: auxiliary_filter(
        words, y, 128, *fns, aux_log_likelihood_fn=sir_aux_log_likelihood_fn,
        theta=theta, use_fused="interpret-inkernel"))
    rmpf = _days(lambda: resample_move_filter(
        words, y, 128, *fns, move_fn=sir_move_fn(100), theta=theta,
        use_fused="interpret-inkernel"))
    assert apf == (len(y), len(y))
    assert rmpf == (len(y), len(y))


@pytest.mark.parametrize("route", ["wrapper", "key_words", "positions"])
def test_the_day_without_counts_is_refused(route):
    c, n = 3, 8
    lw, parts = torch.zeros((c, n)), torch.zeros((c, n, 1))
    uni, thr = torch.full((c, n), 1.0 / n), torch.zeros(c)
    day = dict(loglike=torch.zeros(c), dead=torch.zeros(c, dtype=torch.bool),
               log_n=torch.full((c,), math.log(n)))
    with pytest.raises(ValueError, match="num_alive"):
        if route == "wrapper":
            fused_weight_resample(lw, parts, torch.zeros((c, n)), uni, thr,
                                  **day)
        elif route == "key_words":
            fused_weight_resample_reference(lw, parts, uni, thr,
                                            key_words=_words(c, 3),
                                            method="stratified", **day)
        else:
            fused_weight_resample_reference(lw, parts, uni, thr,
                                            positions=torch.zeros((c, n)),
                                            **day)
