"""Elementwise pieces of the port against the JAX package, to f32
rounding (rtol = atol = 1e-6): distributions, priors, transforms in both
Q1 conventions, weights; plus the NumPy copies (simulators, Kalman)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesssm_tpu.models.distributions as jd
import bayesssm_tpu.ops.weights as jw
import bayesssm_tpu.pmmh.priors as jp
import bayesssm_tpu.pmmh.transforms as jt
import bayesssm_tpu_torch.models.distributions as td
import bayesssm_tpu_torch.ops.weights as tw
import bayesssm_tpu_torch.pmmh.priors as tp
import bayesssm_tpu_torch.pmmh.transforms as tt

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-6)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _x(seed, n=257, lo=-3.0, hi=3.0):
    x = np.random.default_rng(seed).uniform(lo, hi, n).astype(np.float32)
    x[:3] = [0.0, lo, hi]
    return x


@pytest.mark.parametrize("name,args", [
    ("norm_logpdf", (0.3, 1.7)),
    ("exp_logpdf", (2.0,)),
    ("unif_logpdf", (-1.0, 1.0)),
    ("halfnorm_logpdf", (2.0,)),
    ("beta_logpdf", (2.0, 3.0)),
])
def test_distributions(name, args):
    x = _x(1, lo=-1.5, hi=1.5)
    _close(getattr(td, name)(torch.as_tensor(x), *args),
           getattr(jd, name)(jnp.asarray(x), *args))


def test_pois_logpmf_including_zero_rate():
    rng = np.random.default_rng(2)
    k = rng.integers(0, 40, 300).astype(np.float32)
    rate = rng.uniform(0.0, 40.0, 300).astype(np.float32)
    rate[:50] = 0.0
    k[:25] = 0.0
    got = td.pois_logpmf(torch.as_tensor(k), torch.as_tensor(rate))
    want = jd.pois_logpmf(jnp.asarray(k), jnp.asarray(rate))
    # lgamma differs between the two libraries by a few f32 ulps.
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-4)
    assert np.array_equal(np.isinf(np.asarray(got)),
                          np.isinf(np.asarray(want)))


@pytest.mark.parametrize("theta", [[0.5, 0.2], [-0.1, 0.2], [0.5, np.nan]])
def test_sum_log_priors(theta):
    def jprior(v):
        return jnp.where(v > 0.3, jnp.nan, jd.halfnorm_logpdf(v, 2.0))

    def tprior(v):
        return torch.where(v > 0.3, torch.nan, td.halfnorm_logpdf(v, 2.0))

    th = np.asarray(theta, np.float32)
    want = jp.sum_log_priors(
        jnp.asarray(th), [lambda v: jd.halfnorm_logpdf(v, 1.0), jprior])
    got = tp.sum_log_priors(
        torch.as_tensor(th)[None], [lambda v: td.halfnorm_logpdf(v, 1.0),
                                    tprior])
    _close(got[0], want)


TRANSFORMS = ("identity", "log", "logit")


@pytest.mark.parametrize("convention", ["consistent", "reference"])
def test_transforms_and_jacobians(convention):
    rng = np.random.default_rng(4)
    theta = np.stack([
        rng.uniform(-2, 2, 64), rng.uniform(1e-3, 5, 64),
        rng.uniform(1e-3, 1 - 1e-3, 64),
    ], axis=1).astype(np.float32)
    tth = torch.as_tensor(theta)
    z = tt.transform_params(tth, TRANSFORMS)
    for c in range(theta.shape[0]):
        jth = jnp.asarray(theta[c])
        _close(z[c], jt.transform_params(jth, TRANSFORMS))
        _close(tt.back_transform_params(z, TRANSFORMS)[c],
               jt.back_transform_params(jnp.asarray(z[c].numpy()),
                                        TRANSFORMS))
        _close(tt.log_jacobian(tth, TRANSFORMS, convention)[c],
               jt.log_jacobian(jth, TRANSFORMS, convention))
    with pytest.raises(ValueError, match="convention"):
        tt.log_jacobian(tth, TRANSFORMS, "bogus")


def test_resolve_transforms_contract():
    names = ["a", "b"]
    assert tt.resolve_transforms(None, names) == ("identity", "identity")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = tt.resolve_transforms({"a": "log", "b": "cube"}, names)
    assert got == jt.resolve_transforms({"a": "log", "b": "identity"}, names)
    assert any("identity" in str(w.message) for w in rec)
    with pytest.raises(ValueError, match="every parameter"):
        tt.resolve_transforms({"a": "log"}, names)
    with pytest.raises(ValueError, match="dict"):
        tt.resolve_transforms(["log"], names)


@pytest.mark.parametrize("case", ["plain", "masked", "all_dead"])
def test_weights(case):
    lw = np.random.default_rng(5).normal(size=(4, 128)).astype(np.float32)
    if case == "masked":
        lw[:, 100:] = -np.inf
    elif case == "all_dead":
        lw[1] = -np.inf
    w, lse, mx = tw.normalize_log_weights(torch.as_tensor(lw))
    ess = tw.effective_sample_size(w)
    lme = tw.log_mean_exp(torch.as_tensor(lw), 100.0)
    for c in range(4):
        jw_, jlse, jmx = jw.normalize_log_weights(jnp.asarray(lw[c]))
        _close(w[c], jw_)
        _close(lse[c], jlse)
        _close(mx[c], jmx)
        _close(ess[c], jw.effective_sample_size(jw_))
        _close(lme[c], jw.log_mean_exp(jnp.asarray(lw[c]), 100.0))


def test_numpy_copies_match_the_jax_package():
    from bayesssm_tpu.models.lgss import simulate_lgss as j_lgss
    from bayesssm_tpu.models.sir import simulate_sir as j_sir
    from bayesssm_tpu.utils.kalman import kalman_loglik as j_kalman
    from bayesssm_tpu_torch.models.lgss import simulate_lgss
    from bayesssm_tpu_torch.models.sir import simulate_sir
    from bayesssm_tpu_torch.utils.kalman import kalman_loglik

    for a, b in zip(simulate_sir(seed=1405), j_sir(seed=1405)):
        np.testing.assert_array_equal(a, b)
    x, y = simulate_lgss(11, t_val=20)
    jx, jy = j_lgss(11, t_val=20)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    assert kalman_loglik(y, 0.9, 1.0, 0.6, 0.4) == j_kalman(
        y, 0.9, 1.0, 0.6, 0.4)


def test_model_priors_match():
    from bayesssm_tpu.models.lgss import lgss_model as j_lgss
    from bayesssm_tpu.models.sir import sir_model as j_sir
    from bayesssm_tpu_torch.models.lgss import lgss_model
    from bayesssm_tpu_torch.models.sir import sir_model

    for (_, lp, tr), (_, jlp, jtr) in ((sir_model(), j_sir()),
                                       (lgss_model(), j_lgss())):
        assert list(lp) == list(jlp) and tr == jtr
        for name in lp:
            for v in (-0.5, 0.0, 0.3, 1.7):
                _close(lp[name](torch.tensor(v)), jlp[name](jnp.float32(v)))


def test_model_factories_have_the_jax_signature():
    """``sir_model``/``lgss_model`` take the JAX arguments and return
    ``(model_fns, log_priors, param_transform)`` with the JAX model
    functions' argument names."""
    import inspect

    from bayesssm_tpu.models.lgss import lgss_model as j_lgss
    from bayesssm_tpu.models.sir import sir_model as j_sir
    from bayesssm_tpu_torch.models.lgss import lgss_model
    from bayesssm_tpu_torch.models.sir import sir_model

    def params(fn):
        return [(p.name, p.default)
                for p in inspect.signature(fn).parameters.values()]

    for port, ref, kw in ((sir_model, j_sir,
                           dict(transition="gillespie_pallas")),
                          (lgss_model, j_lgss, {})):
        assert params(port) == params(ref)
        fns, lp, tr = port(**kw)
        jfns, jlp, jtr = ref(**kw)
        assert len(fns) == len(jfns) == 3
        assert [params(f) for f in fns] == [params(f) for f in jfns]
        assert list(lp) == list(jlp) and tr == jtr
