"""The port's Metropolis resampler (``ops/resampling.py::
metropolis_resample_indices``) and the engine with
``resample_fn="metropolis"`` against the JAX package's, per key.

The resampler's draws are threefry ``split`` and ``uniform``, which the port
reproduces bit for bit, and its test is one float32 multiply and compare,
so its indices equal JAX's exactly, vmapped over keys or called for one
key. The engine is held to un-vmapped JAX filters per key on a model
whose draws and transition are exact (uniform steps), so its particles
agree exactly and its log-likelihood to 1e-5. The statistical tests
mirror ``tests/test_resampling.py`` (:141-186, ``TestMetropolisBias``,
:345-350) and ``tests/test_filter_core.py::test_all_resamplers_consistent``
on the port's own filters.
"""

import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesssm_tpu.filters.auxiliary import auxiliary_filter as j_apf
from bayesssm_tpu.filters.bootstrap import bootstrap_filter as j_bpf
from bayesssm_tpu.ops.resampling import (
    metropolis_resample_indices as j_metropolis,
)
from bayesssm_tpu_torch.filters import (
    auxiliary_filter,
    bootstrap_filter,
    particle_filter_core,
)
from bayesssm_tpu_torch.filters import core as engine
from bayesssm_tpu_torch.ops import threefry
from bayesssm_tpu_torch.ops.resampling import (
    metropolis_resample_indices,
    resample_indices,
)
from bayesssm_tpu_torch.utils.kalman import kalman_loglik

torch.set_num_threads(1)

KEYS = 4


def _key_data(first, count=KEYS):
    return np.stack([np.asarray(jax.random.key_data(jax.random.key(k)))
                     for k in range(first, first + count)])


def _words(kd):
    return torch.as_tensor(kd.astype(np.int64))


def _case(n, case, seed):
    """Weights ``[KEYS, n]`` and the keyword arguments of one case."""
    rng = np.random.default_rng(seed)
    w = rng.gamma(0.5, size=(KEYS, n)).astype(np.float32)
    kw = dict(num_steps=None, num_alive=None, num_out=None)
    if case == "steps":
        kw["num_steps"] = 300
    elif case == "alive":
        alive = rng.integers(max(1, n // 3), n + 1, size=KEYS).astype(
            np.float32)
        w[np.arange(n)[None, :] >= alive[:, None]] = 0.0
        kw["num_alive"] = alive
    elif case == "out":
        kw["num_out"] = max(1, n // 2 - 1)
    return w / w.sum(axis=1, keepdims=True), kw


@pytest.mark.parametrize("case", ["default", "steps", "alive", "out"])
@pytest.mark.parametrize("n", [8, 128, 200])
def test_indices_equal_jax_per_key(n, case):
    w, kw = _case(n, case, seed=n)
    kd = _key_data(10 * n)
    alive = kw["num_alive"]
    got = metropolis_resample_indices(
        _words(kd), torch.as_tensor(w), kw["num_steps"],
        None if alive is None else torch.as_tensor(alive), kw["num_out"])
    n_out = n if kw["num_out"] is None else kw["num_out"]
    assert got.shape == (KEYS, n_out) and got.dtype == torch.int64

    def one(key, wk, a):
        return j_metropolis(key, wk, num_steps=kw["num_steps"],
                            num_alive=None if alive is None else a,
                            num_out=kw["num_out"])

    keys = jax.random.wrap_key_data(jnp.asarray(kd))
    a_all = jnp.asarray(alive if alive is not None
                        else np.full(KEYS, n, np.float32))
    vmapped = np.asarray(jax.jit(jax.vmap(one))(keys, jnp.asarray(w), a_all))
    np.testing.assert_array_equal(got.numpy(), vmapped)
    single = jax.jit(one)
    for k in range(KEYS):
        np.testing.assert_array_equal(
            got[k].numpy(), np.asarray(single(keys[k], jnp.asarray(w[k]),
                                              a_all[k])))


def test_indices_do_not_depend_on_the_step_blocks(monkeypatch):
    """The draws made ahead in blocks give the indices of one block."""
    w, _ = _case(128, "default", seed=1)
    words = _words(_key_data(3))
    whole = metropolis_resample_indices(words, torch.as_tensor(w))
    from bayesssm_tpu_torch.ops import resampling

    monkeypatch.setitem(resampling.METROPOLIS_BLOCK_SLOTS, "cpu",
                        7 * 128 * KEYS)
    blocks = metropolis_resample_indices(words, torch.as_tensor(w))
    torch.testing.assert_close(whole, blocks, rtol=0, atol=0)


def _keys(seed, reps):
    return threefry.split(threefry.key(seed), reps)


def test_metropolis_resampler_frequencies():
    # tests/test_resampling.py:141-152: frequencies converge to the weights.
    w = torch.tensor([0.1, 0.2, 0.3, 0.4])
    reps = 4000
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        idx = metropolis_resample_indices(_keys(17, reps),
                                          w.expand(reps, 4), num_steps=64)
    counts = np.bincount(idx.numpy().ravel(), minlength=4)
    np.testing.assert_allclose(counts / (reps * 4), w.numpy(), atol=0.05)


def test_metropolis_masked_lanes_never_selected():
    # :155-168: num_alive restricts chain starts and proposals.
    w = torch.tensor([0.25, 0.25, 0.25, 0.25, 0.0, 0.0, 0.0, 0.0])
    idx = metropolis_resample_indices(_keys(3, 200), w.expand(200, 8),
                                      num_alive=4.0)
    assert int(idx.max()) <= 3
    counts = np.bincount(idx.numpy().ravel(), minlength=8)
    np.testing.assert_allclose(counts[:4] / counts.sum(), [0.25] * 4,
                               atol=0.05)


def test_metropolis_through_resample_indices():
    # :171-176: the generic entry point dispatches "metropolis".
    w = torch.tensor([[0.5, 0.3, 0.2]])
    idx = resample_indices(_keys(0, 1), w, method="metropolis")
    assert idx.shape == (1, 3)
    assert int(idx.max()) <= 2


def test_metropolis_resampler_atom():
    # :179-184.
    w = torch.tensor([[0.0, 0.0, 1.0, 0.0]])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        idx = metropolis_resample_indices(_keys(0, 1), w, num_steps=64)
    np.testing.assert_array_equal(idx.numpy(), np.full((1, 4), 2))


class TestMetropolisBias:
    """``tests/test_resampling.py::TestMetropolisBias`` on the port: an
    always-resample LGSS BPF with the JAX test's key schedule, ancestors
    from stratified resampling (the unbiased reference) or Metropolis
    chains of 32 and 256 steps; the same envelope."""

    A, SX, SY = 0.9, 1.0, 0.05
    N = 512
    T = 20
    CHAINS = 64

    @classmethod
    def _ys(cls):
        rng = np.random.default_rng(5)
        x = rng.normal()
        ys = []
        for _ in range(cls.T):
            x = cls.A * x + cls.SX * rng.normal()
            ys.append(x + cls.SY * rng.normal())
        return torch.tensor(ys, dtype=torch.float32)

    @classmethod
    def _mean_ll(cls, ys, method, num_steps=None, seed=0):
        n, c = cls.N, cls.CHAINS
        keys = _keys(seed, c)
        k0, key = threefry.split(keys).unbind(1)
        x = threefry.normal(k0, (n,))
        ll = torch.zeros(c)
        day_keys = threefry.split(key, cls.T)
        for t in range(cls.T):
            k1, k2 = threefry.split(day_keys[:, t]).unbind(1)
            x = cls.A * x + cls.SX * threefry.normal(k1, (n,))
            lw = (-0.5 * ((ys[t] - x) / cls.SY) ** 2 - math.log(cls.SY)
                  - 0.5 * math.log(2.0 * math.pi))
            mx = lw.amax(dim=1, keepdim=True)
            w = torch.exp(lw - mx)
            s = w.sum(dim=1, keepdim=True)
            ll = ll + (mx + torch.log(s))[:, 0] - math.log(n)
            w = w / s
            if method == "metropolis":
                idx = metropolis_resample_indices(k2, w, num_steps=num_steps)
            else:
                idx = resample_indices(k2, w, method="stratified")
            x = torch.gather(x, 1, idx)
        lls = ll.double().numpy()
        assert np.isfinite(lls).all()
        return lls.mean(), lls.std() / np.sqrt(c)

    def test_bias_envelope(self):
        ys = self._ys()
        ref, se_ref = self._mean_ll(ys, "stratified", seed=1)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m32, se32 = self._mean_ll(ys, "metropolis", 32, seed=2)
        m256, se256 = self._mean_ll(ys, "metropolis", 256, seed=3)
        bias32 = m32 - ref
        bias256 = m256 - ref
        noise = 4.0 * max(se_ref, se32, se256)
        assert 0.10 < bias32 < 1.5, (bias32, noise)
        assert abs(bias256) < 0.15, (bias256, noise)
        assert bias32 > bias256

    def test_warns_below_calibrated_default(self):
        w = torch.full((1, 512), 1.0 / 512.0)
        with pytest.warns(UserWarning, match="below") as rec:
            metropolis_resample_indices(_keys(0, 1), w, num_steps=32)
        assert str(rec[0].message) == (
            "metropolis resampling with num_steps=32 below the calibrated "
            "default 256: expect a log-likelihood bias of roughly "
            "35/num_steps = 1.09 nats (worse for concentrated weights)")


def test_metropolis_zero_steps_rejected():
    # :345-350, with the JAX message.
    w = torch.full((1, 8), 0.125)
    with pytest.raises(ValueError, match="num_steps") as got:
        metropolis_resample_indices(_keys(0, 1), w, num_steps=0)
    with pytest.raises(ValueError) as want:
        j_metropolis(jax.random.key(0), jnp.full((8,), 0.125), num_steps=0)
    assert str(got.value) == str(want.value)


# ---- the engine -------------------------------------------------------

# A walk of uniform steps: its draws are threefry uniforms, which both
# packages compute bit for bit, and its arithmetic is one rounding a step,
# so the particles agree exactly wherever the ancestors do.
def _j_init(key, num_particles):
    return jax.random.uniform(key, (num_particles,)) * 4.0 - 2.0


def _j_trans(key, particles):
    return particles + (jax.random.uniform(key, particles.shape) - 0.5)


def _j_lik(y, particles):
    return -0.5 * ((y - particles) / 0.5) ** 2


def _p_init(key, num_particles):
    return threefry.uniform(key, (num_particles,)) * 4.0 - 2.0


def _p_trans(key, particles):
    return particles + (threefry.uniform(key, (particles.shape[1],)) - 0.5)


def _p_lik(y, particles):
    return -0.5 * ((y - particles) / 0.5) ** 2


WALK_Y = np.array([0.3, -0.2, 0.8, 0.1, -0.5], dtype=np.float32)


@pytest.mark.parametrize("algo", ["SISR", "SISAR"])
@pytest.mark.parametrize("filt", ["bootstrap", "auxiliary"])
def test_engine_equals_jax_per_key(filt, algo):
    kd = _key_data(700)
    n = 16
    j_fn, p_fn, extra_j, extra_p = (
        (j_bpf, bootstrap_filter, {}, {}) if filt == "bootstrap" else
        (j_apf, auxiliary_filter, dict(aux_log_likelihood_fn=_j_lik),
         dict(aux_log_likelihood_fn=_p_lik)))
    f = jax.jit(lambda w: j_fn(
        jax.random.wrap_key_data(w), WALK_Y, n, _j_init, _j_trans, _j_lik,
        resample_fn="metropolis", resample_algorithm=algo, **extra_j))
    runs = [f(jnp.asarray(w)) for w in kd]
    res = p_fn(_words(kd), WALK_Y, n, _p_init, _p_trans, _p_lik,
               resample_fn="metropolis", resample_algorithm=algo, **extra_p)
    np.testing.assert_allclose(
        res.loglike.numpy(), np.stack([np.asarray(r.loglike) for r in runs]),
        rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        res.particles_history.numpy(),
        np.stack([np.asarray(r.particles_history) for r in runs]))


A, C, SX, SY = 0.9, 1.0, 0.6, 0.4


def _lgss_init(key, num_particles):
    return threefry.normal(key, (num_particles,))


def _lgss_trans(key, particles):
    return A * particles + SX * threefry.normal(key, (particles.shape[1],))


def _lgss_lik(y, particles):
    return -0.5 * (math.log(2 * math.pi * SY**2)
                   + ((y - C * particles) / SY) ** 2)


def test_all_resamplers_consistent_metropolis():
    """``tests/test_filter_core.py::test_all_resamplers_consistent`` for
    ``"metropolis"``: the mean of 8 keys' log-likelihoods at 2048
    particles, SISR, within 0.3 nats of the Kalman value."""
    rng = np.random.default_rng(1405)
    x, ys = rng.normal(), []
    for _ in range(25):
        x = A * x + SX * rng.normal()
        ys.append(C * x + SY * rng.normal())
    ys = np.array(ys)
    truth = kalman_loglik(ys, A, C, SX, SY)
    keys = jax.random.split(jax.random.key(4), 8)
    words = _words(np.asarray(jax.random.key_data(keys)))
    res = bootstrap_filter(words, ys, 2048, _lgss_init, _lgss_trans,
                           _lgss_lik, resample_fn="metropolis",
                           resample_algorithm="SISR", return_particles=False)
    lls = res.loglike.double().numpy()
    assert abs(lls.mean() - truth) < 0.3


@pytest.mark.parametrize("use_fused", ["auto", False])
def test_auto_never_takes_the_fused_step(monkeypatch, use_fused):
    """The JAX gate: ``"auto"`` (and ``False``) with Metropolis run the
    portable path, so K3's route is never called."""
    calls = []

    def refuse(*args, **kw):
        calls.append(kw)
        raise AssertionError("the fused weight step was called")

    monkeypatch.setattr(engine, "fused_weight_resample", refuse)
    monkeypatch.setattr(engine, "fused_weight_resample_seeded", refuse)
    kd = _key_data(800, 2)
    res = particle_filter_core(
        _words(kd), WALK_Y, 128, _p_init, _p_trans, _p_lik,
        resample_fn="metropolis", use_fused=use_fused,
        return_particles=False)
    assert not calls and np.isfinite(res.loglike.numpy()).all()


@pytest.mark.parametrize("use_fused", [True, "interpret",
                                       "interpret-inkernel"])
def test_explicit_fused_route_raises_the_jax_message(use_fused):
    kd = _key_data(900, 1)
    with pytest.raises(ValueError) as got:
        bootstrap_filter(_words(kd), WALK_Y, 128, _p_init, _p_trans, _p_lik,
                         resample_fn="metropolis", use_fused=use_fused)
    with pytest.raises(ValueError) as want:
        j_bpf(jax.random.wrap_key_data(jnp.asarray(kd[0])), WALK_Y, 128,
              _j_init, _j_trans, _j_lik, resample_fn="metropolis",
              use_fused=use_fused)
    assert str(got.value) == str(want.value)
