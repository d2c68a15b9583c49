"""The plain fused weight step (K3, ``ops/resampling_fused.py``) against
the JAX kernel under the Pallas interpreter, per chain.

Each JAX reference is an UN-vmapped ``interpret=True`` call (one chain per
program, whose in-kernel position stream the port reproduces). Selection
copies values, so the resampled columns must be equal; the merge network
and the quadratic bucket test pick the same ancestors. Weights, ESS and
log-sum-exp agree to rtol 1e-6: the JAX kernel sums over lanes in XLA's
order, the port in the kernel's halving tree, a few ulps apart.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from bayesssm_tpu.ops.resampling_pallas import (
    fused_weight_resample as j_fused,
    fused_weight_resample_seeded as j_seeded,
)
from bayesssm_tpu_torch.ops.resampling import _positions
from bayesssm_tpu_torch.ops.resampling_fused import (
    fused_weight_resample,
    fused_weight_resample_reference,
    fused_weight_resample_seeded,
    inkernel_positions,
)

torch.set_num_threads(1)

N = 128
CHAINS = 3
METHODS = ("stratified", "systematic", "multinomial")


def _case(d, masked, seed):
    """Per-chain inputs: weight spreads from flat to peaked (so adaptive
    chains both resample and not), masked lanes in the second half."""
    rng = np.random.default_rng(seed)
    alive = (np.array([N, 77, 100]) if masked
             else np.full(CHAINS, N)).astype(np.float32)
    lane = np.arange(N)
    live = lane[None, :] < alive[:, None]
    scale = np.array([0.05, 1.5, 3.0])[:, None]
    lw = np.where(live, scale * rng.normal(size=(CHAINS, N)), -1e30)
    parts = rng.normal(size=(CHAINS, N, d))
    uni = np.where(live, 1.0 / alive[:, None], 0.0)
    thr = alive * 0.6
    kd = np.stack([np.asarray(jax.random.key_data(jax.random.key(seed + k)))
                   for k in range(CHAINS)])
    f32 = np.float32
    return (lw.astype(f32), parts.astype(f32), uni.astype(f32),
            thr.astype(f32), alive, kd)


@functools.lru_cache(maxsize=None)
def _j_host(always, selection):
    return jax.jit(lambda lw, p, pos, u, thr: j_fused(
        lw, p, pos, u, thr, always_resample=always, interpret=True,
        selection=selection))


@functools.lru_cache(maxsize=None)
def _j_seeded(method, always):
    return jax.jit(lambda lw, p, kd, alive, u, thr: j_seeded(
        lw, p, jax.random.wrap_key_data(kd), alive, u, thr, method=method,
        always_resample=always, interpret=True))


def _compare(got, want, alive=None):
    """``alive`` limits the column check to the alive slots of each chain:
    the JAX kernel's quadratic selection sums every bucket a position
    falls in, and the parallel scan can lift the CDF by an ulp past the
    last alive lane, so a masked slot (position 1.0) may come out as the
    sum of two particles there. That is a JAX-package defect the port
    does not copy (ROADMAP Queue 3); the engine never reads those slots.
    """
    pout, wout, ess, lse = (x.numpy() for x in got)
    for c, (jp, jw, je, jl) in enumerate(want):
        k = pout.shape[1] if alive is None else int(alive[c])
        same = pout[c, :k] == np.asarray(jp)[:k]
        # An ulp tie between the two CDFs may flip a slot's ancestor; name
        # it, and hold every other slot to equality.
        flipped = np.flatnonzero(~same.all(axis=-1))
        assert len(flipped) <= 1, (c, flipped)
        np.testing.assert_allclose(wout[c], np.asarray(jw), rtol=1e-6,
                                   atol=1e-12)
        np.testing.assert_allclose(ess[c], float(je), rtol=1e-6)
        np.testing.assert_allclose(lse[c], float(jl), rtol=1e-6)
    return pout


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("always", [False, True])
@pytest.mark.parametrize("method", METHODS)
def test_host_positions_match_jax(method, always, d):
    lw, parts, uni, thr, alive, kd = _case(d, True, 10 * d + always)
    words = torch.as_tensor(kd.astype(np.int64))
    pos = _positions(words, method, N, torch.as_tensor(alive))
    selections = (("merge", "quadratic") if method != "multinomial"
                  else ("quadratic",))
    got = fused_weight_resample(lw, parts, pos, uni, thr, always)
    for selection in selections:
        fn = _j_host(always, selection)
        want = [fn(lw[c], parts[c], pos[c].numpy(), uni[c], thr[c])
                for c in range(CHAINS)]
        _compare(got, want, alive if selection == "quadratic" else None)


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("always", [False, True])
@pytest.mark.parametrize("method", METHODS)
def test_inkernel_positions_match_jax(method, always, masked, d):
    lw, parts, uni, thr, alive, kd = _case(d, masked, 3 + d)
    got = fused_weight_resample_seeded(
        lw, parts, torch.as_tensor(kd.astype(np.int64)), alive, uni, thr,
        method, always)
    fn = _j_seeded(method, always)
    want = [fn(lw[c], parts[c], kd[c], alive[c], uni[c], thr[c])
            for c in range(CHAINS)]
    # The JAX kernel selects multinomial positions by the quadratic test.
    pout = _compare(got, want, alive if method == "multinomial" else None)
    if not always:
        # The flat chain keeps its particles; the peaked one resamples.
        np.testing.assert_array_equal(pout[0], parts[0])
        assert not np.array_equal(pout[2], parts[2])


def test_inkernel_positions_are_the_kernels_stream():
    """Masked slots sit at 1.0; systematic shares lane 0's offset."""
    kd = torch.tensor([[1, 2], [3, 2**32 - 1]], dtype=torch.int64)
    alive = torch.tensor([128.0, 50.0])
    strat = inkernel_positions(kd, "stratified", N, alive)
    syst = inkernel_positions(kd, "systematic", N, alive)
    assert (strat[1, 50:] == 1.0).all() and (syst[1, 50:] == 1.0).all()
    lane = torch.arange(N, dtype=torch.float32)
    np.testing.assert_array_equal(
        syst[0].numpy(), ((lane + strat[0, 0] * 128.0) / 128.0).numpy())
    assert (torch.diff(strat[0]) > 0).all()


def test_routes_and_validation():
    lw, parts, uni, thr, alive, kd = _case(2, True, 1)
    words = torch.as_tensor(kd.astype(np.int64))
    pos = _positions(words, "stratified", N, torch.as_tensor(alive))
    # On CPU tensors the public functions are the plain version.
    a = fused_weight_resample(lw, parts, pos, uni, thr)
    b = fused_weight_resample_reference(lw, parts, uni, thr, positions=pos)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="unknown resampling method"):
        fused_weight_resample_seeded(lw, parts, words, alive, uni, thr,
                                     "metropolis")
    with pytest.raises(ValueError, match="particles must be"):
        fused_weight_resample(lw, parts[:, :5], pos, uni, thr)
    with pytest.raises(ValueError, match="at most 1024 lanes"):
        fused_weight_resample(np.zeros((1, 2048), np.float32),
                              np.zeros((1, 2048, 1), np.float32),
                              np.zeros((1, 2048), np.float32),
                              np.zeros((1, 2048), np.float32), 0.0)
