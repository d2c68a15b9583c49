"""The engine's per-key contract with the JAX engine, as a share of chains.

The port's batched engine and an un-vmapped JAX call per key draw the
same streams, but their float32 log-weights, weights and CDFs differ by
ulps: ``exp``, ``log`` and the sums round differently between ATen and
XLA:CPU, and XLA picks its own order for ``jnp.cumsum`` (a reduce-window)
where ``torch.cumsum`` runs in sequence. A resample position that lands
within an ulp of a CDF step then picks the neighbouring ancestor, and the
chain's log-likelihood parts from there on. ``tests/_engine_flips.py``
finds such chains and dissects their first divergent resample: on every
flipped chain it printed, the CDF entry at the changed slot differed by
1 or 2 ulps and the slot's position lay between the two libraries' values
(most often equal to one of them).

So the contract is a share of chains. Measured at LGSS, 128 lanes,
T = 20, ``use_fused=False``, 512 keys (``_engine_flips.SEED``), chains
differing by more than 1e-4 in loglike: stratified SISR 1, multinomial
SISR 4, ``carry_weights`` 1, APF 10, RMPF 7. Each variant is held to its
measured count plus ``MARGIN`` chains (0.6% of 512), room for another
PyTorch or XLA build's rounding; a port fault that changes an operation's
form moves every chain, far past it.
"""

import numpy as np
import pytest
import torch

import _engine_flips as ef

torch.set_num_threads(1)

KEYS = 512
MEASURED = {"sisr-stratified": 1, "sisr-multinomial": 4, "carry-weights": 1,
            "apf": 10, "rmpf": 7}
MARGIN = 3
# A recorded flipped chain (stratified SISR, chain 132 of the 512 keys) and
# the largest CDF difference in ulps seen at a flip's entry.
FLIPPED = ("sisr-stratified", 132)
CDF_ULPS = 2


@pytest.mark.parametrize("name", list(ef.VARIANTS))
def test_share_of_chains_agreeing_with_jax(name):
    ll_p, ll_j, bad = ef.flips(name, KEYS)
    assert np.isfinite(ll_p).all() and np.isfinite(ll_j).all()
    assert len(bad) <= MEASURED[name] + MARGIN, (name, bad.tolist())


def test_a_flip_is_an_ulp_at_a_cdf_step():
    name, chain = FLIPPED
    d = ef.divergence(name, chain, KEYS)
    assert d["call"] is not None
    assert abs(d["ll_port"] - d["ll_jax"]) > ef.TOL
    assert d["slots"]
    for row in d["slots"]:
        assert 0 < abs(row["cdf_ulps"]) <= CDF_ULPS
        assert row["between"]
    # The row's CDFs agree to a few ulps everywhere, not only at the step.
    assert d["cdf_ulps_max"] <= 8
