"""The invariant the Hopper event kernels rest on, on the plain version.

``ops/gillespie.py::gillespie_day`` runs a chain's lanes together, in
groups of ``unroll`` attempts, while any lane of the chain is active.
K4 (``csrc/gillespie.cu``) and K1's SIR transition run each lane on its
own instead (``csrc/models.cuh::sir_lane``) and K1 takes one block
maximum for the chain's counter. That is right only if

* a lane's S and I depend on its own key, state and rates alone, so the
  batched day equals the same lanes run one per chain, and
* the chain's counter after the day is ``ctr0 + 2 unroll max_l
  ceil(attempts_l / unroll)``, with each lane's attempts as
  ``sir_lane`` counts them: up to and including the one that ends it, at
  most ``unroll ceil(MAX_EVENTS / unroll)``.

Both sides run the same float32 operations on the same draws, so the
tolerance is exact equality. Plain PyTorch only: no card, ``nvcc`` or
``triton`` is needed.
"""

import numpy as np
import pytest
import torch

from bayesssm_tpu_torch.ops import gillespie
from bayesssm_tpu_torch.ops.gillespie import gillespie_day
from bayesssm_tpu_torch.ops.rng import lane_keys, uniform_blocks

torch.set_num_threads(1)

C, N, N_TOTAL = 6, 64, 500


def _case(seed, ctr0=0, dead_chain=True):
    """Keys, counters, S, I and rates of C chains of N lanes: I from 0 to
    119 (a wide spread of attempts a lane), one chain with I = 0
    everywhere, and a heavy lane (S = 380, I = 120) in every chain."""
    rng = np.random.default_rng(seed)
    s = rng.integers(250, 431, size=(C, N))
    i = np.minimum(rng.integers(0, 120, size=(C, N)), N_TOTAL - s)
    i[:, rng.integers(0, N, size=C)] = 1
    s[:, -1], i[:, -1] = 380, 120
    if dead_chain:
        i[2] = 0
    words = torch.as_tensor(
        rng.integers(0, 2**32, size=(C, 2), dtype=np.uint64).astype(np.int64))
    lam = torch.as_tensor(rng.uniform(0.3, 0.9, (C, 1)).astype(np.float32))
    gam = torch.as_tensor(rng.uniform(0.1, 0.35, (C, 1)).astype(np.float32))
    inv_nt = float(np.float32(1.0 / N_TOTAL))
    return (lane_keys(words, N), torch.full((C, 1), ctr0, dtype=torch.int64),
            torch.as_tensor(s.astype(np.float32)),
            torch.as_tensor(i.astype(np.float32)), lam * inv_nt, gam)


def _lane_local(keys, ctr0, s, i, lam_n, gam, t_end, cap):
    """``sir_lane`` on every lane at once: attempt a of a lane draws
    counters ctr0 + 2a and ctr0 + 2a + 1, and the lane stops after the
    attempt that leaves it inactive or at ``cap``. Returns (s, i,
    attempts)."""
    tloc = torch.zeros_like(s)
    active = i > 0.0
    a = torch.zeros_like(s, dtype=torch.int64)
    while True:
        go = active & (a < cap)
        if not bool(go.any()):
            return s, i, a
        u0, u1 = uniform_blocks(keys, ctr0 + 2 * a, 2)
        rate_inf = lam_n * s * i
        rate_tot = rate_inf + gam * i
        dt = -torch.log1p(-u0) * (1.0 / rate_tot)
        t_new = tloc + dt
        fire = go & (t_new <= t_end)
        infect = u1 * rate_tot < rate_inf
        s = torch.where(fire & infect, s - 1.0, s)
        i = torch.where(fire, torch.where(infect, i + 1.0, i - 1.0), i)
        tloc = torch.where(fire, t_new, tloc)
        active = torch.where(go, fire & (i > 0.0), active)
        a = a + go


def _one_per_chain(keys, ctr, s, i, lam_n, gam, t_end, unroll):
    """The same lanes as C x N chains of one lane each."""
    def flat(x):
        return x.expand(C, N).reshape(C * N, 1)

    s1, i1, ctr1 = gillespie_day(flat(keys), flat(ctr), flat(s), flat(i),
                                 flat(lam_n), flat(gam), t_end, unroll)
    return s1.reshape(C, N), i1.reshape(C, N), ctr1.reshape(C, N)


def _check(keys, ctr, s, i, lam_n, gam, t_end, unroll, cap):
    s_b, i_b, ctr_b = gillespie_day(keys, ctr, s, i, lam_n, gam, t_end,
                                    unroll)
    s_1, i_1, ctr_1 = _one_per_chain(keys, ctr, s, i, lam_n, gam, t_end,
                                     unroll)
    assert torch.equal(s_b, s_1) and torch.equal(i_b, i_1)
    # The chain's counter from the one-lane runs' attempts.
    att_1 = (ctr_1 - ctr) // 2
    groups = -(-att_1 // unroll)
    want = ctr + 2 * unroll * groups.amax(dim=1, keepdim=True)
    assert torch.equal(ctr_b, want)
    # sir_lane: the same S and I, and attempts that round up to the
    # one-lane runs' groups.
    s_l, i_l, att_l = _lane_local(keys, ctr, s, i, lam_n, gam, t_end, cap)
    assert torch.equal(s_l, s_b) and torch.equal(i_l, i_b)
    assert torch.equal(-(-att_l // unroll), groups)
    assert int(att_l.max()) <= cap
    return s_b, i_b, att_l


@pytest.mark.parametrize("t_end,unroll", [(1.0, 8), (0.5, 4), (1.0, 3)])
@pytest.mark.parametrize("ctr0", [0, 4242])
def test_lanes_are_independent(t_end, unroll, ctr0):
    keys, ctr, s, i, lam_n, gam = _case(7 + unroll, ctr0)
    cap = unroll * -(-gillespie.MAX_EVENTS // unroll)
    s_b, i_b, att = _check(keys, ctr, s, i, lam_n, gam, t_end, unroll, cap)
    # The dead chain ran no attempt and kept its state; the others moved,
    # and their lanes stopped at many different attempt counts.
    assert int(att[2].max()) == 0
    assert torch.equal(s_b[2], s[2]) and torch.equal(i_b[2], i[2])
    assert not torch.equal(i_b, i)
    assert len(torch.unique(att[0])) > 10


def test_event_cap_rounds_up_to_whole_groups(monkeypatch):
    """A cap that is not a multiple of ``unroll`` runs whole groups: 13
    events at unroll 4 cap a lane at 16 attempts, and the heavy lanes
    reach it."""
    monkeypatch.setattr(gillespie, "MAX_EVENTS", 13)
    keys, ctr, s, i, lam_n, gam = _case(3, ctr0=100, dead_chain=False)
    _, _, att = _check(keys, ctr, s, i, lam_n, gam, 1.0, 4, 16)
    assert int(att.max()) == 16
    assert bool((att[:, -1] == 16).all())
