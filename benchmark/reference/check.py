"""The comparison that decides ``correct`` for the sampling cells.

The timed path is ``sample_chains`` over a batched filter. The reference
cannot replay thousands of MH steps inside a run, so it follows the
program from the state a checked call starts from, and checks that start
by itself:

* entry: each chain's log-likelihood as the checked call received it is
  the filter's value at the chain's theta with the words of the step that
  last accepted (step 0, the initial evaluation, if none did); the step is
  read from the samples the window kept;
* steps: the first ``K`` MH steps of the checked call, replayed from the
  entry state with the reference's own filter and MH step: each
  proposal's log-likelihood against the value the program's filter
  returned, and each kept theta against the program's sample.

Numbers (each compared with a limit of its own): the widest gap in
log-likelihood, entry and steps apart (nats; two ``-inf`` agree, one
``-inf`` or a NaN is an infinite gap), and the widest relative gap of a
kept parameter.

Imports nothing of the system under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import lowbias, mh, smc


def ll_gap(got, want) -> float:
    got = got.double()
    want = want.double()
    both_neg_inf = (got == -math.inf) & (want == -math.inf)
    gap = (got - want).abs()
    gap = torch.where(both_neg_inf, 0.0, gap)
    gap = torch.where(torch.isnan(gap), math.inf, gap)
    return float(gap.max()) if gap.numel() else 0.0


def theta_gap(got, want) -> float:
    got = torch.as_tensor(got).double()
    want = torch.as_tensor(want).double()
    gap = (got - want).abs() / want.abs().clamp_min(1e-6)
    gap = torch.where(torch.isnan(gap), math.inf, gap)
    return float(gap.max()) if gap.numel() else 0.0


def last_accept_steps(theta0, history) -> np.ndarray:
    """``[C]`` the last step whose MH step moved each chain's theta (0,
    the initial evaluation, if none did). ``history`` lists ``(first step,
    samples [C, k, P])`` of the calls before the checked one, in order;
    sample ``j`` of a call is theta after its step ``first + j``."""
    c = theta0.shape[0]
    found = np.zeros(c, dtype=np.int64)
    open_ = np.ones(c, dtype=bool)
    for i in range(len(history) - 1, -1, -1):
        first, block = history[i]
        before = history[i - 1][1][:, -1:] if i > 0 else theta0[:, None]
        traj = np.concatenate([before, block], axis=1)
        moved = (traj[:, 1:] != traj[:, :-1]).any(axis=2)      # [C, k]
        has = moved.any(axis=1) & open_
        last = moved.shape[1] - 1 - np.argmax(moved[:, ::-1], axis=1)
        found[has] = first + last[has]
        open_ &= ~has
        if not open_.any():
            break
    return found


class SamplingCheck:
    """The reference side of one sampling cell: its model, filter path,
    observations and MH settings."""

    def __init__(self, model, path: str, y, particles: int, lanes: int,
                 factors, prior_fns, transforms, device, dt=torch.float32):
        self.model = model
        self.path = path
        self.lanes = int(lanes)
        self.dt = dt
        self.device = torch.device(device)
        obs = model.sweep_obs if path == "sweep" else model.engine_obs
        self.ys = obs(y, self.device, dt)
        self.n = torch.full((1,), float(particles), dtype=dt,
                            device=self.device)
        self.factors = torch.as_tensor(np.asarray(factors), dtype=dt,
                                       device=self.device)
        self.prior_fns = prior_fns
        self.transforms = tuple(transforms)
        self.tally = smc.Tally()
        self.filter_calls = 0

    def words(self, seed: int, chains: int):
        """The chains' MH stream words from the root seed."""
        return lowbias.chain_words(seed, chains, self.device)

    def filt(self, seed_words, theta):
        """Log-likelihood ``[C]`` at ``theta [C, P]`` from seed words."""
        self.filter_calls += 1
        run = (smc.sweep_filter if self.path == "sweep"
               else smc.engine_filter)
        return run(self.model, seed_words, self.ys, theta.to(self.dt),
                   self.n, self.lanes, dt=self.dt, tally=self.tally)

    def replay(self, words, entry_theta, entry_ll, entry_step: int,
               steps: int):
        """``(ll_props [K, C], thetas [K, C, P])`` of the MH steps after
        ``entry_step``."""
        theta = entry_theta.to(self.device, self.dt)
        ll = entry_ll.to(self.device, self.dt)
        lls, thetas = [], []
        for s in range(1, steps + 1):
            theta, ll, ll_prop = mh.mh_step(
                self.filt, words, entry_step + s, theta, ll, self.factors,
                self.prior_fns, self.transforms)
            lls.append(ll_prop)
            thetas.append(theta)
        return torch.stack(lls), torch.stack(thetas)

    def entry_ll(self, words, theta0, history, entry_theta):
        """The reference's log-likelihood of each chain's entry state, and
        the step each chain's value comes from."""
        steps = torch.as_tensor(last_accept_steps(theta0, history),
                                device=self.device)
        seed = lowbias.step_words(words, steps, 2)
        return self.filt(seed, entry_theta.to(self.device, self.dt)), steps

    def compare(self, seed: int, theta0, history, checked) -> dict:
        """Numbers of one checked call. ``checked`` holds the program's
        ``entry_step``, ``entry_theta [C, P]``, ``entry_ll [C]``,
        ``ll_props`` (the first ``K`` filter outputs, ``[K, C]``) and
        ``samples`` (``[C, k, P]``, theta after each step)."""
        c = checked["entry_theta"].shape[0]
        words = self.words(seed, c)
        ll_entry, from_steps = self.entry_ll(words, theta0, history,
                                             checked["entry_theta"])
        k = checked["ll_props"].shape[0]
        ll_props, thetas = self.replay(words, checked["entry_theta"],
                                       checked["entry_ll"],
                                       checked["entry_step"], k)
        samples = torch.as_tensor(checked["samples"][:, :k]).permute(1, 0, 2)
        return {
            "entry_ll_gap": ll_gap(checked["entry_ll"].cpu(),
                                   ll_entry.cpu()),
            "step_ll_gap": ll_gap(checked["ll_props"].cpu(),
                                  ll_props.float().cpu()),
            "theta_gap": theta_gap(samples, thetas.float().cpu()),
            "_chains": c,
            "_steps": k,
            "_entry_from_step0": int((from_steps == 0).sum()),
        }
