"""The comparison that decides ``correct`` for a whole ``pmmh()`` call.

The public call runs two phases (the program's RNG contract, restated
here): every chain ``c`` takes the key ``fold_in(threefry.key(seed), c)``;

* tuning: ``split(key)`` gives the pilot's first filter key; each of the
  ``pilot_m - 1`` pilot steps splits the key in four (the next key, the
  proposal's, the filter's, the accept uniform's), proposes ``z' = z +
  sd * normal`` on the transformed scale, drawn again from the proposal
  key's own splits while the prior is not finite (at most 100 tries, then
  the current theta), and accepts when ``log(u) < log_ratio``. The mean
  and covariance (ddof 1) of the second half of the chain, untransformed,
  and ``pilot_reps`` filters at the mean from ``split(key, reps)`` give
  ``target_n = clamp(ceil(pilot_n * var(ll)), 50, 1000)``;
* sampling: ``split(key)`` gives the MH stream's chain words and the
  initial filter's key; the proposal factors are the delta-method
  factors of the pilot covariance at the pilot mean, factored by an
  eigendecomposition; the filter takes ``target_n`` alive lanes of the
  next power of two at or above the largest ``target_n`` (at least 128);
  the MH steps are ``mh.py``'s.

A call runs about 700 filters over every chain; the reference cannot run
them all inside a run. So it follows the program step by step: it draws
every key, proposal and accept uniform itself, takes each MH decision on
the program's log-likelihoods, and checks them by themselves on a sample
of the calls. Numbers, each with a limit of its own:

* ``input_gap``: every filter call's inputs (keys or seed words, theta,
  alive lanes) against the reference's own, widest relative gap in theta
  (words or lanes that differ, or calls missing, read as an infinite
  gap);
* ``filter_ll_gap``: the reference's filter at its own inputs against the
  program's log-likelihood, on five calls: the pilot's first, a pilot step
  drawn from the seed, ``SAMPLE_ROWS`` rows of the pilot's variance run
  drawn from the seed, the sampler's initial filter and a sampling step
  drawn from the seed (nats; two ``-inf`` agree);
* ``target_n_gap``: the particle counts that tuning returned against the
  reference's, from the program's variance run, largest difference;
* ``theta_gap``: the kept samples against the reference's chain, widest
  relative gap.

The control puts the reference computed in a lower type in the
program's place: its own replay of the call in that type (on the same
program log-likelihoods) gives the inputs, ``target_n`` and samples, and
its filter in that type the sampled log-likelihoods.

Imports nothing of the system under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import mh, smc, threefry
from benchmark.reference.check import ll_gap, theta_gap

MAX_PROPOSAL_TRIES = 100
TARGET_N_MIN, TARGET_N_MAX = 50, 1000
SAMPLE_ROWS = 4096


def lane_bound(max_n: int) -> int:
    """The next power of two at or above ``max(max_n, 128)``."""
    bound = 128
    while bound < max_n:
        bound *= 2
    return bound


def proposal_factor(cov: np.ndarray) -> np.ndarray:
    """``L`` with ``L L^T = cov`` from the eigendecomposition of the
    symmetrised covariance, negative eigenvalues taken as 0."""
    cov = 0.5 * (cov + cov.T)
    eigval, eigvec = np.linalg.eigh(cov)
    eigval = np.clip(eigval, 0.0, None)
    return (eigvec * np.sqrt(eigval)[None, :]).astype(np.float32)


def delta_method_factors(mean, cov, transforms) -> np.ndarray:
    """``[C, P, P]`` proposal factors on the transformed scale: ``J cov
    J^T`` with ``J = diag(dz / dtheta)`` at the pilot mean."""
    mean = np.asarray(mean, np.float64)
    cov = np.asarray(cov, np.float64)
    c, p = mean.shape
    out = np.zeros((c, p, p), dtype=np.float32)
    for k in range(c):
        scale = np.ones(p)
        for j, t in enumerate(transforms):
            if t == "log":
                scale[j] = 1.0 / mean[k, j]
            elif t == "logit":
                scale[j] = 1.0 / (mean[k, j] * (1.0 - mean[k, j]))
        out[k] = proposal_factor((scale[:, None] * cov[k]) * scale[None, :])
    return out


def propose_until_valid(key, z, sd: float, transforms, prior_fns, theta):
    p = z.shape[-1]
    pending = torch.ones(z.shape[0], dtype=torch.bool, device=z.device)
    for _ in range(MAX_PROPOSAL_TRIES):
        key, k = threefry.split(key).unbind(1)
        thp = mh.back_transform(z + sd * threefry.normal(k, (p,)).to(z.dtype),
                                transforms)
        valid = torch.isfinite(mh.sum_log_priors(thp, prior_fns))
        theta = torch.where((pending & valid)[:, None], thp, theta)
        pending = pending & ~valid
        if not bool(pending.any()):
            break
    return theta


def input_gap(got, want) -> float:
    """Widest relative gap in theta between two lists of filter inputs
    ``(words, theta, n)``; words or alive lanes that differ, or a list of
    another length, read as infinite."""
    if len(got) != len(want):
        return math.inf
    gap = 0.0
    for (gw, gt, gn), (ww, wt, wn) in zip(got, want):
        if gw.shape != ww.shape or not torch.equal(
                gw.to(ww.device, torch.int64), ww):
            return math.inf
        c = ww.shape[0]
        gn = torch.as_tensor(gn, dtype=torch.float32).to(ww.device)
        wn = torch.as_tensor(wn, dtype=torch.float32).to(ww.device)
        if not torch.equal(gn.expand(c), wn.expand(c)):
            return math.inf
        gap = max(gap, theta_gap(gt.float().cpu(), wt.float().cpu()))
    return gap


class PmmhCheck:
    """The reference side of one ``pmmh()`` cell: its model, filter path,
    observations, call settings and priors."""

    def __init__(self, model, path: str, y, chains: int, m: int,
                 burn_in: int, tune: dict, theta0, prior_fns, transforms,
                 device):
        self.model, self.path = model, path
        self.device = torch.device(device)
        self.y = y
        self.chains, self.m, self.burn_in = int(chains), int(m), int(burn_in)
        self.pilot_m = int(tune["pilot_m"])
        self.pilot_reps = int(tune["pilot_reps"])
        self.pilot_n = int(tune.get("pilot_n", 100))
        self.pilot_sd = float(np.float32(tune.get("pilot_proposal_sd", 0.5)))
        self.theta0 = torch.as_tensor(np.asarray(theta0, np.float32),
                                      device=self.device)
        self.prior_fns = prior_fns
        self.transforms = tuple(transforms)

    def filt(self, words, theta, n, lanes: int, dt=torch.float32):
        run = (smc.sweep_filter if self.path == "sweep"
               else smc.engine_filter)
        obs = (self.model.sweep_obs if self.path == "sweep"
               else self.model.engine_obs)
        n = torch.as_tensor(n, dtype=torch.float32, device=self.device)
        return run(self.model, words, obs(self.y, self.device, dt),
                   theta.to(self.device), n.reshape(-1), lanes, dt=dt)

    def _log_ratio(self, theta_prop, ll_prop, theta, ll):
        lr = (mh.sum_log_priors(theta_prop, self.prior_fns) + ll_prop
              + mh.log_jacobian(theta_prop, self.transforms)) - (
            mh.sum_log_priors(theta, self.prior_fns) + ll
            + mh.log_jacobian(theta, self.transforms))
        return torch.where(torch.isnan(lr), -math.inf, lr)

    def replay(self, seed: int, pilot_ll, rep_ll, sampling_ll, dt) -> dict:
        """The call's filter inputs, ``target_n`` and kept samples as the
        reference derives them in ``dt``, taking each MH decision and the
        variance on the program's log-likelihoods: ``pilot_ll`` (the
        pilot's ``pilot_m`` filters), ``rep_ll`` (its variance run, all
        rows) and ``sampling_ll`` (the sampler's ``m`` filters)."""
        dev, c, p = self.device, self.chains, self.theta0.shape[-1]
        keys = threefry.fold_in(threefry.key(seed, dev),
                                torch.arange(c, device=dev))
        key, k0 = threefry.split(keys).unbind(1)
        theta = self.theta0.to(dt).expand(c, p).contiguous()
        pilot = [(k0, theta, self.pilot_n)]
        ll = pilot_ll[0].to(dev, dt)
        thetas = [theta]
        for s in range(1, self.pilot_m):
            key, k_prop, k_pf, k_acc = threefry.split(key, 4).unbind(1)
            theta_prop = propose_until_valid(
                k_prop, mh.transform(theta, self.transforms), self.pilot_sd,
                self.transforms, self.prior_fns, theta)
            pilot.append((k_pf, theta_prop, self.pilot_n))
            ll_prop = pilot_ll[s].to(dev, dt)
            accept = torch.log(threefry.uniform(k_acc)) < self._log_ratio(
                theta_prop, ll_prop, theta, ll)
            theta = torch.where(accept[:, None], theta_prop, theta)
            ll = torch.where(accept, ll_prop, ll)
            thetas.append(theta)
        post = torch.stack(thetas, dim=1)[:, self.pilot_m // 2:]
        mean = post.mean(dim=1)
        centered = post - mean[:, None]
        cov = torch.einsum("cmp,cmq->cpq", centered, centered) / (
            post.shape[1] - 1)

        reps = self.pilot_reps
        rep = (threefry.split(key, reps).reshape(c * reps, 2),
               mean[:, None, :].expand(c, reps, p).reshape(c * reps, p),
               self.pilot_n)
        lls = rep_ll.to(dev, dt).reshape(c, reps)
        centered = lls - lls.sum(dim=1, keepdim=True) / reps
        var = (centered * centered).sum(dim=1) / (reps - 1)
        var = torch.where(torch.isnan(var), math.inf, var)
        target_n = torch.clamp(torch.ceil(self.pilot_n * var), TARGET_N_MIN,
                               TARGET_N_MAX).float()

        mh_keys, k0 = threefry.split(keys).unbind(1)
        factors = torch.as_tensor(delta_method_factors(
            mean.float().cpu().numpy(), cov.float().cpu().numpy(),
            self.transforms), device=dev).to(dt)
        theta = mean
        sampling = [(k0, theta, target_n)]
        ll = sampling_ll[0].to(dev, dt)
        kept = []
        for s in range(1, self.m):

            def program_filter(words, theta_prop, s=s):
                sampling.append((words, theta_prop, target_n))
                return sampling_ll[s].to(dev, dt)

            theta, ll, _ = mh.mh_step(program_filter, mh_keys, s, theta, ll,
                                      factors, self.prior_fns,
                                      self.transforms)
            if s >= self.burn_in:
                kept.append(theta)
        return dict(pilot=pilot, rep=rep, sampling=sampling,
                    target_n=target_n, samples=torch.stack(kept, dim=1),
                    lanes=lane_bound(int(target_n.max())))

    def compare(self, seed: int, checked: dict, control_dt=None) -> dict:
        """Numbers of one checked call. ``checked`` holds the program's
        filter calls in order, ``calls`` (each ``phase`` 0 for tuning or 1
        for sampling, ``words``, ``theta``, ``n``, ``ll``), its
        ``target_n [C]`` and kept ``samples [C, m - burn_in, P]``. With
        ``control_dt`` the reference in that type takes the program's
        place."""
        pilot = [r for r in checked["calls"] if r["phase"] == 0]
        sampling = [r for r in checked["calls"] if r["phase"] == 1]
        c = self.chains
        runs = pilot[self.pilot_m:]
        if (len(pilot) <= self.pilot_m or len(sampling) != self.m
                or sum(r["ll"].shape[0] for r in runs)
                != c * self.pilot_reps):
            return self._numbers(math.inf, math.inf, math.inf, math.inf,
                                 len(pilot), len(sampling))
        lls = ([r["ll"] for r in pilot[:self.pilot_m]],
               torch.cat([r["ll"] for r in runs]),
               [r["ll"] for r in sampling])
        want = self.replay(seed, *lls, torch.float32)
        if control_dt is None:
            def inputs(rs):
                return [(r["words"], r["theta"], r["n"]) for r in rs]

            got = dict(pilot=inputs(pilot[:self.pilot_m]),
                       rep=(torch.cat([r["words"] for r in runs]),
                            torch.cat([r["theta"] for r in runs]),
                            runs[0]["n"]),
                       sampling=inputs(sampling),
                       target_n=torch.as_tensor(np.asarray(
                           checked["target_n"]), dtype=torch.float32),
                       samples=torch.as_tensor(np.asarray(
                           checked["samples"])))
            got_ll = dict(pilot=lls[0], rep=lls[1], sampling=lls[2])
        else:
            got = self.replay(seed, *lls, control_dt)
            got_ll = None
        gap_in = input_gap(got["pilot"] + [got["rep"]] + got["sampling"],
                           want["pilot"] + [want["rep"]] + want["sampling"])
        target_n_gap = float((got["target_n"].to(self.device)
                              - want["target_n"]).abs().max())
        samples_gap = (theta_gap(got["samples"].float().cpu(),
                                 want["samples"].cpu())
                       if got["samples"].shape == want["samples"].shape
                       else math.inf)

        # The filter itself, on the sampled calls, at each side's inputs.
        rng = np.random.default_rng([int(seed) % 2**63, 13])
        rows = torch.as_tensor(np.sort(rng.choice(
            c * self.pilot_reps, min(SAMPLE_ROWS, c * self.pilot_reps),
            replace=False)), device=self.device)
        lanes_pilot = ((self.pilot_n + 127) // 128) * 128
        sampled = [("pilot", 0, None, lanes_pilot),
                   ("pilot", int(rng.integers(1, self.pilot_m)), None,
                    lanes_pilot),
                   ("rep", None, rows, lanes_pilot),
                   ("sampling", 0, None, "lanes"),
                   ("sampling", int(rng.integers(1, self.m)), None,
                    "lanes")]
        gap = 0.0
        for kind, i, pick, lanes in sampled:
            def at(side, i=i, pick=pick, kind=kind):
                words, theta, n = (side[kind] if i is None
                                   else side[kind][i])
                if pick is not None:
                    words, theta = words[pick], theta[pick]
                return words, theta, n

            ref_ll = self.filt(*at(want), want["lanes"] if lanes == "lanes"
                               else lanes)
            if got_ll is None:
                out = self.filt(*at(got), got["lanes"] if lanes == "lanes"
                                else lanes, control_dt)
            else:
                out = got_ll[kind] if i is None else got_ll[kind][i]
                if pick is not None:
                    out = out.to(self.device)[pick]
            gap = max(gap, ll_gap(out.float().cpu(), ref_ll.cpu()))
        return self._numbers(gap_in, gap, target_n_gap, samples_gap,
                             len(pilot), len(sampling), want["lanes"],
                             want["target_n"])

    @staticmethod
    def _numbers(input_gap, filter_gap, target_n_gap, samples_gap,
                 n_pilot, n_sampling, lanes=0, target_n=None):
        out = {"input_gap": input_gap, "filter_ll_gap": filter_gap,
               "target_n_gap": target_n_gap, "theta_gap": samples_gap,
               "_pilot_calls": n_pilot, "_sampling_calls": n_sampling,
               "_lanes": lanes}
        if target_n is not None:
            out["_target_n_min_med_max"] = [
                float(target_n.min()), float(target_n.median()),
                float(target_n.max())]
        return out
