"""Multi-rank sessions for the port's tests: gloo ranks on the CPU.

``run_session(world, cases, tmp_dir)`` spawns ``world`` processes (the
``spawn`` start method) that join one gloo group through
``bayesssm_tpu_torch.parallel.initialize`` with a ``file://`` store in
``tmp_dir`` (no TCP port, so parallel test workers cannot collide), run
every case in order, and send back each case's result from every rank:
``{name: [rank 0's result, rank 1's, ...]}``. A test module spawns one
session, from a module fixture, for all of its cases.

A case is ``(name, fn, kwargs)``: ``fn`` is a module-level function of a
module that imports only torch and the port (this one, or the example),
called as ``fn(**kwargs)`` on every rank; it returns host values (numpy
arrays, numbers, strings). The children never import JAX: the tests
compare what comes back with the JAX package in the test process.

A rank that raises, dies or outlives ``timeout`` fails the session: the
other ranks are killed (a collective they wait in would otherwise hang
until its group's timeout) and ``run_session`` raises with the rank's
traceback.
"""

from __future__ import annotations

import queue
import time
import traceback
import warnings

import numpy as np
import torch

SESSION_TIMEOUT = 420.0


def run_session(world: int, cases, tmp_dir, timeout: float = SESSION_TIMEOUT):
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = f"file://{tmp_dir}/store"
    procs = [ctx.Process(target=_rank_main,
                         args=(rank, world, store, cases, results),
                         daemon=True)
             for rank in range(world)]
    for p in procs:
        p.start()
    got, error = {}, None
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world and error is None:
            left = deadline - time.monotonic()
            if left <= 0:
                error = f"the ranks outlived {timeout:.0f} s"
                break
            try:
                rank, status, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    error = (f"rank {dead[0]} exited with code "
                             f"{procs[dead[0]].exitcode}")
                continue
            if status == "error":
                error = f"rank {rank} failed:\n{payload}"
            else:
                got[rank] = payload
    finally:
        for p in procs:
            if error is not None:
                p.kill()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    if error is not None:
        raise RuntimeError(f"multi-rank session: {error}")
    return {name: [got[r][name] for r in range(world)]
            for name, _, _ in cases}


def _rank_main(rank, world, store, cases, results):
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)
        from bayesssm_tpu_torch.parallel import initialize

        initialize(store, world, rank, device="cpu")
        out = {}
        for name, fn, kwargs in cases:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")   # ESS/R-hat advice
                out[name] = fn(**kwargs)
        results.put((rank, "ok", out))
    except BaseException:  # report any failure of the rank, then exit
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---- cases shared by the test modules ---------------------------------

def digest(out) -> dict:
    """The parts of a ``PMMHOutput`` the comparisons read, as arrays."""
    return {
        "theta": {p: np.asarray(v) for p, v in out.theta_chain.items()},
        "target_n": np.asarray(out.target_n),
        "acceptance": np.asarray(out.acceptance_rate),
        "latent": (None if out.latent_state_chain is None
                   else np.asarray(out.latent_state_chain)),
        "timings": dict(out.timings),
    }


def lgss_pmmh(mesh_shape=None, num_chains=4, seed=7, m=20, burn_in=5,
              t_val=8, pf="engine", pilot_m=20, pilot_reps=4,
              resample_fn="stratified", **kw):
    """The LGSS ``pmmh()`` of the mesh tests on this rank: ``mesh_shape``
    ``(chains, particles)`` or ``None``; ``pf`` ``"engine"`` or
    ``"sweep"`` (``lgss_sweep_pf_impl``)."""
    from bayesssm_tpu_torch.models.lgss import lgss_model, simulate_lgss
    from bayesssm_tpu_torch.ops.lgss_sweep import lgss_sweep_pf_impl
    from bayesssm_tpu_torch.parallel import make_chain_mesh
    from bayesssm_tpu_torch.pmmh import default_tune_control, pmmh

    fns, log_priors, transform = lgss_model()
    _, y = simulate_lgss(3, t_val=t_val)
    mesh = (None if mesh_shape is None
            else make_chain_mesh(mesh_shape[0] * mesh_shape[1],
                                 particle_axis_size=mesh_shape[1]))
    out = pmmh(
        "bootstrap_filter", y, m, *fns, log_priors,
        [{"a": 0.5, "sigma_x": 0.5, "sigma_y": 0.5}] * num_chains, burn_in,
        num_chains=num_chains, seed=seed, param_transform=transform,
        tune_control=default_tune_control(pilot_m=pilot_m,
                                          pilot_reps=pilot_reps,
                                          pilot_n=50),
        resample_fn=resample_fn, mesh=mesh, print_summary=False,
        pf_impl=lgss_sweep_pf_impl() if pf == "sweep" else None,
        device="cpu", **kw)
    return digest(out)


# ---- the LGSS filters of the sharded-filter tests ----------------------

LGSS_A, LGSS_SX, LGSS_SY = 0.9, 0.6, 0.4
SY_AUX = float(np.sqrt(LGSS_SX ** 2 + LGSS_SY ** 2))
MOVE_SD = 0.2


def lgss_aux_fn(y, particles, a):
    """The APF lookahead of ``tests/test_sharded_filter.py``: the
    one-step-ahead predictive density."""
    z = (y - a[:, None] * particles) / SY_AUX
    return -0.5 * (float(np.log(2 * np.pi * SY_AUX ** 2)) + z * z)


def lgss_move_fn(key, particles, y, sigma_y):
    """The random-walk RMPF move of ``tests/test_sharded_filter.py``."""
    from bayesssm_tpu_torch.models.lgss import lgss_model
    from bayesssm_tpu_torch.ops import threefry

    loglik = lgss_model()[0][2]
    k1, k2 = threefry.split(key).unbind(-2)
    shape = particles.shape[1:]
    prop = particles + MOVE_SD * threefry.normal(k1, shape)
    logr = (loglik(y, prop, sigma_y=sigma_y)
            - loglik(y, particles, sigma_y=sigma_y))
    accept = torch.log(threefry.uniform(k2, shape)) < logr
    return torch.where(accept, prop, particles)


def lgss_theta(num_chains):
    return {"a": np.full(num_chains, LGSS_A, np.float32),
            "sigma_x": np.full(num_chains, LGSS_SX, np.float32),
            "sigma_y": np.full(num_chains, LGSS_SY, np.float32)}


def lgss_sharded(y, mesh_shape=(1, 2), seed=0, num_chains=8,
                 num_particles=256, algorithm="BPF", **kw):
    """``sharded_particle_filter`` on LGSS over a ``mesh_shape`` mesh:
    ``(loglike [C], state_est [C, T, 1])`` as numpy."""
    from bayesssm_tpu_torch.models.lgss import lgss_model
    from bayesssm_tpu_torch.ops import threefry
    from bayesssm_tpu_torch.parallel import (
        make_chain_mesh,
        sharded_particle_filter,
    )

    mesh = make_chain_mesh(mesh_shape[0] * mesh_shape[1],
                           particle_axis_size=mesh_shape[1])
    extra = {}
    if algorithm == "APF":
        extra["aux_log_likelihood_fn"] = lgss_aux_fn
    elif algorithm == "RMPF":
        extra["move_fn"] = lgss_move_fn
    ll, states = sharded_particle_filter(
        threefry.key(seed), y, num_particles, *lgss_model()[0],
        lgss_theta(num_chains), num_chains=num_chains, mesh=mesh,
        algorithm=algorithm, device="cpu", **extra, **kw)
    return ll.numpy(), states.numpy()


def lgss_masked_core(y, seed=0, count=384, max_particles=512, ps=2):
    """``particle_filter_core`` called directly under ``use_mesh`` with a
    per-chain particle count below its static lane bound (the mirror of
    the JAX test's ``shard_map`` call): one chain, key ``fold_in(key(seed),
    0)``; returns the log-likelihood, the cumulative history and the ESS."""
    from bayesssm_tpu_torch.filters.core import particle_filter_core
    from bayesssm_tpu_torch.models.lgss import lgss_model
    from bayesssm_tpu_torch.ops import threefry
    from bayesssm_tpu_torch.parallel import make_chain_mesh, use_mesh

    mesh = make_chain_mesh(particle_axis_size=ps)
    key = threefry.fold_in(threefry.key(seed), 0)[None]
    with use_mesh(mesh):
        res = particle_filter_core(
            key, y, torch.tensor([float(count)]), *lgss_model()[0],
            theta={"a": LGSS_A, "sigma_x": LGSS_SX, "sigma_y": LGSS_SY},
            resample_algorithm="SISR", return_particles=False,
            max_particles=max_particles, use_fused=False,
            particle_axis="particles", particle_axis_size=ps)
    return (res.loglike.numpy(), res.loglike_history.numpy(),
            res.ess.numpy())


def error_text(fn, **kwargs):
    """The message of the ``ValueError`` that ``fn(**kwargs)`` raises."""
    try:
        fn(**kwargs)
    except ValueError as e:
        return str(e)
    return None


# ---- mesh and pmmh() cases of the sharding tests ------------------------

def mesh_facts():
    """What the ranks see of the group and of the meshes made from it."""
    import torch.distributed as dist

    from bayesssm_tpu_torch.parallel import (
        MeshConfig,
        global_chain_mesh,
        make_chain_mesh,
    )

    facts = {"world": dist.get_world_size(), "rank": dist.get_rank(),
             "backend": dist.get_backend()}
    for ps in (1, 2):
        mesh = global_chain_mesh(ps)
        facts[f"shape_{ps}"] = (mesh.mesh_dim_names, tuple(mesh.shape),
                                mesh.get_local_rank("chains"),
                                mesh.get_local_rank("particles"),
                                mesh.device_type)
    cfg = MeshConfig(particle_axis_size=2, chain_axis="c",
                     particle_axis="p").build()
    facts["config"] = (cfg.mesh_dim_names, tuple(cfg.shape))
    facts["wrong_n"] = error_text(make_chain_mesh, n_devices=4)
    facts["wrong_ps"] = error_text(global_chain_mesh, particle_axis_size=3)
    return facts


def collectives_case():
    """psum, pmax, all_gather and axis_index over each axis of a 1 x 2
    and a 2 x 1 mesh: rank r contributes r + 1."""
    from bayesssm_tpu_torch.parallel import make_chain_mesh, use_mesh
    from bayesssm_tpu_torch.parallel import collectives as col

    out = {}
    for ps in (1, 2):
        with use_mesh(make_chain_mesh(2, particle_axis_size=ps)):
            for axis in ("chains", "particles"):
                x = torch.tensor([float(col.axis_index(axis) + 1), 0.5])
                out[(ps, axis)] = (col.axis_size(axis), col.axis_index(axis),
                                   col.psum(x, axis).tolist(),
                                   col.pmax(x, axis).tolist(),
                                   col.all_gather(x, axis).tolist())
    return out


def shard_tree_case():
    from bayesssm_tpu_torch.parallel import make_chain_mesh, shard_chain_tree

    mesh = make_chain_mesh(2)
    tree = {"a": torch.zeros(16, 3), "b": (torch.ones(16),)}
    sharded = shard_chain_tree(tree, mesh)
    return {"a": (repr(sharded["a"].placements),
                  tuple(sharded["a"].to_local().shape),
                  tuple(sharded["a"].shape)),
            "b": (type(sharded["b"]).__name__,
                  tuple(sharded["b"][0].to_local().shape))}


def block_filter(y, seed=5, num_chains=16, num_particles=64):
    """The bootstrap filter of each rank's block of 16 keys on a chains
    mesh, gathered: the mirror of the JAX test that shards a vmapped
    filter's keys."""
    from bayesssm_tpu_torch.filters import bootstrap_filter
    from bayesssm_tpu_torch.models.lgss import lgss_model
    from bayesssm_tpu_torch.ops import threefry
    from bayesssm_tpu_torch.parallel import make_chain_mesh, use_mesh
    from bayesssm_tpu_torch.parallel.collectives import (
        all_gather,
        axis_index,
        axis_size,
    )

    keys = threefry.split(threefry.key(seed), num_chains)
    with use_mesh(make_chain_mesh(2)):
        c_local = num_chains // axis_size("chains")
        lo = axis_index("chains") * c_local
        ll = bootstrap_filter(
            keys[lo:lo + c_local], y, num_particles, *lgss_model()[0],
            theta={"a": 0.8, "sigma_x": 0.5, "sigma_y": 0.4},
            return_particles=False).loglike
        return all_gather(ll, "chains").numpy()


def propose_loop_trips(mesh_shape=(1, 2), num_chains=4, seed=3):
    """The LGSS ``pmmh()`` on a particle mesh with a prior on ``a`` that
    counts its calls: the propose loop and the MH ratios call it once a
    try or a step each, so equal counts on a particle group's ranks mean
    equal trip counts. The prior's support (|a| < 0.5) is narrow enough
    that proposals are drawn again."""
    from bayesssm_tpu_torch.models.distributions import unif_logpdf
    from bayesssm_tpu_torch.models.lgss import lgss_model, simulate_lgss
    from bayesssm_tpu_torch.parallel import make_chain_mesh
    from bayesssm_tpu_torch.pmmh import default_tune_control, pmmh

    fns, log_priors, transform = lgss_model()
    calls = {"a": 0}

    def prior_a(v):
        calls["a"] += 1
        return unif_logpdf(v, -0.5, 0.5)

    _, y = simulate_lgss(3, t_val=8)
    mesh = make_chain_mesh(mesh_shape[0] * mesh_shape[1],
                           particle_axis_size=mesh_shape[1])
    pilot_m = 20
    out = pmmh(
        "bootstrap_filter", y, 10, *fns, {**log_priors, "a": prior_a},
        [{"a": 0.3, "sigma_x": 0.5, "sigma_y": 0.5}] * num_chains, 2,
        num_chains=num_chains, seed=seed, param_transform=transform,
        tune_control=default_tune_control(pilot_m=pilot_m, pilot_reps=4,
                                          pilot_n=50,
                                          pilot_proposal_sd=1.0),
        mesh=mesh, print_summary=False, device="cpu")
    return {"calls": calls["a"], "pilot_m": pilot_m, **digest(out)}


# ---- the two-process cases of the distributed tests ----------------------

def _flat_priors():
    return {
        "a": lambda v: torch.where(v.abs() < 1, 0.0, -torch.inf),
        "sigma_x": lambda v: torch.where(v > 0, -v, -torch.inf),
        "sigma_y": lambda v: torch.where(v > 0, -v, -torch.inf),
    }


def dist_config_pmmh(mesh_shape=None, m=12, num_chains=4, seed=7,
                     pilot_m=12, **kw):
    """The ``pmmh()`` of ``tests/_pmmh_dist_config.py`` on the port."""
    from bayesssm_tpu_torch.models.lgss import lgss_model, simulate_lgss
    from bayesssm_tpu_torch.parallel import make_chain_mesh
    from bayesssm_tpu_torch.pmmh import default_tune_control, pmmh

    fns, _, _ = lgss_model()
    _, y = simulate_lgss(1, t_val=4)
    mesh = (None if mesh_shape is None
            else make_chain_mesh(mesh_shape[0] * mesh_shape[1],
                                 particle_axis_size=mesh_shape[1]))
    out = pmmh(
        "bootstrap_filter", np.asarray(y, np.float32), m, *fns,
        _flat_priors(),
        pilot_init_params={"a": 0.8, "sigma_x": 0.5, "sigma_y": 0.4},
        burn_in=2, num_chains=num_chains, seed=seed,
        param_transform={"a": "identity", "sigma_x": "log",
                         "sigma_y": "log"},
        tune_control=default_tune_control(pilot_m=pilot_m,
                                          pilot_burn_in=4, pilot_reps=2),
        mesh=mesh, print_summary=False, device="cpu", **kw)
    return digest(out)


def dist_smoke(ck_dir):
    """The JAX two-process worker's steps on two ranks: a cross-process
    collective, one particle-sharded filter, ``pmmh()`` on the chains mesh
    and on the particle mesh, and checkpoint/resume with both ranks
    writing the same snapshot paths."""
    import os

    from bayesssm_tpu_torch.models.lgss import lgss_model, simulate_lgss
    from bayesssm_tpu_torch.ops import threefry
    from bayesssm_tpu_torch.parallel import (
        global_chain_mesh,
        sharded_bootstrap_filter,
        use_mesh,
    )
    from bayesssm_tpu_torch.parallel.collectives import axis_index, psum

    mesh = global_chain_mesh(particle_axis_size=2)
    with use_mesh(mesh):
        lo = 4 * axis_index("particles")
        total = psum(torch.arange(lo, lo + 4.0).sum(), "particles")

    (init_fn, trans_fn, loglik_fn), _, _ = lgss_model()
    _, y = simulate_lgss(1, t_val=4)
    theta = {"a": np.full(2, 0.8, np.float32),
             "sigma_x": np.full(2, 0.5, np.float32),
             "sigma_y": np.full(2, 0.4, np.float32)}
    ll, _ = sharded_bootstrap_filter(
        threefry.key(0), np.asarray(y, np.float32), 64, init_fn, trans_fn,
        loglik_fn, theta, num_chains=2, mesh=mesh, device="cpu")

    out = {"total": float(total), "ll": ll.numpy(),
           "digest": dist_config_pmmh((2, 1)),
           "ps_digest": dist_config_pmmh((1, 2), m=8, num_chains=2,
                                         seed=11, pilot_m=8)}
    ck_a = os.path.join(ck_dir, "dist_interrupted.npz")
    ck_b = os.path.join(ck_dir, "dist_plain.npz")
    dist_config_pmmh((2, 1), m=6, checkpoint_every=6, checkpoint_path=ck_a)
    out["resumed"] = dist_config_pmmh((2, 1), checkpoint_path=ck_a,
                                      resume=True, checkpoint_every=6)
    out["plain"] = dist_config_pmmh((2, 1), checkpoint_every=6,
                                    checkpoint_path=ck_b)
    return out


# ---- the checkpoint case: ``tests/test_torch_checkpoint.py``'s run ------

def checkpoint_pmmh(mesh_shape=(2, 1), m=80, **kw):
    """``tests/test_torch_checkpoint.py::run`` (LGSS, 2 chains, seed 99)
    on a mesh."""
    from bayesssm_tpu_torch.models.lgss import lgss_model, simulate_lgss
    from bayesssm_tpu_torch.parallel import make_chain_mesh
    from bayesssm_tpu_torch.pmmh import default_tune_control, pmmh

    fns, log_priors, transform = lgss_model()
    _, y = simulate_lgss(21, t_val=10)
    mesh = make_chain_mesh(mesh_shape[0] * mesh_shape[1],
                           particle_axis_size=mesh_shape[1])
    out = pmmh(
        "bootstrap_filter", y, m, *fns, log_priors,
        [{"a": 0.5, "sigma_x": 0.5, "sigma_y": 0.5}] * 2, 10,
        num_chains=2, seed=99, param_transform=transform,
        tune_control=default_tune_control(pilot_m=40, pilot_reps=8,
                                          pilot_n=50),
        mesh=mesh, print_summary=False, device="cpu", **kw)
    return digest(out)


def checkpoint_session(ck_dir):
    """Uninterrupted with snapshots, interrupted at m = 30 and resumed, on
    a chains mesh; each rank lists the directory after each run, between
    two barriers so that no rank is still writing or writes again before
    every rank has listed. The m = 30 snapshot is copied to ``part30.npz``
    before the resume overwrites it."""
    import os
    import shutil

    import torch.distributed as dist

    def listing():
        dist.barrier()
        names = sorted(os.listdir(ck_dir))
        dist.barrier()     # no rank writes again before every rank listed
        return names

    whole = os.path.join(ck_dir, "whole.npz")
    part = os.path.join(ck_dir, "part.npz")
    out = {"chunked": checkpoint_pmmh(checkpoint_every=25,
                                      checkpoint_path=whole)}
    out["after_chunked"] = listing()
    checkpoint_pmmh(m=30, checkpoint_every=30, checkpoint_path=part)
    out["after_part"] = listing()
    if dist.get_rank() == 0:   # kept for a resume on one process
        shutil.copy(part, os.path.join(ck_dir, "part30.npz"))
    out["resumed"] = checkpoint_pmmh(checkpoint_path=part, resume=True,
                                     checkpoint_every=25)
    out["after_resumed"] = listing()
    return out
