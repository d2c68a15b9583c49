"""The port's checkpoint/resume (``utils/checkpoint.py`` and ``pmmh()``'s
``checkpoint_every``/``checkpoint_path``/``resume``).

The six tests of ``tests/test_checkpoint.py`` on the port (LGSS, 2 chains,
m = 80, the engine), then what the port holds beyond them: a step's draws
depend only on the chain words and the step's index, so a resumed run
equals the uninterrupted one bit for bit whatever the chunks of either,
on the engine and on the sweep path; the version-2 format (``state_est``
only with latent-state collection, the chain words in ``key_data``); the
temporary file removed when a write fails; and the two drivers refusing
each other's snapshots.
"""

import functools
import warnings

import jax
import numpy as np
import pytest
import torch

from bayesssm_tpu.utils.checkpoint import (
    load_checkpoint as j_load_checkpoint,
    save_checkpoint as j_save_checkpoint,
)
from bayesssm_tpu_torch.models.lgss import lgss_model, simulate_lgss
from bayesssm_tpu_torch.ops.lgss_sweep import lgss_sweep_pf_impl
from bayesssm_tpu_torch.pmmh import default_tune_control, pmmh
from bayesssm_tpu_torch.utils import checkpoint
from bayesssm_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)

torch.set_num_threads(1)

(MODEL_FNS, LOG_PRIORS, TRANSFORM) = lgss_model()
INIT_FN, TRANSITION_FN, LOGLIK_FN = MODEL_FNS
_, Y = simulate_lgss(21, t_val=10)

FAST_TUNE = default_tune_control(pilot_m=40, pilot_reps=8, pilot_n=50)
INIT_PARAMS = [{"a": 0.5, "sigma_x": 0.5, "sigma_y": 0.5}] * 2


def run(m=80, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return pmmh(
            "bootstrap_filter", Y, m=m,
            init_fn=INIT_FN, transition_fn=TRANSITION_FN,
            log_likelihood_fn=LOGLIK_FN, log_priors=LOG_PRIORS,
            pilot_init_params=INIT_PARAMS, burn_in=10, num_chains=2,
            seed=99, param_transform=TRANSFORM, tune_control=FAST_TUNE,
            print_summary=False, device="cpu", **kw,
        )


@functools.lru_cache(maxsize=None)
def full(m=80, path="engine", latent=False):
    """The uninterrupted run, once per setting."""
    kw = {"pf_impl": lgss_sweep_pf_impl()} if path == "sweep" else {}
    return run(m=m, return_latent_state_est=latent, **kw)


def assert_same_chains(a, b):
    assert list(a.theta_chain) == list(b.theta_chain)
    for p in a.theta_chain:
        np.testing.assert_array_equal(a.theta_chain[p], b.theta_chain[p])
    np.testing.assert_array_equal(a.acceptance_rate, b.acceptance_rate)


# ---- the six tests of tests/test_checkpoint.py ------------------------

def test_checkpointing_equals_plain(tmp_path):
    ck = tmp_path / "state.npz"
    chunked = run(checkpoint_every=25, checkpoint_path=str(ck))
    assert_same_chains(full(), chunked)
    assert ck.exists()
    state = load_checkpoint(ck)
    assert state["step"] == 80
    assert state["samples"].shape == (2, 80, 3)


def test_resume_continues_exactly(tmp_path):
    ck = tmp_path / "state.npz"
    run(m=30, checkpoint_every=30, checkpoint_path=str(ck))
    resumed = run(m=80, checkpoint_path=str(ck), resume=True,
                  checkpoint_every=25)
    assert_same_chains(full(), resumed)
    assert "tuning" not in resumed.timings


def test_resume_missing_file_raises(tmp_path):
    with pytest.raises(ValueError, match="existing checkpoint_path"):
        run(resume=True, checkpoint_path=str(tmp_path / "nope.npz"))


def test_checkpoint_roundtrip(tmp_path):
    words = np.array([[1, 2**32 - 1], [3, 4], [5, 6], [7, 2**31]],
                     dtype=np.uint64)
    save_checkpoint(
        tmp_path / "x.npz",
        keys=torch.as_tensor(words.astype(np.int64)),
        theta=np.ones((4, 2)),
        loglike=np.zeros(4),
        samples=np.zeros((4, 5, 2)),
        step=5,
        meta={"target_n": np.array([50, 60, 70, 80])},
    )
    state = load_checkpoint(tmp_path / "x.npz")
    assert state["step"] == 5 and state["format_version"] == 2
    assert state["keys"].dtype == np.uint32
    np.testing.assert_array_equal(state["keys"], words)
    np.testing.assert_array_equal(state["meta"]["target_n"], [50, 60, 70, 80])


def test_resume_latent_flag_flip_rejected(tmp_path):
    ck = tmp_path / "state.npz"
    run(m=30, checkpoint_every=30, checkpoint_path=str(ck))
    with pytest.raises(ValueError, match="latent-state"):
        run(
            m=80, checkpoint_path=str(ck), resume=True,
            checkpoint_every=25, return_latent_state_est=True,
        )


def test_resume_false_from_latent_checkpoint_works(tmp_path):
    ck = tmp_path / "state.npz"
    run(
        m=30, checkpoint_every=30, checkpoint_path=str(ck),
        return_latent_state_est=True,
    )
    resumed = run(
        m=80, checkpoint_path=str(ck), resume=True, checkpoint_every=25,
    )
    assert_same_chains(full(), resumed)


# ---- beyond the JAX tests ---------------------------------------------

@pytest.mark.parametrize("first,second", [(13, 7), (None, 50), (4, None)])
def test_resume_with_other_chunks_equals_the_uninterrupted_run(
        tmp_path, first, second):
    """A resumed run equals the uninterrupted one whatever
    ``checkpoint_every`` either run had (``None``: one chunk)."""
    ck = tmp_path / "state.npz"
    run(m=30, checkpoint_every=first, checkpoint_path=str(ck))
    assert load_checkpoint(ck)["step"] == 30
    resumed = run(m=80, checkpoint_path=str(ck), resume=True,
                  checkpoint_every=second)
    assert_same_chains(full(), resumed)


def test_resume_on_the_sweep_path(tmp_path):
    ck = tmp_path / "state.npz"
    sweep = lgss_sweep_pf_impl()
    chunked = run(checkpoint_every=9, checkpoint_path=str(ck), pf_impl=sweep)
    assert_same_chains(full(path="sweep"), chunked)
    run(m=30, checkpoint_every=11, checkpoint_path=str(ck), pf_impl=sweep)
    resumed = run(m=80, checkpoint_path=str(ck), resume=True,
                  checkpoint_every=25, pf_impl=sweep)
    assert_same_chains(full(path="sweep"), resumed)


def test_resume_with_latent_states_equals_the_uninterrupted_run(tmp_path):
    ck = tmp_path / "state.npz"
    run(m=30, checkpoint_every=16, checkpoint_path=str(ck),
        return_latent_state_est=True)
    resumed = run(m=80, checkpoint_path=str(ck), resume=True,
                  return_latent_state_est=True)
    want = full(latent=True)
    assert_same_chains(want, resumed)
    np.testing.assert_array_equal(want.latent_state_chain,
                                  resumed.latent_state_chain)


def test_version_2_stores_state_est_only_with_latent_states(tmp_path):
    off, on = tmp_path / "off.npz", tmp_path / "on.npz"
    run(m=20, checkpoint_every=20, checkpoint_path=str(off))
    run(m=20, checkpoint_every=20, checkpoint_path=str(on),
        return_latent_state_est=True)
    raw_off = np.load(off)
    assert int(raw_off["format_version"]) == 2
    assert "state_est" not in raw_off and "state_samples" not in raw_off
    assert raw_off["key_data"].dtype == np.uint32
    assert raw_off["key_data"].shape == (2, 2)
    assert int(raw_off["meta_mh_step"]) == 19
    raw_on = np.load(on)
    assert raw_on["state_est"].shape == (2, len(Y) + 1)
    assert raw_on["state_samples"].shape == (2, 20, len(Y) + 1)


def test_failed_write_leaves_no_temporary_file(tmp_path, monkeypatch):
    def broken(*args, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.np, "savez", broken)
    ck = tmp_path / "state.npz"
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(ck, keys=np.zeros((2, 2)), theta=np.zeros((2, 3)),
                        loglike=np.zeros(2), samples=np.zeros((2, 1, 3)),
                        step=1)
    assert list(tmp_path.iterdir()) == []
    with pytest.raises(OSError, match="disk full"):
        run(m=20, checkpoint_every=10, checkpoint_path=str(ck))
    assert list(tmp_path.iterdir()) == []


def test_reads_a_jax_snapshot_and_refuses_to_resume_it(tmp_path):
    ck = tmp_path / "jax.npz"
    keys = jax.random.split(jax.random.key(0), 2)
    arrays = dict(theta=np.ones((2, 3)), loglike=np.full(2, -3.5),
                  state_est=np.zeros(2), samples=np.ones((2, 30, 3)))
    meta = {"theta_mean": np.ones((2, 3)),
            "target_n": np.array([50, 60]),
            "prop_factors": np.ones((2, 3, 3), np.float32),
            "accept_total": np.array([3.0, 4.0])}
    j_save_checkpoint(ck, keys=keys, step=30, meta=meta, **arrays)
    state = load_checkpoint(ck)
    assert state["format_version"] == 1 and state["step"] == 30
    np.testing.assert_array_equal(state["keys"],
                                  np.asarray(jax.random.key_data(keys)))
    for name, value in arrays.items():
        np.testing.assert_array_equal(state[name], value)
    for name, value in meta.items():
        np.testing.assert_array_equal(state["meta"][name], value)
    with pytest.raises(ValueError, match="format version 1") as err:
        run(m=80, checkpoint_path=str(ck), resume=True)
    assert "threefry keys" in str(err.value)


def test_jax_refuses_a_port_snapshot(tmp_path):
    ck = tmp_path / "port.npz"
    run(m=20, checkpoint_every=20, checkpoint_path=str(ck))
    with pytest.raises(ValueError, match="unsupported checkpoint version 2"):
        j_load_checkpoint(ck)


# ---- under a mesh: two gloo ranks ---------------------------------------

@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """``run()``'s chains on a 2 x 1 chains mesh, one chain a rank
    (``tests/_torch_dist.py::checkpoint_session``); returns each rank's
    results and the snapshot directory."""
    import _torch_dist as td

    ck_dir = tmp_path_factory.mktemp("mesh_ck")
    ranks = td.run_session(
        2, [("ck", td.checkpoint_session, dict(ck_dir=str(ck_dir)))],
        tmp_path_factory.mktemp("ranks"))
    return ranks["ck"], ck_dir


def _same_digest(a, out):
    for p in out.theta_chain:
        np.testing.assert_array_equal(a["theta"][p], out.theta_chain[p])
    np.testing.assert_array_equal(a["acceptance"], out.acceptance_rate)
    np.testing.assert_array_equal(a["target_n"], out.target_n)


def test_mesh_checkpoint_leaves_no_temporary_file(mesh_runs):
    """Both ranks write every snapshot, each through ``<path>.tmp<rank>``,
    and rename it over the same path: no temporary file stays."""
    got, ck_dir = mesh_runs
    for rank in got:
        assert rank["after_chunked"] == ["whole.npz"]
        assert rank["after_part"] == ["part.npz", "whole.npz"]
        assert rank["after_resumed"] == ["part.npz", "part30.npz",
                                         "whole.npz"]
    state = load_checkpoint(ck_dir / "whole.npz")
    assert state["step"] == 80 and state["samples"].shape == (2, 80, 3)


def test_mesh_checkpoint_and_resume_equal_the_uninterrupted_run(mesh_runs):
    """The chunked run and the run resumed from m = 30, on every rank,
    equal the uninterrupted run without a mesh bit for bit (the JAX
    two-process worker's "PMMH CK-RESUME BIT-MATCH")."""
    got, _ = mesh_runs
    for rank in got:
        _same_digest(rank["chunked"], full())
        _same_digest(rank["resumed"], full())


def test_mesh_snapshot_resumes_on_one_process(mesh_runs):
    """The mesh's m = 30 snapshot holds every chain: one process without a
    mesh resumes it and ends where the uninterrupted run does."""
    _, ck_dir = mesh_runs
    resumed = run(m=80, checkpoint_path=str(ck_dir / "part30.npz"),
                  resume=True, checkpoint_every=25)
    assert_same_chains(full(), resumed)
