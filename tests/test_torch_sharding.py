"""The port's meshes and ``pmmh(mesh=...)`` on two gloo ranks: the mirror
of ``tests/test_sharding.py`` (all but the graft dry run), and what the
port holds beyond it.

The JAX package holds a FIXED layout bit for bit and other layouts in
distribution. The port holds more: each rank runs its block of chains
with the same per-chain keys and MH stream words as a run without a mesh,
and its tensors' per-chain arithmetic does not depend on how many chains
share a batch, so a chains-only mesh equals the no-mesh run bit for bit,
on the engine and on a sweep ``pf_impl``. A particle axis of size 2
folds the shard index into the model streams, so that layout agrees in
distribution; its two ranks return the same bits.

All cases run in one two-rank session (``tests/_torch_dist.py``); the
no-mesh references run in the test process.
"""

import functools

import numpy as np
import pytest
import torch

import _torch_dist as td
from bayesssm_tpu_torch.filters import bootstrap_filter
from bayesssm_tpu_torch.models.lgss import lgss_model, simulate_lgss
from bayesssm_tpu_torch.ops import threefry

torch.set_num_threads(1)

_, Y = simulate_lgss(3, t_val=12)
# The JAX test's run: 8 chains, m = 60, burn_in = 20, seed 77,
# default_tune_control(pilot_m=40, pilot_reps=8, pilot_n=50).
RUN = dict(num_chains=8, seed=77, m=60, burn_in=20, t_val=12, pilot_m=40,
           pilot_reps=8)
# The JAX test's particle-sharded run has 4 chains. The port's MH stream
# differs from JAX's, and at 4 chains of 40 kept samples the difference
# of two runs' posterior means has a standard error near 0.18 (0.044 at
# 64 chains, 0.021-0.026 at 256, where the sharded and unsharded means
# agree within 1.3 SE), so the 0.3 band would test the draw; 16 chains
# (SE near 0.09) test the filter.
PS_RUN = dict(RUN, num_chains=16, seed=11)


def _cases():
    return [
        ("facts", td.mesh_facts, {}),
        ("collectives", td.collectives_case, {}),
        ("m21", td.lgss_pmmh, dict(mesh_shape=(2, 1), **RUN)),
        ("m21_again", td.lgss_pmmh, dict(mesh_shape=(2, 1), **RUN)),
        ("m21_sweep", td.lgss_pmmh,
         dict(mesh_shape=(2, 1), pf="sweep", **RUN)),
        ("m12", td.lgss_pmmh, dict(mesh_shape=(1, 2), **RUN)),
        ("m12_ps", td.lgss_pmmh, dict(mesh_shape=(1, 2), **PS_RUN)),
        ("single_shard", td.error_text,
         dict(fn=td.lgss_pmmh, mesh_shape=(1, 2), pf="sweep", m=4,
              burn_in=1)),
        ("odd_chains", td.error_text,
         dict(fn=td.lgss_pmmh, mesh_shape=(2, 1), num_chains=3, m=4,
              burn_in=1)),
        ("tree", td.shard_tree_case, {}),
        ("block", td.block_filter, dict(y=Y)),
        ("trips", td.propose_loop_trips, {}),
    ]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return td.run_session(2, _cases(), tmp_path_factory.mktemp("ranks"))


@functools.lru_cache(maxsize=None)
def base(pf="engine", **kw):
    """The run without a mesh, in this process."""
    return td.lgss_pmmh(None, pf=pf, **kw)


def assert_same_run(a, b):
    for p in a["theta"]:
        np.testing.assert_array_equal(a["theta"][p], b["theta"][p])
    np.testing.assert_array_equal(a["target_n"], b["target_n"])
    np.testing.assert_array_equal(a["acceptance"], b["acceptance"])


def test_ranks_and_meshes(ranks):
    for rank, facts in enumerate(ranks["facts"]):
        assert (facts["world"], facts["rank"], facts["backend"]) == (
            2, rank, "gloo")
        assert facts["shape_1"] == (("chains", "particles"), (2, 1), rank,
                                    0, "cpu")
        assert facts["shape_2"] == (("chains", "particles"), (1, 2), 0,
                                    rank, "cpu")
        assert facts["config"] == (("c", "p"), (1, 2))
        assert "must equal the number of ranks" in facts["wrong_n"]
        assert facts["wrong_ps"] == (
            "device count must divide particle_axis_size")


def test_named_axis_collectives(ranks):
    """Rank r contributes [r + 1, 0.5]: sums and maxima over the axis of
    size 2, the identity over the axis of size 1."""
    for rank, got in enumerate(ranks["collectives"]):
        pair = [[1.0, 0.5], [2.0, 0.5]]
        for ps, wide, narrow in ((1, "chains", "particles"),
                                 (2, "particles", "chains")):
            assert got[(ps, wide)] == (2, rank, [3.0, 1.0], [2.0, 0.5],
                                       pair[0] + pair[1])
            assert got[(ps, narrow)] == (1, 0, [1.0, 0.5], [1.0, 0.5],
                                         [1.0, 0.5])


def test_fixed_layout_bit_exact(ranks):
    for a, b in zip(ranks["m21"], ranks["m21_again"]):
        assert_same_run(a, b)


@pytest.mark.parametrize("pf", ["engine", "sweep"])
def test_chains_mesh_equals_the_run_without_a_mesh(ranks, pf):
    """Every rank returns the full output, equal to the no-mesh run bit
    for bit, with the same (slowest rank's) timings."""
    got = ranks["m21" if pf == "engine" else "m21_sweep"]
    for out in got:
        assert_same_run(out, base(pf, **RUN))
    assert got[0]["timings"] == got[1]["timings"]


def test_mesh_layout_statistical_invariance(ranks):
    want = base(**RUN)
    for other in (ranks["m21"][0], ranks["m12"][0]):
        assert other["target_n"].min() >= 50
        assert other["target_n"].max() <= 1000
        for p in want["theta"]:
            assert abs(want["theta"][p].mean()
                       - other["theta"][p].mean()) < 0.25
    assert_same_run(ranks["m12"][0], ranks["m12"][1])


def test_pmmh_particle_sharded_matches_unsharded(ranks):
    sharded, want = ranks["m12_ps"][0], base(**PS_RUN)
    assert_same_run(sharded, ranks["m12_ps"][1])
    for p in want["theta"]:
        assert np.isfinite(sharded["theta"][p]).all()
        assert abs(want["theta"][p].mean()
                   - sharded["theta"][p].mean()) < 0.3, p
        assert sharded["theta"][p].shape == want["theta"][p].shape
    assert sharded["target_n"].min() >= 50
    assert sharded["target_n"].max() <= 1000
    assert sharded["acceptance"].max() > 0.0


def test_pmmh_particle_sharded_rejects_pf_impl(ranks):
    for msg in ranks["single_shard"]:
        assert "single-shard" in msg


def test_num_chains_must_divide_the_chains_axis(ranks):
    for msg in ranks["odd_chains"]:
        assert "divisible by the mesh chains axis" in msg


def test_sharded_filter_matches_unsharded(ranks):
    keys = threefry.split(threefry.key(5), 16)
    plain = bootstrap_filter(
        keys, Y, 64, *lgss_model()[0],
        theta={"a": 0.8, "sigma_x": 0.5, "sigma_y": 0.4},
        return_particles=False).loglike.numpy()
    for sharded in ranks["block"]:
        np.testing.assert_allclose(plain, sharded, rtol=1e-6)


def test_shard_chain_tree(ranks):
    for got in ranks["tree"]:
        assert got["a"] == ("(Shard(dim=0), Replicate())", (8, 3), (16, 3))
        assert got["b"] == ("tuple", (8,))


def test_particle_group_runs_the_same_propose_loop(ranks):
    """The pilot's propose loop ends when every chain of the rank has a
    proposal inside the prior; the two ranks of a particle group hold the
    same chains and the same log-likelihoods, so they run it the same
    number of times (and the loop did draw again: more prior calls than
    one a pilot step)."""
    r0, r1 = ranks["trips"]
    assert r0["calls"] == r1["calls"]
    assert r0["calls"] > 2 * r0["pilot_m"]
    assert_same_run(r0, r1)


# ---- one process --------------------------------------------------------

@pytest.fixture
def own_group():
    """Destroys the one-rank group a test's mesh made for this process."""
    import torch.distributed as dist

    had = dist.is_initialized()
    yield
    if dist.is_initialized() and not had:
        dist.destroy_process_group()


def test_one_process_gets_a_one_by_one_mesh(own_group):
    from bayesssm_tpu_torch.parallel import MeshConfig, make_chain_mesh

    mesh = make_chain_mesh(devices="cpu")
    assert mesh.mesh_dim_names == ("chains", "particles")
    assert tuple(mesh.shape) == (1, 1)
    with pytest.raises(ValueError, match="must equal the number of ranks"):
        make_chain_mesh(2, devices="cpu")
    with pytest.raises(ValueError, match="divisible by particle_axis_size"):
        MeshConfig(n_devices=3, particle_axis_size=2).build("cpu")
    run = dict(num_chains=2, m=12, burn_in=2)
    assert_same_run(td.lgss_pmmh((1, 1), **run), base(**run))


@pytest.mark.parametrize("kw,match", [
    (dict(particle_axis_size=0), "particle_axis_size must be >= 1"),
    (dict(n_devices=0), "n_devices must be >= 1"),
    (dict(chain_axis="x", particle_axis="x"), "must differ"),
])
def test_mesh_config_checks(kw, match):
    from bayesssm_tpu_torch.parallel import MeshConfig

    with pytest.raises(ValueError, match=match):
        MeshConfig(**kw)
