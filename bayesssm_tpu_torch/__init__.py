"""bayesssm_tpu_torch — the PyTorch + CUDA port of ``bayesssm_tpu``.

Runs PMMH on an NVIDIA H100 for the JAX package's model zoo (stochastic
SIR with the exact Gillespie day or tau-leaping, the README's sinusoidal
model, stochastic volatility, the linear-Gaussian SSM with a scalar or a
vector observation) along two paths: the batched whole-sweep filter
(``ops/sweep_builder.py``, CUDA kernel ``csrc/sweep.cuh`` with one functor
per model: SIR, LGSS, LGSS-mv, sinusoidal, and for a user's own ``torch``
callbacks a functor generated from them, ``ops/sweep_codegen.py``), and
the generic
particle-filter engine
(``filters/core.py``; ``bootstrap_filter``, ``auxiliary_filter``,
``resample_move_filter``) with its per-day kernels, the
fused weight step (``csrc/resample.cu``) and the Gillespie day-step
(``csrc/gillespie.cu``); either one serves ``pmmh()``, the two-phase PMMH
driver with pilot tuning, ESS/R-hat diagnostics and ``PMMHOutput``
(``pmmh/driver.py``), on one device or on every rank of a
``torch.distributed`` mesh, chains and particles sharded over the ranks
(``parallel/``). The kernels are built by ``nvcc`` at first use, and
every kernel has a plain PyTorch version beside it, which CPU tensors
take. The JAX package ``bayesssm_tpu`` stays the reference; this package
never imports JAX.
"""

__version__ = "0.1.0"

_EXPORTS = {
    "bootstrap_filter": "bayesssm_tpu_torch.filters.bootstrap",
    "auxiliary_filter": "bayesssm_tpu_torch.filters.auxiliary",
    "resample_move_filter": "bayesssm_tpu_torch.filters.resample_move",
    "particle_filter_core": "bayesssm_tpu_torch.filters.core",
    "FilterConfig": "bayesssm_tpu_torch.filters.core",
    "FilterResult": "bayesssm_tpu_torch.filters.core",
    "build_sweep_op": "bayesssm_tpu_torch.ops.sweep_builder",
    "build_sweep_pf_impl": "bayesssm_tpu_torch.ops.sweep_builder",
    "lgss_bpf_sweep": "bayesssm_tpu_torch.ops.lgss_sweep",
    "lgss_mv_bpf_sweep": "bayesssm_tpu_torch.ops.lgss_sweep",
    "lgss_sweep_pf_impl": "bayesssm_tpu_torch.ops.lgss_sweep",
    "sir_filter_sweep": "bayesssm_tpu_torch.ops.sir_sweep",
    "sir_bpf_sweep": "bayesssm_tpu_torch.ops.sir_sweep",
    "sir_model": "bayesssm_tpu_torch.models.sir",
    "sir_sweep_pf_impl": "bayesssm_tpu_torch.models.sir",
    "sir_aux_log_likelihood_fn": "bayesssm_tpu_torch.models.sir",
    "sir_move_fn": "bayesssm_tpu_torch.models.sir",
    "simulate_sir": "bayesssm_tpu_torch.models.sir",
    "tau_leap_step": "bayesssm_tpu_torch.models.sir",
    "lgss_model": "bayesssm_tpu_torch.models.lgss",
    "simulate_lgss": "bayesssm_tpu_torch.models.lgss",
    "lgss_mv_model": "bayesssm_tpu_torch.models.lgss",
    "simulate_lgss_mv": "bayesssm_tpu_torch.models.lgss",
    "sinusoidal_model": "bayesssm_tpu_torch.models.sinusoidal",
    "sinusoidal_sweep_pf_impl": "bayesssm_tpu_torch.models.sinusoidal",
    "simulate_sinusoidal": "bayesssm_tpu_torch.models.sinusoidal",
    "sv_model": "bayesssm_tpu_torch.models.stochastic_volatility",
    "simulate_sv": "bayesssm_tpu_torch.models.stochastic_volatility",
    "kalman_loglik": "bayesssm_tpu_torch.utils.kalman",
    "kalman_loglik_mv": "bayesssm_tpu_torch.utils.kalman",
    "pmmh": "bayesssm_tpu_torch.pmmh.driver",
    "default_tune_control": "bayesssm_tpu_torch.pmmh.tuning",
    "TuneControl": "bayesssm_tpu_torch.pmmh.tuning",
    "ess": "bayesssm_tpu_torch.diagnostics.ess",
    "rhat": "bayesssm_tpu_torch.diagnostics.rhat",
    "PMMHOutput": "bayesssm_tpu_torch.output",
    "SSM": "bayesssm_tpu_torch.ssm",
    "ChainState": "bayesssm_tpu_torch.pmmh.driver",
    "chain_state_from_pilot": "bayesssm_tpu_torch.pmmh.driver",
    "chain_state_from_numpy": "bayesssm_tpu_torch.pmmh.driver",
    "init_chain_state": "bayesssm_tpu_torch.pmmh.driver",
    "mh_step": "bayesssm_tpu_torch.pmmh.driver",
    "sample_chains": "bayesssm_tpu_torch.pmmh.driver",
    "MeshConfig": "bayesssm_tpu_torch.parallel.mesh",
    "make_chain_mesh": "bayesssm_tpu_torch.parallel.mesh",
    "shard_chain_tree": "bayesssm_tpu_torch.parallel.mesh",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    # Lazy exports: importing the package loads no submodule.
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
