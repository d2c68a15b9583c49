"""Multi-device runs: meshes over ``torch.distributed`` ranks, the
named-axis collectives, process start-up and the particle-sharded
filters. Exports load lazily: importing the subpackage loads no
submodule."""

_EXPORTS = {
    "MeshConfig": "bayesssm_tpu_torch.parallel.mesh",
    "make_chain_mesh": "bayesssm_tpu_torch.parallel.mesh",
    "shard_chain_tree": "bayesssm_tpu_torch.parallel.mesh",
    "chain_sharding": "bayesssm_tpu_torch.parallel.mesh",
    "use_mesh": "bayesssm_tpu_torch.parallel.mesh",
    "initialize": "bayesssm_tpu_torch.parallel.distributed",
    "global_chain_mesh": "bayesssm_tpu_torch.parallel.distributed",
    "sharded_particle_filter": "bayesssm_tpu_torch.parallel.sharded",
    "sharded_bootstrap_filter": "bayesssm_tpu_torch.parallel.sharded",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
