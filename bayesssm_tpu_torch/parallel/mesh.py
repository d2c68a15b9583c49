"""Device meshes for chain-parallel PMMH (port of
``bayesssm_tpu/parallel/mesh.py``).

One process runs on each device, and the processes form a
``torch.distributed`` group (``parallel/distributed.py``). A mesh is
PyTorch's ``DeviceMesh`` over those ranks, shaped ``(chains, particles)``
like the JAX package's ``Mesh(devices.reshape(...), ("chains",
"particles"))``: rank ``r`` sits at ``(r // ps, r % ps)``. Chains are the
embarrassingly parallel axis; a particle axis larger than 1 shards each
filter's particles over its ranks.

The driver and the filters run on each rank's local block, as JAX's
``shard_map`` does: the CUDA kernels have no sharding rules, so no phase
runs on DTensors. :func:`use_mesh` makes a mesh current for the named-axis
collectives of ``parallel/collectives.py``, the counterpart of
``shard_map``'s axis environment. Only :func:`chain_sharding` and
:func:`shard_chain_tree` hand out DTensor placements, ``(Shard(0),
Replicate())``, the counterpart of ``NamedSharding(mesh, P("chains"))``.

Every process group a mesh makes is created with a timeout
(``GROUP_TIMEOUT``), so a collective that one rank never joins fails
instead of hanging. A plain single process, with no process group, gets
a 1 x 1 mesh over a one-rank group that it makes for itself.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime

import torch

from bayesssm_tpu_torch.parallel.collectives import _MESH

__all__ = [
    "MeshConfig",
    "make_chain_mesh",
    "shard_chain_tree",
    "chain_sharding",
    "use_mesh",
    "GROUP_TIMEOUT",
]

# Timeout of every process group the port creates.
GROUP_TIMEOUT = datetime.timedelta(minutes=5)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Typed mesh configuration (the JAX class's fields and checks).

    ``build()`` makes the ``(chain_axis, particle_axis)`` mesh over the
    ranks of the process group; pass it to ``pmmh(mesh=...)``.
    """

    n_devices: int | None = None
    particle_axis_size: int = 1
    chain_axis: str = "chains"
    particle_axis: str = "particles"

    def __post_init__(self):
        if self.particle_axis_size < 1:
            raise ValueError("particle_axis_size must be >= 1")
        if self.n_devices is not None and self.n_devices < 1:
            raise ValueError("n_devices must be >= 1")
        if self.chain_axis == self.particle_axis:
            raise ValueError("chain_axis and particle_axis must differ")

    def build(self, devices=None):
        """Create the ``(chain_axis, particle_axis)`` mesh."""
        return _mesh(self.n_devices, self.particle_axis_size, devices,
                     (self.chain_axis, self.particle_axis))


def make_chain_mesh(n_devices: int | None = None,
                    particle_axis_size: int = 1, devices=None):
    """Create a ``("chains", "particles")`` mesh over every rank.

    ``n_devices`` defaults to the number of ranks (1 without a process
    group) and must equal it: each rank drives one device. ``devices`` is
    the device type of the mesh (``"cuda"``, ``"cpu"`` or a
    ``torch.device``); by default ``"cuda"`` where a card is visible and
    ``"cpu"`` otherwise, as ``jax.devices()`` lists the accelerators
    first. ``particle_axis_size`` > 1 carves ranks off for particle-axis
    sharding.
    """
    return _mesh(n_devices, particle_axis_size, devices,
                 ("chains", "particles"))


def _world() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _ensure_group() -> None:
    """A one-rank process group for a process that has none: a mesh
    needs one, and it stays local (an in-process store)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1, timeout=GROUP_TIMEOUT)


def _device_type(devices) -> str:
    if devices is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(devices).type


def _mesh(n_devices, particle_axis_size, devices, names):
    world = _world()
    n = world if n_devices is None else int(n_devices)
    if n % particle_axis_size:
        raise ValueError("n_devices must be divisible by particle_axis_size")
    if n != world:
        raise ValueError(
            f"n_devices={n} must equal the number of ranks ({world}): each "
            "rank of the process group drives one device")
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    _ensure_group()
    ps = particle_axis_size
    cs = n // ps
    rank = dist.get_rank()
    grid = torch.arange(n).reshape(cs, ps)
    # Every rank creates every group, in the same order (new_group is a
    # collective over the default group).
    mine = []
    for lines in (grid.t(), grid):
        for line in lines.tolist():
            group = dist.new_group(line, timeout=GROUP_TIMEOUT)
            if rank in line:
                mine.append(group)
    return DeviceMesh.from_group(mine, _device_type(devices), mesh=grid,
                                 mesh_dim_names=tuple(names))


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` current for the named-axis collectives inside the
    block (``parallel/collectives.py``)."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def chain_sharding(mesh) -> tuple:
    """The DTensor placements on ``mesh`` that split axis 0 (chains) over
    its chains axis and replicate over its particle axis."""
    from torch.distributed.tensor import Replicate, Shard

    if tuple(mesh.mesh_dim_names or ())[:1] != ("chains",):
        raise ValueError("chain_sharding needs a mesh whose first axis is "
                         "'chains'")
    return (Shard(0), Replicate())


def shard_chain_tree(tree, mesh):
    """Every tensor of a dict / list / tuple tree as a DTensor on ``mesh``
    with its axis 0 sharded on chains (``chain_sharding``). Each rank
    passes the full tensors, as ``jax.device_put`` takes host arrays."""
    from torch.distributed.tensor import distribute_tensor

    placements = list(chain_sharding(mesh))

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        return distribute_tensor(torch.as_tensor(x), mesh, placements)

    return put(tree)
