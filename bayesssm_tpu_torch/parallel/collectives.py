"""Named-axis collectives over the current mesh: the port's counterpart of
``lax.axis_index``, ``lax.psum``, ``lax.pmax`` and ``lax.all_gather``.

JAX resolves an axis name inside ``shard_map`` from the mesh it maps
over. Here every rank is one process of a ``torch.distributed`` group and
runs the filter on its own local block, and ``parallel.mesh.use_mesh``
makes a ``DeviceMesh`` current for the calls inside it: an axis name is
looked up in that mesh, and the collective runs on the mesh's process
group of that axis (``mesh.get_group(axis)``).

Every rank of a group ends with the same bits:

* :func:`psum` is an ``all_gather`` followed by a sum in shard order, not
  the backend's ``all_reduce(SUM)``, whose order NCCL and gloo choose per
  call. The particle-sharded filter needs equal sums on its shards: each
  shard draws the same resampling positions against what must be the same
  CDF (``ops/resampling.py::sharded_resample_indices``), and the chains'
  MH decisions on every shard of a group must agree;
* :func:`pmax` is ``all_reduce(MAX)``, which is exact.

A collective over an axis of size 1 still runs on its one-rank group, so
that a mesh run's gathers go through the backend it names (NCCL on a card)
whatever the mesh's shape; the values are its input's.
"""

from __future__ import annotations

import contextvars

import torch

__all__ = ["current_mesh", "axis_index", "axis_size", "pmax", "psum",
           "all_gather"]

# The mesh that ``parallel.mesh.use_mesh`` made current.
_MESH = contextvars.ContextVar("bayesssm_tpu_torch_mesh", default=None)


def current_mesh():
    """The mesh made current by ``use_mesh``; raises ``NameError`` outside
    one, as JAX does for an axis name outside ``shard_map``."""
    mesh = _MESH.get()
    if mesh is None:
        raise NameError(
            "unbound axis name: no mesh is current (run the call inside "
            "bayesssm_tpu_torch.parallel.mesh.use_mesh(mesh))")
    return mesh


def _dim(mesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise NameError(f"unbound axis name: {axis} (mesh axes {names})")
    return names.index(axis)


def axis_size(axis: str) -> int:
    """The number of shards along ``axis`` (``mesh.shape[axis]``)."""
    mesh = current_mesh()
    return mesh.size(_dim(mesh, axis))


def axis_index(axis: str) -> int:
    """This rank's index along ``axis`` (``lax.axis_index``)."""
    mesh = current_mesh()
    _dim(mesh, axis)
    return mesh.get_local_rank(axis)


def _gather_list(x: torch.Tensor, axis: str) -> list:
    import torch.distributed as dist

    mesh = current_mesh()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size(_dim(mesh, axis)))]
    dist.all_gather(parts, x, group=mesh.get_group(axis))
    return parts


def all_gather(x: torch.Tensor, axis: str, dim: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Every shard's ``x`` in shard order: concatenated along ``dim``
    (``tiled=True``) or stacked on a new axis ``dim``."""
    parts = _gather_list(x, axis)
    return torch.cat(parts, dim=dim) if tiled else torch.stack(parts, dim)


def psum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The sum over the shards of ``axis``, taken in shard order from the
    gathered values, so every shard holds the same bits."""
    parts = _gather_list(x, axis)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def pmax(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The elementwise maximum over the shards of ``axis``."""
    import torch.distributed as dist

    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX,
                    group=current_mesh().get_group(axis))
    return out
