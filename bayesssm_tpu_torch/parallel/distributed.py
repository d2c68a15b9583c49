"""Multi-process start-up (port of ``bayesssm_tpu/parallel/distributed.py``).

One process drives one device. Call :func:`initialize` once in every
process, then build the global mesh with :func:`global_chain_mesh`:
chains shard over the ranks with no communication in the sampling loop,
and collectives run only where ``pmmh()`` gathers its outputs (or, with a
particle axis, inside each filter's weight step).

By default the processes talk over NCCL, and each drives the card of its
local rank; ``device="cpu"`` runs them on the CPU over gloo. Nothing falls
back from one to the other.
"""

from __future__ import annotations

import torch

from bayesssm_tpu_torch.parallel.mesh import (
    GROUP_TIMEOUT,
    _world,
    make_chain_mesh,
)

__all__ = ["initialize", "global_chain_mesh"]


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, *, device=None):
    """Join a ``num_processes``-rank process group as rank ``process_id``
    (a no-op for ``None`` or 1, as in JAX). Returns the device this rank
    drives, or ``None`` for the no-op.

    ``coordinator_address`` is ``host:port`` (``tcp://`` is added) or any
    ``init_method`` URL (``tcp://``, ``file://``). ``device=None`` takes
    NCCL and ``cuda:<local rank>``, the local rank being ``LOCAL_RANK``
    where a launcher such as ``torchrun`` sets it and ``process_id``
    modulo the visible cards otherwise; it raises without a card.
    ``device="cpu"`` takes gloo on the CPU.
    """
    if num_processes in (None, 1):
        return None
    import os

    import torch.distributed as dist

    if coordinator_address is None or process_id is None:
        raise ValueError(
            "coordinator_address and process_id are required with "
            "num_processes > 1")
    address = str(coordinator_address)
    if "://" not in address:
        address = f"tcp://{address}"
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "initialize() drives a CUDA device by default and found "
                'none; pass device="cpu" to run the ranks on the CPU')
        local = int(os.environ.get(
            "LOCAL_RANK", int(process_id) % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        dev = torch.device(device)
        if dev.type != "cpu":
            raise ValueError('device must be None (NCCL on the card) or '
                             '"cpu" (gloo)')
        backend = "gloo"
    dist.init_process_group(backend, init_method=address,
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=GROUP_TIMEOUT)
    return dev


def global_chain_mesh(particle_axis_size: int = 1):
    """A ``("chains", "particles")`` mesh over every rank of the process
    group (``make_chain_mesh`` over all of them)."""
    n = _world()
    if n % particle_axis_size:
        raise ValueError("device count must divide particle_axis_size")
    return make_chain_mesh(n, particle_axis_size)
