"""Scale-out example: many chains on a mesh of devices, one process each.

The PyTorch port of ``examples/many_chains_mesh.py``. PMMH runs with the
chains axis sharded over every rank (each rank samples its block of
chains, with no communication in the sampling loop), then one large
particle filter is spread over the ranks' particle axis
(``sharded_bootstrap_filter``: collective weight steps).

Run one process per card with ``torchrun``:

    torchrun --nproc-per-node=<cards> examples/torch_many_chains_mesh.py

or let the script spawn its ranks (one per visible card by default):

    python examples/torch_many_chains_mesh.py [--ranks N]
    python examples/torch_many_chains_mesh.py --device cpu --ranks 2

On cards the ranks talk over NCCL, each driving the card of its local
rank; ``--device cpu`` runs them on the CPU over gloo.
"""

import argparse
import os
import pathlib
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from bayesssm_tpu_torch import default_tune_control, pmmh  # noqa: E402
from bayesssm_tpu_torch.models.lgss import (  # noqa: E402
    lgss_model,
    simulate_lgss,
)
from bayesssm_tpu_torch.ops import threefry  # noqa: E402
from bayesssm_tpu_torch.parallel import (  # noqa: E402
    global_chain_mesh,
    initialize,
    sharded_bootstrap_filter,
)


def run(rank, world, init_method, device=None, m=200, particles=4096):
    """The example on one rank of ``world``; returns ``(PMMHOutput,
    sharded filter log-likelihoods)``, the same on every rank."""
    if device == "cpu":
        torch.set_num_threads(1)
    dev = initialize(init_method, world, rank, device=device)
    if dev is None:   # one process: no group to join
        dev = device
    (init_fn, transition_fn, log_likelihood_fn), log_priors, transform = (
        lgss_model()
    )
    _, y = simulate_lgss(1405, t_val=25)

    mesh = global_chain_mesh()
    num_chains = 4 * world
    result = pmmh(
        "bootstrap_filter", y, m=m,
        init_fn=init_fn, transition_fn=transition_fn,
        log_likelihood_fn=log_likelihood_fn, log_priors=log_priors,
        pilot_init_params=[{"a": 0.5, "sigma_x": 0.5, "sigma_y": 0.5}]
        * num_chains,
        burn_in=m // 4, num_chains=num_chains, seed=0,
        param_transform=transform,
        tune_control=default_tune_control(pilot_m=max(20, m // 2),
                                          pilot_reps=20),
        mesh=mesh, print_summary=rank == 0, device=dev,
    )

    # Particle-axis sharding: one large filter spread over the ranks.
    mesh2 = global_chain_mesh(particle_axis_size=min(4, world))
    theta = {k: np.full(4, v, np.float32) for k, v in
             {"a": 0.9, "sigma_x": 0.6, "sigma_y": 0.4}.items()}
    ll, _ = sharded_bootstrap_filter(
        threefry.key(0), y, particles, init_fn, transition_fn,
        log_likelihood_fn, theta, num_chains=4, mesh=mesh2,
        resample_algorithm="SISR", device=dev,
    )
    if rank == 0:
        print("sharded filter loglikes:", ll.cpu().numpy())
    return result, ll.cpu().numpy()


def _rank(rank, world, init_method, device, m, particles):
    import torch.distributed as dist

    try:
        run(rank, world, init_method, device, m, particles)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help='"cpu" for gloo ranks on the CPU (default: '
                             "one card a rank, NCCL)")
    parser.add_argument("--ranks", type=int, default=None,
                        help="ranks to spawn (default: the visible cards; "
                             "ignored under torchrun)")
    parser.add_argument("--m", type=int, default=200)
    parser.add_argument("--particles", type=int, default=4096)
    args = parser.parse_args(argv)

    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:   # torchrun
        _rank(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
              "env://", args.device, args.m, args.particles)
        return 0
    if args.ranks is None and args.device != "cpu":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu")
        args.ranks = torch.cuda.device_count()
    world = args.ranks or 1
    if world == 1:
        run(0, 1, None, args.device, args.m, args.particles)
        return 0
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(
            _rank, args=(world, f"file://{tmp}/store", args.device, args.m,
                         args.particles),
            nprocs=world, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
