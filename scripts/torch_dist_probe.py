#!/usr/bin/env python3
"""What ``torch.distributed`` allows on one NVIDIA GPU: which backends take
two ranks on the same card, and whether gloo takes CUDA tensors.

Run from the root of a checkout: ``python3 scripts/torch_dist_probe.py``.
It spawns, from a parent that has touched CUDA, (1) two gloo ranks on
``cuda:0``, (2) one NCCL rank and (3) two NCCL ranks on ``cuda:0``, each
group joined through a ``file://`` store with a 60 s timeout. Every rank
runs ``all_reduce(MAX)``, ``all_gather`` (list and tensor forms) and
``broadcast`` on CUDA tensors, builds a ``(chains, particles)``
``DeviceMesh`` by ``DeviceMesh.from_group`` and by ``init_device_mesh``,
and times 20 ``all_gather`` calls of a [4096, 128] float32 tensor. Each
rank prints its results or its traceback; a rank that outlives 120 s is
killed. The printed lines are the result: a failing case is a finding,
not an error of the script.
"""

import datetime
import os
import queue
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_main(rank, world, backend, init, results):
    try:
        torch.cuda.set_device(0)
        t0 = time.time()
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=60))
        dev = torch.device("cuda", 0)
        res = {"init_s": time.time() - t0}
        x = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        res["max"] = x.tolist()
        y = torch.arange(3, device=dev, dtype=torch.float32) + 10 * rank
        parts = [torch.empty_like(y) for _ in range(world)]
        dist.all_gather(parts, y)
        res["gather"] = [p.tolist() for p in parts]
        big = torch.empty(3 * world, device=dev)
        dist.all_gather_into_tensor(big, y)
        res["gather_tensor"] = big.tolist()
        b = torch.full((2,), float(rank), device=dev)
        dist.broadcast(b, src=0)
        res["broadcast"] = b.tolist()
        from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

        timeout = datetime.timedelta(seconds=30)
        whole = dist.new_group(list(range(world)), timeout=timeout)
        alone = [dist.new_group([r], timeout=timeout) for r in range(world)]
        mesh = DeviceMesh.from_group(
            [alone[rank], whole], "cuda",
            mesh=torch.arange(world).reshape(1, world),
            mesh_dim_names=("chains", "particles"))
        res["from_group"] = (mesh["particles"].size(),
                             mesh.get_local_rank("particles"))
        mesh = init_device_mesh("cuda", (1, world),
                                mesh_dim_names=("chains", "particles"))
        res["init_device_mesh"] = (mesh["particles"].size(),
                                   mesh.get_local_rank("particles"))
        z = torch.randn(4096, 128, device=dev)
        parts = [torch.empty_like(z) for _ in range(world)]
        for _ in range(3):
            dist.all_gather(parts, z)
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(20):
            dist.all_gather(parts, z)
        torch.cuda.synchronize()
        res["all_gather_4096x128_ms"] = (time.time() - t0) / 20 * 1e3
        dist.destroy_process_group()
        results.put((rank, "ok", res))
    except Exception:  # the probe's finding: report it and go on
        results.put((rank, "error", traceback.format_exc()[-1500:]))


def run(tag, world, backend):
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=rank_main,
                             args=(r, world, backend, init, results))
                 for r in range(world)]
        t0 = time.time()
        for p in procs:
            p.start()
        got = []
        deadline = time.time() + 120
        while len(got) < world and time.time() < deadline:
            try:
                got.append(results.get(timeout=5))
            except queue.Empty:
                pass
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
    print(f"=== {tag}: {time.time() - t0:.1f} s, exit codes "
          f"{[p.exitcode for p in procs]}")
    for item in sorted(got, key=lambda r: r[0]):
        print(item)
    sys.stdout.flush()


def main():
    if not torch.cuda.is_available():
        print("torch_dist_probe: no CUDA device", file=sys.stderr)
        return 1
    print(sys.version, torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), torch.cuda.device_count())
    print("nccl", dist.is_nccl_available(),
          torch.cuda.nccl.version() if dist.is_nccl_available() else None)
    torch.zeros(1, device="cuda")   # the parent has touched CUDA
    run("gloo, 2 ranks on cuda:0", 2, "gloo")
    run("nccl, 1 rank", 1, "nccl")
    run("nccl, 2 ranks on cuda:0", 2, "nccl")
    return 0


if __name__ == "__main__":
    sys.exit(main())
