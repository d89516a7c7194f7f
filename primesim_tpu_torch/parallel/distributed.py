"""Multi-process scale-out: the JAX package's `parallel/distributed.py`
for the port.

The JAX package connects the processes with `jax.distributed` and lets
the mesh span every process's devices. The port connects them with a
`torch.distributed` process group (gloo on the CPU, NCCL on cards) and
gives the mesh a second exchange, `GroupExchange`, with the methods of
`sharding.LocalExchange` over that group: the step's code is the same in
one process or several. Every process runs the same program (SPMD), holds
its own block of shards and computes the replicated lane logic itself.

Launch one process per host (or per group of devices):

    # process 0                             # process 1
    init_multi_host("127.0.0.1:29500", 2, 0)   init_multi_host(..., 2, 1)
    mesh = global_tile_mesh()
    eng = Engine(cfg, trace, mesh=mesh, device=...)   # same program
    eng.run()
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .sharding import LocalExchange, MeshDevice, TileMesh, record, visible_devices


def init_multi_host(coordinator_address: str, num_processes: int,
                    process_id: int, backend: str | None = None, **kw) -> None:
    """Connect this process to the job (once per process, before any
    mesh is made): `coordinator_address` is host:port of process 0."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    addr = coordinator_address
    if "://" not in addr:
        addr = f"tcp://{addr}"
    dist.init_process_group(backend, init_method=addr, world_size=num_processes,
                            rank=process_id, **kw)


class GroupExchange(LocalExchange):
    """`LocalExchange` over the default process group: lane gathers are
    all-gathers, partial sums all-reduces, and a row request is answered
    by every process's bank shards and summed by an all-reduce."""

    def _allcat(self, name: str, x: torch.Tensor, axis: int) -> torch.Tensor:
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        record(name, x)
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts, axis)

    def _allsum(self, name: str, x: torch.Tensor) -> torch.Tensor:
        record(name, x)
        dist.all_reduce(x)
        return x

    def full(self, x, device) -> torch.Tensor:
        local = torch.cat([p.to(self.mesh.lead) for p in x], x.axis)
        parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, local.contiguous())
        return torch.cat(parts, x.axis).to(device)


def global_tile_mesh(platform: str | None = None) -> TileMesh:
    """The tile mesh over EVERY process's devices: each process's visible
    devices, in rank order (each process must see as many). Without a
    process group it is the local mesh."""
    local = visible_devices(platform)
    if not dist.is_initialized():
        return TileMesh(local)
    world, rank = dist.get_world_size(), dist.get_rank()
    n = len(local)
    devices = [
        MeshDevice(p * n + j, local[j].device if p == rank else torch.device("meta"))
        for p in range(world) for j in range(n)
    ]
    return TileMesh(devices, exchange=GroupExchange,
                    local=range(rank * n, (rank + 1) * n))


def process_info() -> dict:
    """Small diagnostic bundle for launch scripts and logs."""
    up = dist.is_initialized()
    n = len(visible_devices())
    count = dist.get_world_size() if up else 1
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": count,
        "local_devices": n,
        "global_devices": n * count,
    }
