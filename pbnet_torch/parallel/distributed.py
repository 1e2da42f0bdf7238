"""Multi-process (and multi-host) rendezvous over ``torch.distributed``
(port of pbnet_tpu/parallel/distributed.py).

The JAX package runs one process per host driving every local device; the
port runs one process per device (rank), PyTorch's idiom.  The reference's
multi-node knobs map as: ``world = nodes * local ranks``, ``rank = node_rank
* local ranks + local_rank``, rendezvous at ``tcp://<coordinator>`` (default
``127.0.0.1:<tcp_port>``, the address the reference hard-codes).  The
backend is the caller's choice: ``nccl`` for CUDA ranks on distinct devices,
``gloo`` for CPU ranks (or several ranks on one device).
"""

from __future__ import annotations

import datetime
import time

import torch.distributed as dist

# (node_rank, nodes) of this process, set by initialize_from_config
_HOST = (0, 1)


def initialize(init_method: str, world: int, rank: int, backend: str,
               timeout_s: float = 600.0) -> tuple[int, int]:
    """Join the process group; returns (rank, world).  A world of one is a
    no-op returning (0, 1)."""
    if world <= 1:
        return 0, 1
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank(), dist.get_world_size()


def initialize_from_config(cfg, local_rank: int = 0, local_world: int = 1,
                           backend: str = "gloo", timeout_s: float = 600.0) -> tuple[int, int]:
    """Wire ``cfg.nodes``/``node_rank``/``coordinator``/``tcp_port`` and this
    process's local rank into ``initialize``; returns (rank, world)."""
    global _HOST
    _HOST = (cfg.node_rank, cfg.nodes)
    coord = cfg.coordinator or f"127.0.0.1:{cfg.tcp_port}"
    return initialize(f"tcp://{coord}", cfg.nodes * local_world,
                      cfg.node_rank * local_world + local_rank, backend, timeout_s)


def local_data_rank() -> tuple[int, int]:
    """(this host's index, number of hosts): the shard of the scene list
    this host's ranks draw from."""
    return _HOST


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn(fn, nprocs: int, args: tuple = (), join_timeout_s: float | None = None) -> None:
    """Run ``fn(local_rank, *args)`` in ``nprocs`` fresh processes (start
    method ``spawn``: a fork after torch's threads exist is unsafe) and wait
    for all of them.  A rank that raises ends the others and its traceback
    is raised here; past ``join_timeout_s`` every rank is killed and
    ``TimeoutError`` raised, so that a rank left waiting in a collective by
    a dead peer cannot hang the caller."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = None if join_timeout_s is None else time.monotonic() + join_timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks did not finish within {join_timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
