"""The data-parallel layout of the ranks (port of pbnet_tpu/parallel/mesh.py).

The JAX package stacks one batch per device along a mesh axis (``DATA_AXIS``)
and averages over it with ``pmean``.  Here each rank is one process on one
device: the data axis is a ``torch.distributed`` process group, a rank's
device is ``cuda:<local rank>`` (or the CPU), and a rank takes every
``local_world``-th batch of its host's list, so that rank ``r`` at step
``t`` trains on the batch JAX's device ``r`` gets: ``t * local_world + r``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import telemetry

DATA_AXIS = "data"


def data_group():
    """The process group the step averages over (every rank), or None when
    this process runs alone."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def local_device_count(device_type: str, num_devices: int = 0) -> int:
    """Ranks on this host: ``num_devices``, or (0) every visible GPU; one
    CPU rank."""
    if num_devices:
        return num_devices
    return torch.cuda.device_count() if device_type == "cuda" else 1


def rank_device(device_type: str, local_rank: int) -> torch.device:
    return torch.device("cuda", local_rank) if device_type == "cuda" else torch.device("cpu")


def rank_batches(batches: list, local_rank: int, local_world: int) -> list:
    """The batches local rank ``local_rank`` takes from its host's list:
    ``batches[t * local_world + local_rank]`` at step ``t``, full steps only
    (a partial group at the end is dropped on every rank)."""
    n = len(batches) // local_world * local_world
    return batches[local_rank:n:local_world]


@telemetry.span("pbnet.allreduce")
def pmean_(tensors: list[torch.Tensor], group) -> None:
    """Average ``tensors`` over ``group`` in place with one all-reduce of
    their flattened concatenation (``jax.lax.pmean``)."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    i = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[i:i + n].view_as(t))
        i += n
