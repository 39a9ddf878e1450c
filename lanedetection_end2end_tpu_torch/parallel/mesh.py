"""The data-parallel world: one process per rank, the batch split on axis
0, the state replicated.

Counterpart of `lanedetection_end2end_tpu/parallel/mesh.py`. JAX builds a
1-D "data" mesh, or a two-level ("dcn", "data") mesh whose only effect is
to tell XLA which links are slow; here one flat process group carries the
collectives and NCCL picks its own rings over the links it finds, so
`num_slices` keeps only JAX's rule that it divides the rank count
(`check_slices`).

    dp = init_data_parallel(world, rank, "cuda:1", "nccl", "file:///...")
    replicate(model, dp.group)          # rank 0's parameters everywhere
    local = local_rows(batch, dp.group) # this rank's rows of the batch

The backend is explicit: NCCL where each rank has a card of its own (the
default for a CUDA device), gloo on the CPU (the default there) or where
the caller asks for it, e.g. several ranks sharing one card. A failed
initialization raises; nothing falls back to another backend or to one
rank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """One rank of the world: its process group (the whole world), rank,
    world size, device and backend."""
    group: object
    rank: int
    world: int
    device: torch.device
    backend: str

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_data_parallel(world: int, rank: int, device,
                       backend: Optional[str] = None,
                       rendezvous: str = "") -> DataParallel:
    """Join the world of `world` ranks as `rank` on `device` through the
    `rendezvous` URL (`file://` or `tcp://localhost:<port>`); `backend`
    None: `default_backend(device)`. Sets the current CUDA device first."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            raise ValueError("a rank's CUDA device needs its index")
        torch.cuda.set_device(device)
    backend = backend or default_backend(device)
    # NCCL binds the rank's card at once (its barrier then needs no guess)
    bind = dict(device_id=device) if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=rendezvous,
                            world_size=world, rank=rank, **bind)
    return DataParallel(dist.group.WORLD, rank, world, device, backend)


def check_slices(world: int, num_slices: int) -> None:
    """JAX's rule for its two-level mesh: `num_slices` divides the
    ranks."""
    if num_slices < 1 or world % num_slices:
        raise ValueError(f"{world} devices do not divide into "
                         f"num_slices={num_slices}")


def _flat_by_dtype(tensors):
    groups: Dict[torch.dtype, list] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups.values()


@torch.no_grad()
def replicate(module: torch.nn.Module, group) -> None:
    """Broadcast rank 0's parameters and buffers to every rank, in place:
    one flat buffer per dtype. None: nothing to do."""
    if group is None:
        return
    tensors = [t.data for t in module.parameters()] + list(module.buffers())
    for same in _flat_by_dtype(tensors):
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.broadcast(flat, src=0, group=group)
        off = 0
        for t in same:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def local_slice(batch_size: int, group) -> slice:
    """This rank's contiguous rows of a global batch: rank r owns [r*b,
    (r+1)*b) with b = batch_size / world, as JAX's
    `batch_sharding` lays rows over the "data" axis."""
    if group is None:
        return slice(0, batch_size)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if batch_size % world:
        raise ValueError(f"global batch {batch_size} does not divide over "
                         f"{world} ranks")
    b = batch_size // world
    return slice(rank * b, (rank + 1) * b)


def local_rows(batch, group):
    """This rank's rows of a global batch: a tensor or array, or a dict of
    them (every entry sliced on axis 0)."""
    if isinstance(batch, dict):
        return {k: local_rows(v, group) for k, v in batch.items()}
    if not isinstance(batch, (torch.Tensor, np.ndarray)):
        raise TypeError(f"local_rows takes tensors, got {type(batch)}")
    return batch[local_slice(batch.shape[0], group)]


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s draws (dropout): `seed` itself on rank 0,
    so one process draws as it always did, and apart on every other rank,
    as JAX folds the shard index into its key."""
    return seed + (rank << 32)
