"""Start N ranks, one process each, and collect what each returns.

    results = spawn(fn, world=2, devices=["cuda:0", "cuda:1"])
    # fn(dp, *args) ran in each rank, dp a `parallel/mesh.py::DataParallel`

The processes start with the `spawn` method (CUDA needs it) through
`torch.multiprocessing`. They meet at a `file://` rendezvous in a new
temporary directory: it needs no network and no free port, and launches
running at once (parallel test workers) cannot meet each other's ranks.
Each rank sets its CUDA device before any CUDA work
(`init_data_parallel`). A rank that raises fails the whole launch: the
others are stopped and the parent raises with that rank's traceback; the
parent never returns over a dead rank. Where a device is a card, the
parent builds the port's kernel libraries once before the ranks start
(`ops/_build.py` writes each library atomically, so ranks loading at once
would only repeat nvcc's work).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as torch_mp


def _rank_main(rank: int, fn: Callable, world: int, devices, backend,
               rendezvous: str, out_dir: str, args: tuple) -> None:
    from lanedetection_end2end_tpu_torch.parallel.mesh import (
        init_data_parallel)
    dp = init_data_parallel(world, rank, devices[rank], backend, rendezvous)
    result = fn(dp, *args)
    dist.barrier()
    torch.save(result, os.path.join(out_dir, f"result_{rank}.pt"))
    dist.destroy_process_group()


def spawn(fn: Callable, world: int, backend: Optional[str] = None,
          devices: Optional[Sequence] = None, args: tuple = ()) -> List:
    """Run `fn(dp, *args)` on `world` ranks, rank r on `devices[r]`
    (default: every rank on the CPU), and return their results in rank
    order. `fn` and `args` must pickle (a module-level function); results
    come back through `torch.save` and load on the CPU. `backend` None:
    NCCL on cards, gloo on the CPU. The rendezvous directory is made in
    the temporary directory and removed after."""
    devices = [torch.device(d) for d in (devices or ["cpu"] * world)]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    if any(d.type == "cuda" for d in devices):
        from lanedetection_end2end_tpu_torch.ops import _build
        _build.build()
    out_dir = tempfile.mkdtemp(prefix="ld_ranks_")
    try:
        rendezvous = "file://" + os.path.join(out_dir, "rendezvous")
        torch_mp.start_processes(
            _rank_main, args=(fn, world, devices, backend, rendezvous,
                              out_dir, tuple(args)),
            nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(out_dir, f"result_{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
