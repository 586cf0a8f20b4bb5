"""Multi-process distribution: process-group init and the global mesh.

Counterpart of the reference package's `parallel/distributed.py`, on
`torch.distributed`. Every process contributes its local devices to one
global 2D tile mesh, in contiguous row-bands, and renders the blocks of
its own cells; the mesh's collectives (`parallel.mesh`) cross processes:
the forward gathers the blocks' planes for assembly and post, the fit
step all-reduces the loss and the 15 leaf gradients. Tile assignment is
placement-invariant, so N-process output equals 1-process output.

Backends: gloo for CPU tensors and wherever two ranks share one card
(NCCL refuses two ranks on one GPU); NCCL where each rank has its own
card. Nothing tells a process of a cluster: the address, the world size
and the rank come from the arguments or from the variables `torchrun`
sets (`MASTER_ADDR`, `MASTER_PORT`, `WORLD_SIZE`, `RANK`,
`LOCAL_RANK`, `LOCAL_WORLD_SIZE`).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from sphereflake_tpu_torch.parallel.mesh import Mesh


def _dist():
    import torch.distributed as dist

    return dist


def process_device(device="cuda") -> torch.device:
    """This process's device: the CPU, or the card of its local rank
    (local ranks beyond the card count share cards, round robin)."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local_rank % max(1, torch.cuda.device_count()))


def choose_backend(device, num_processes: int) -> str:
    """gloo on the CPU or where ranks share a card; else NCCL."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", str(num_processes)))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device="cuda",
    backend: str | None = None,
) -> None:
    """Bring up the process group (nothing to do for a single process).

    `coordinator_address` is "host:port"; the arguments default to
    `torchrun`'s variables. `backend` defaults to `choose_backend`."""
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (
            f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
        )
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if num_processes <= 1:
        return  # single process: nothing to initialize
    if coordinator_address is None:
        raise ValueError(
            "a multi-process run needs a coordinator address "
            "(MASTER_ADDR / MASTER_PORT or coordinator_address=)"
        )
    _dist().init_process_group(
        backend or choose_backend(device, num_processes),
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )


def process_info() -> tuple[int, int]:
    """(process_index, process_count)."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_mesh(shape=None, local_devices=None) -> Mesh:
    """2D tile mesh over ALL processes' devices (call after
    `initialize_distributed`). Each process contributes `local_devices`
    (default: its `process_device()`); cells are laid out so that each
    process's devices form contiguous row-bands, in rank order — the
    forward needs no cross-process traffic until blocks are assembled.
    `shape` defaults to one column, (devices, 1)."""
    rank, world = process_info()
    local = [str(d) for d in (local_devices or [process_device()])]
    if world > 1:
        everyone = [None] * world
        _dist().all_gather_object(everyone, local)
    else:
        everyone = [local]
    devices = [d for per_rank in everyone for d in per_rank]
    ranks = [r for r, per_rank in enumerate(everyone) for _ in per_rank]
    n = len(devices)
    shape = shape or (n, 1)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), ("ty", "tx"), ranks=ranks, rank=rank)
