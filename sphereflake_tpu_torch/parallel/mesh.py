"""Device meshes for screen-tile parallelism, and the mesh's collectives.

Counterpart of the reference package's `parallel/mesh.py`. The C++
app's parallelism is N identical worker threads sharding the pixel
stream over shared memory (`Sphereflake.cpp:67-74`); here it is a 2D
mesh of devices over screen blocks. Rays are independent in the forward
pass, so the only collectives are metric reductions and the gathers
that assemble blocks; the backward pass sums gradients.

torch has no `shard_map`: a per-block body runs once per mesh cell, on
that cell's device, in a Python loop. A device may appear more than
once in a mesh — the port's counterpart of XLA's
`--xla_force_host_platform_device_count`: the CPU tests run meshes of
`[cpu] * 8`, and one H100 runs a 2x2 mesh as `[cuda:0] * 4`.

A mesh may span processes (`parallel.distributed.global_mesh`): every
cell then records the rank that owns it, a process runs the bodies of
its own cells only, and the collectives below also cross processes
through `torch.distributed` (gloo stages tensors through the host, NCCL
takes them on the card). They are the only place where blocks meet:

- `psum` / `pmax` / `pmin`: a reduction on the mesh's home device (its
  first local cell), then across processes;
- `all_gather`: every cell's tensor, in row-major cell order, on the
  home device (`jax.lax.all_gather(..., tiled=True)` is `torch.cat` of
  that list; `tile_blocks` assembles 2D image blocks);
- `broadcast`: a home tensor (or scene) on every local cell's device.

Each adds the bytes that reach one cell from another to the counter
`mesh.peer_bytes` of the open stage-span unit (`spans.py`). A cell is
counted as a cell whatever its device, so a mesh of `[cpu] * 4` counts
what four cards would move.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sphereflake_tpu_torch import spans


class Mesh:
    """An array of devices with axis names (("ty", "tx") for screen
    blocks, ("dp",) for frame data parallelism). `ranks` holds the
    process that owns each cell (default: all this process's); `rank`
    is this process's."""

    def __init__(self, devices, axis_names, ranks=None, rank: int = 0):
        given = np.asarray(devices, dtype=object)
        shape = given.shape
        devs = np.empty(given.size, dtype=object)
        devs[:] = [torch.device(d) for d in given.reshape(-1)]
        if len(shape) != len(axis_names):
            raise ValueError(
                f"mesh of shape {shape} needs {len(shape)} axis names, got "
                f"{axis_names}"
            )
        self.devices = devs.reshape(shape)
        self.axis_names = tuple(axis_names)
        self.ranks = (
            np.zeros(shape, dtype=np.int64) if ranks is None
            else np.asarray(ranks, dtype=np.int64).reshape(shape)
        )
        self.rank = int(rank)
        if not (self.ranks == self.rank).any():
            raise ValueError(f"rank {self.rank} owns no cell of the mesh")

    @property
    def shape(self) -> tuple:
        return self.devices.shape

    @property
    def size(self) -> int:
        return self.devices.size

    def local_cells(self) -> list:
        """[(index, device)] of this process's cells in row-major order;
        `index` is (iy, ix) on a 2D mesh, (i,) on a 1D one."""
        return [
            (idx, self.devices[idx])
            for idx in np.ndindex(*self.shape)
            if self.ranks[idx] == self.rank
        ]

    @property
    def home(self) -> torch.device:
        """Where collectives leave their results: the first local cell's
        device."""
        return self.local_cells()[0][1]

    @property
    def multi_process(self) -> bool:
        return len(np.unique(self.ranks)) > 1

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, axis_names={self.axis_names}, "
                f"devices={[str(d) for d in self.devices.reshape(-1)]})")


def make_mesh(devices=None, shape=None, axis_names=("ty", "tx")) -> Mesh:
    """A 2D (rows x cols) device mesh for screen-tile sharding.

    `devices` defaults to every local CUDA device and may repeat one.
    `shape` defaults to the most-square factorization of the device count
    (favoring more row-bands, which keeps each device's image slice
    contiguous)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    if shape is None:
        rows = 1
        for cand in range(int(math.isqrt(n)), 0, -1):
            if n % cand == 0:
                rows = n // cand
                break
        shape = (rows, n // rows)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axis_names)


# --------------------------------------------------------------------
# Collectives. Every body's result meets the others' here.
# --------------------------------------------------------------------


def _dist():
    import torch.distributed as dist

    return dist


def _stage(x: torch.Tensor):
    """A tensor as the process group's backend takes it: gloo works on
    host memory, NCCL on the card; bools travel as uint8."""
    if _dist().get_backend() == "gloo":
        x = x.cpu()
    return x.to(torch.uint8) if x.dtype == torch.bool else x


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _count_peer(mesh: Mesh, local) -> None:
    """Count what reaches the home cell from the other cells: this
    process's other cells' tensors, and one tensor of `local[0]`'s size
    for each cell of another process."""
    spans.count("mesh.peer_bytes",
                sum(_nbytes(x) for x in local[1:])
                + (mesh.size - len(local)) * _nbytes(local[0]))


def _reduce(mesh: Mesh, values, op: str) -> torch.Tensor:
    home = mesh.home
    _count_peer(mesh, values)
    stacked = torch.stack([v.to(home) for v in values])
    out = {"sum": lambda x: x.sum(0, dtype=x.dtype),
           "max": lambda x: x.amax(0), "min": lambda x: x.amin(0)}[op](stacked)
    if mesh.multi_process:
        dist = _dist()
        staged = _stage(out.detach()).clone()
        dist.all_reduce(staged, op={"sum": dist.ReduceOp.SUM,
                                    "max": dist.ReduceOp.MAX,
                                    "min": dist.ReduceOp.MIN}[op])
        out = staged.to(home, out.dtype)
    return out


def psum(mesh: Mesh, values) -> torch.Tensor:
    """Sum of this process's cells' `values` (one tensor each, any
    device) over the whole mesh, on the home device."""
    return _reduce(mesh, values, "sum")


def pmax(mesh: Mesh, values) -> torch.Tensor:
    return _reduce(mesh, values, "max")


def pmin(mesh: Mesh, values) -> torch.Tensor:
    return _reduce(mesh, values, "min")


def all_gather(mesh: Mesh, local) -> list:
    """Every cell's tensor, row-major over the mesh, on the home device.
    `local` holds this process's cells' tensors in `local_cells()`
    order; all cells' tensors share one shape and dtype. Within one
    process it is differentiable (the moves to the home device are);
    across processes it carries values only, and refuses tensors that
    require grad."""
    home = mesh.home
    _count_peer(mesh, local)
    mine = [x.to(home) for x in local]
    if not mesh.multi_process:
        return mine
    if any(x.requires_grad for x in mine):
        raise ValueError(
            "gradients do not cross processes through all_gather: "
            "differentiate per process and psum the gradients "
            "(parallel.fit_step_sharded)"
        )
    dist = _dist()
    world = dist.get_world_size()
    counts = [int((mesh.ranks == r).sum()) for r in range(world)]
    if len(set(counts)) != 1:
        raise ValueError(f"processes own unequal cell counts {counts}")
    staged = _stage(torch.stack(mine)).contiguous()
    parts = [torch.empty_like(staged) for _ in range(world)]
    dist.all_gather(parts, staged)
    dtype = mine[0].dtype
    per_rank = [iter(p.to(home, dtype)) for p in parts]
    return [next(per_rank[int(mesh.ranks[idx])])
            for idx in np.ndindex(*mesh.shape)]


def broadcast(mesh: Mesh, x) -> list:
    """`x` (a tensor, or a `SceneParams`, on the home device) on each of
    this process's cells' devices, in `local_cells()` order; every copy
    but the home cell's is counted."""
    cells = mesh.local_cells()
    leaves = [x] if isinstance(x, torch.Tensor) else x.leaves()
    spans.count("mesh.peer_bytes",
                (len(cells) - 1) * sum(_nbytes(v) for v in leaves))
    return [x.to(dev) for _, dev in cells]


def tile_blocks(mesh: Mesh, cells) -> torch.Tensor:
    """Row-major 2D image blocks [bh, bw, ...] (an `all_gather` result)
    assembled into [my * bh, mx * bw, ...]."""
    my, mx = mesh.shape
    return torch.cat(
        [torch.cat(cells[r * mx:(r + 1) * mx], dim=1) for r in range(my)],
        dim=0,
    )
