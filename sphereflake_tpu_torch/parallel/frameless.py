"""Mesh-sharded frameless accumulation — every mesh cell refines ONE
frameless buffer, as all the C++ app's worker threads share one
G-buffer (`Sphereflake.cpp:67-74`).

Counterpart of the reference package's `parallel/frameless.py`. The
frame's tile grid is cut into per-cell blocks, and each cell refreshes
Sobol-chosen tiles OF ITS OWN BLOCK with its own scramble stream — the
C++ app seeds an independent scrambled Sobol stream per worker thread
the same way (`Sphereflake.cpp:88-90`). Block ownership makes every
write cell-local; the step gathers the refreshed rows and reduces the
scalar metrics (`parallel.mesh`).

The pair table is prepared once per camera and replicated. Each
refreshed tile runs the same kernel invocation a single-device step
would (same global tile id, camera pack, pair segments: K2's
`shade_only` mode), so at full coverage the state equals the
single-device frameless state tile for tile, bit for bit.

The per-cell Sobol cursors are uint32 words held in int64 tensors
[my, mx] (as `ops/sobol.py` holds uint32); the hi word takes the carry
where the lo word wraps at 2^32.
"""

from __future__ import annotations

import dataclasses

import torch

from sphereflake_tpu_torch.config import RenderConfig, SceneParams
from sphereflake_tpu_torch.parallel.mesh import Mesh, all_gather, pmin, psum

_BIG = 3.0e38
_M32 = 0xFFFFFFFF


@dataclasses.dataclass
class ShardedTileState:
    """Frameless G-buffer over a 2D tile-block mesh, on the mesh's home
    device. Fields in the reference's order, so a checkpoint passes
    between the packages (`runtime/checkpoint.py`)."""

    rows: torch.Tensor  # [ty_n, tx_n, 7, 8, 128] (min_t, pos3, nrm3)
    covered: torch.Tensor  # [ty_n, tx_n] bool
    sample_lo: torch.Tensor  # [my, mx] int64 holding uint32: per-cell cursor
    sample_hi: torch.Tensor  # [my, mx] int64 holding uint32
    seed: int  # uint32
    closest_distance: torch.Tensor  # [] f32
    samples_traced: int  # uint32, wraps
    overflow: torch.Tensor  # [] int32


def _block_tiles(cfg: RenderConfig, mesh: Mesh) -> tuple[int, int]:
    my, mx = mesh.shape
    if cfg.tiles_y % my or cfg.tiles_x % mx:
        raise ValueError(
            f"tile grid {cfg.tiles_y}x{cfg.tiles_x} does not divide the "
            f"mesh {my}x{mx} (pad the frame or pick another mesh)"
        )
    return cfg.tiles_y // my, cfg.tiles_x // mx


def sharded_tiles_init(cfg: RenderConfig, mesh: Mesh,
                       seed: int = 0) -> ShardedTileState:
    home = mesh.home
    rows = torch.zeros((cfg.tiles_y, cfg.tiles_x, 7, 8, 128),
                       dtype=torch.float32, device=home)
    rows[:, :, 0] = _BIG
    cursor = lambda: torch.zeros(mesh.shape, dtype=torch.int64, device=home)
    return ShardedTileState(
        rows=rows,
        covered=torch.zeros((cfg.tiles_y, cfg.tiles_x), dtype=torch.bool,
                            device=home),
        sample_lo=cursor(),
        sample_hi=cursor(),
        seed=int(seed) & _M32,
        closest_distance=torch.full((), _BIG, dtype=torch.float32,
                                    device=home),
        samples_traced=0,
        overflow=torch.zeros((), dtype=torch.int32, device=home),
    )


def _cell_tile_ids(state: ShardedTileState, cfg: RenderConfig, mesh: Mesh,
                   iy: int, ix: int, tiles_per_device: int, dev):
    """Cell (iy, ix)'s Sobol-chosen tiles of its own block: global frame
    tile ids [K] int32 on `dev`."""
    from sphereflake_tpu_torch.ops.sobol import sobol_sample
    from sphereflake_tpu_torch.runtime.progressive import _hash_u32

    bty, btx = _block_tiles(cfg, mesh)
    n_local = bty * btx
    lane = torch.arange(tiles_per_device, dtype=torch.int64, device=dev)
    full = lane + state.sample_lo[iy, ix].to(dev)
    idx_lo = full & _M32
    idx_hi = (state.sample_hi[iy, ix].to(dev) + (full >> 32)) & _M32
    # Per-worker scramble stream (the C++ app's per-thread mt19937
    # scramble, made deterministic): the cell's mesh position folded
    # into the seed.
    wid = iy * mesh.shape[1] + ix
    s = sobol_sample(idx_lo, 0, _hash_u32(state.seed ^ (wid + 1)), idx_hi)
    # s can be exactly 1.0 (see `sobol_sample`): clamp.
    local = torch.clamp_max((s * n_local).to(torch.int32), n_local - 1)
    ly = torch.div(local, btx, rounding_mode="floor")
    lx = local - ly * btx
    return (iy * bty + ly) * cfg.tiles_x + (ix * btx + lx)


def sharded_tiles_step(
    state: ShardedTileState,
    scene: SceneParams,
    cfg: RenderConfig,
    mesh: Mesh,
    tiles_per_device: int = 128,
    prepared=None,
) -> ShardedTileState:
    """One frameless step: every cell traces `tiles_per_device`
    Sobol-chosen tiles of its own block through the pair kernel (K2,
    `shade_only`) on its device, and the refreshed rows overwrite theirs
    in the buffer.

    `prepared` is the cached `progressive_prepare[_trimmed]` pair table
    (static camera); without it the frame is re-binned (replicated) each
    step."""
    from sphereflake_tpu_torch.models.sphereflake import (
        child_templates,
        root_frame,
    )
    from sphereflake_tpu_torch.ops.binned import (
        binned_pairs,
        camera_vector,
        trace_pairs_fused_subset,
    )

    home = state.rows.device
    scene = scene.to(home)
    my, mx = mesh.shape
    with torch.no_grad():
        if prepared is not None:
            pairs, starts, lens, pair_ovf = prepared
        else:
            root = root_frame(scene.camera.position)
            templates = child_templates(scene.fractal)
            pairs, starts, lens, (_n, pair_ovf) = binned_pairs(
                scene, cfg, root, templates
            )
        cam = camera_vector(scene, cfg)
        ids, outs, closest, ovf = [], [], [], []
        for (iy, ix), dev in mesh.local_cells():
            gids = _cell_tile_ids(state, cfg, mesh, iy, ix,
                                  tiles_per_device, dev)
            out, m = trace_pairs_fused_subset(
                cam.to(dev), pairs.to(dev), starts.to(dev), lens.to(dev),
                gids, cfg, shade_only=True,
            )
            ids.append(gids)
            outs.append(out)
            closest.append(torch.min(out[:, 0]))
            ovf.append(m[..., 1].sum(dtype=torch.int32))
        # Repeated ids within a cell write IDENTICAL rows (same camera),
        # so the unordered scatter is deterministic by value.
        flat_ids = torch.cat(all_gather(mesh, ids)).long()
        rows = state.rows.clone()
        rows.view(-1, 7, 8, 128)[flat_ids] = torch.cat(all_gather(mesh, outs))
        covered = state.covered.clone()
        covered.view(-1)[flat_ids] = True
        end = state.sample_lo + tiles_per_device
        return ShardedTileState(
            rows=rows,
            covered=covered,
            # hi-word carry at the 2^32 lo wrap (power-of-two step sizes
            # land the cursor exactly on the boundary, where a dropped
            # carry would restart the Sobol stream).
            sample_lo=end & _M32,
            sample_hi=(state.sample_hi + (end >> 32)) & _M32,
            seed=state.seed,
            closest_distance=torch.minimum(state.closest_distance,
                                           pmin(mesh, closest)),
            samples_traced=(state.samples_traced
                            + my * mx * tiles_per_device * 1024) & _M32,
            overflow=state.overflow + pair_ovf + psum(mesh, ovf),
        )


def sharded_tiles_as_single(state: ShardedTileState):
    """The sharded state as a single-device `TileProgressiveState` (rows
    re-flattened to [T, 7, 8, 128], cell (0, 0)'s cursor), so the display
    reads — `tile_progressive_gbuffer` / `..._composite` — are shared
    with the single-device mode."""
    from sphereflake_tpu_torch.runtime.progressive import TileProgressiveState

    ty_n, tx_n = state.covered.shape
    return TileProgressiveState(
        rows=state.rows.reshape(ty_n * tx_n, 7, 8, 128),
        covered=state.covered.reshape(ty_n * tx_n),
        sample_lo=int(state.sample_lo[0, 0]),
        sample_hi=int(state.sample_hi[0, 0]),
        seed=state.seed,
        closest_distance=state.closest_distance,
        samples_traced=state.samples_traced,
        overflow=state.overflow,
    )
