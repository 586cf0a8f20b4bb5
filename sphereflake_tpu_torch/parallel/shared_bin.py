"""Shared-bin sharded rendering: bin the frame once, shard the heavy
stages — the strong-scaling path for single frames.

Counterpart of the reference package's `parallel/shared_bin.py`. The
per-block path (`parallel/sharded.py`) has every cell re-expand and
re-bin its own block; here the cells share one bin, as the C++ app's
threads share one scene (`Sphereflake.cpp:69`):

- **Replicated** (once, on the mesh's home device): the tree expansion
  and the per-node pair-slot geometry (`ops.binned.frame_nodes`,
  `bin_geometry`), then — after the windows are gathered — the one sort
  of the packed (tile << node_bits | node) keys and the tile-segment
  searchsorted.
- **Sharded by pair-slot window**: each cell decodes the (tile, node)
  pairs of its `pair_cap / D` slots (`_decode_tiles_window`; the decode
  is a search of the per-node slot offsets, so windows compose exactly
  into the full decode) and gathers the fat rows of its window of the
  sorted table.
- **Sharded by tile block**: each cell renders its own 2D block of tiles
  through the pair kernel's subset mode (K2, coded rows) over the
  block's tile ids.

Every stage is either the single-device stage itself or an exact
decomposition of it, and K2's coded rows of a tile equal K1's, so the
frame equals `render.render_gbuffer`'s bit for bit.

Differentiable through `ops.binned.BinnedGBuffer`, subclassed with this
module's forward (`_shared_primal`, the same outputs as the
single-device `_gbuffer_primal`); the backward is the single-device
recompute of the full frame from the saved path codes (replicated; the
sharded backward is `fit_step_sharded`'s).
"""

from __future__ import annotations

import torch

from sphereflake_tpu_torch.config import RenderConfig, SceneParams
from sphereflake_tpu_torch.ops.binned import BinnedGBuffer, _owned
from sphereflake_tpu_torch.parallel.mesh import Mesh, all_gather

_BIG = 3.0e38


def shared_bin_supported(cfg: RenderConfig, mesh: Mesh) -> bool:
    """The shared-bin path needs: the binned algorithm, no banding
    (large frames amortize the bin anyway), a tile grid divisible by the
    mesh, a pair_cap divisible by the cell count, and the packed sort key
    within 31 bits."""
    my, mx = mesh.shape
    d = my * mx
    if cfg.algorithm != "binned" or cfg.effective_band_rows is not None:
        return False
    if cfg.tiles_y % my or cfg.tiles_x % mx or cfg.pair_cap % d:
        return False
    n_tiles = cfg.tiles_x * cfg.tiles_y
    # node-count bound of the packed sort key (levels concatenated)
    n_nodes_max = 0
    width = 1
    for _ in range(cfg.max_depth + 1):
        n_nodes_max += min(width, cfg.global_cap)
        width *= 9
    node_bits = max(1, (n_nodes_max - 1).bit_length())
    tile_bits = (n_tiles + 1).bit_length()
    return node_bits + tile_bits <= 31


def _block_tile_ids(cfg: RenderConfig, my: int, mx: int, iy: int, ix: int,
                    device) -> torch.Tensor:
    """Global frame tile ids of cell (iy, ix)'s block, row-major, int32."""
    bty, btx = cfg.tiles_y // my, cfg.tiles_x // mx
    ly = torch.arange(bty, dtype=torch.int32, device=device)[:, None]
    lx = torch.arange(btx, dtype=torch.int32, device=device)[None, :]
    return ((iy * bty + ly) * cfg.tiles_x + (ix * btx + lx)).reshape(-1)


def _on(x, dev):
    return x.to(dev) if isinstance(x, torch.Tensor) else x


def _shared_primal(mesh: Mesh, cfg: RenderConfig, frame_w, frame_h,
                   scene: SceneParams, offs):
    """The full frame's forward with one shared bin: the outputs of
    `ops.binned._gbuffer_primal` (flat [T*1024] planes in tile order,
    metrics [T, 1, 4], pair/compaction overflow), on the home device."""
    from sphereflake_tpu_torch.models.sphereflake import (
        child_templates,
        root_frame,
    )
    from sphereflake_tpu_torch.ops.binned import (
        _decode_tiles_window,
        bin_geometry,
        camera_vector,
        frame_nodes,
        node_rows,
        trace_pairs_fused_subset,
    )

    home = mesh.home
    my, mx = mesh.shape
    cap_d = cfg.pair_cap // (my * mx)
    n_tiles = cfg.tiles_x * cfg.tiles_y
    frame = (frame_w, frame_h, offs[0], offs[1])
    cells = mesh.local_cells()

    # ---- replicated: expansion + per-node geometry
    root = root_frame(scene.camera.position)
    templates = child_templates(scene.fractal)
    nodes, exp_ovf, minv, corners = frame_nodes(
        scene, cfg, root, templates, frame
    )
    geo = bin_geometry(nodes, minv, cfg, frame=frame, corners=corners)
    node_bits = max(1, (geo["n_nodes"] - 1).bit_length())

    # ---- sharded decode: each cell its slot window
    keys = []
    for (iy, ix), dev in cells:
        geo_d = {k: _on(v, dev) for k, v in geo.items()}
        tile_w, node_w = _decode_tiles_window(
            geo_d, cfg, (iy * mx + ix) * cap_d, cap_d
        )
        keys.append((tile_w.to(torch.int64) << node_bits) | node_w)

    # ---- replicated: one sort of the packed keys + tile segments (the
    # sort needs no stability: equal keys carry equal values)
    packed = torch.sort(torch.cat(all_gather(mesh, keys))).values
    tile_sorted = packed >> node_bits
    bounds = torch.searchsorted(
        tile_sorted, torch.arange(n_tiles + 1, dtype=torch.int64, device=home)
    )
    starts = bounds[:-1].to(torch.int32).contiguous()
    lens = (bounds[1:] - bounds[:-1]).to(torch.int32).contiguous()

    # ---- sharded: the fat-rows gather of each cell's sorted window;
    # dead slots (tile == n_tiles) get rc = -BIG, as in `bin_nodes`
    rows = node_rows(nodes, cfg)
    windows = []
    for (iy, ix), dev in cells:
        lo = (iy * mx + ix) * cap_d
        key_w = packed[lo:lo + cap_d].to(dev)
        pairs_w = rows.to(dev)[:, (key_w & ((1 << node_bits) - 1))]
        dead = (key_w >> node_bits) >= n_tiles
        pairs_w[3] = torch.where(dead, torch.full_like(pairs_w[3], -_BIG),
                                 pairs_w[3])
        windows.append(pairs_w)
    pairs = torch.cat(all_gather(mesh, windows), dim=1)

    # ---- sharded: the pair kernel (K2, coded rows) on each cell's block
    cam = camera_vector(scene, cfg, frame=frame)
    outs, metrics, ids = [], [], []
    for (iy, ix), dev in cells:
        gids = _block_tile_ids(cfg, my, mx, iy, ix, dev)
        out, m = trace_pairs_fused_subset(
            cam.to(dev), pairs.to(dev), starts.to(dev), lens.to(dev), gids,
            cfg,
        )
        outs.append(out)
        metrics.append(m)
        ids.append(gids)
    order = torch.cat(all_gather(mesh, ids)).long()
    out = torch.empty((n_tiles,) + tuple(outs[0].shape[1:]),
                      dtype=torch.float32, device=home)
    out[order] = torch.cat(all_gather(mesh, outs))
    m = torch.empty((n_tiles, 1, 4), dtype=torch.int32, device=home)
    m[order] = torch.cat(all_gather(mesh, metrics))

    deep = cfg.max_depth >= 7
    flat = lambda r: out[:, r].reshape(-1)
    lo_c = flat(1)
    hi_c = flat(2) if deep else torch.zeros_like(lo_c)
    hit = ((lo_c >= 1.0) | (hi_c >= 1.0)).to(torch.float32)
    return (flat(0), flat(-6), flat(-5), flat(-4), flat(-3), flat(-2),
            flat(-1), hit, lo_c, hi_c, m, geo["pair_overflow"] + exp_ovf)


class _SharedGBuffer(BinnedGBuffer):
    """`ops.binned.BinnedGBuffer` with the shared bin's forward
    (`_shared_primal`; statics (cfg, frame_w, frame_h, mesh)): its
    backward and jvp are the single-device recompute."""

    @staticmethod
    def forward(statics, offs, *leaves):
        cfg, frame_w, frame_h, mesh = statics
        return _owned(_shared_primal(
            mesh, cfg, frame_w, frame_h, SceneParams.from_leaves(leaves), offs
        ))


def render_gbuffer_shared(scene: SceneParams, cfg: RenderConfig, mesh: Mesh):
    """Full-frame G-buffer through the shared bin (module docstring), on
    the mesh's home device; equal to `render.render_gbuffer` bit for
    bit. Returns a `render.GBuffer`."""
    from sphereflake_tpu_torch.render import (
        _band_rows,
        _binned_gbuffer,
        _grad_mode,
    )

    if not shared_bin_supported(cfg, mesh):
        raise ValueError(
            f"the shared bin does not take this frame on a {mesh.shape} "
            "mesh (shared_bin_supported)"
        )
    scene = scene.to(mesh.home)
    with _grad_mode(scene):
        outs = _SharedGBuffer.apply(
            (cfg, cfg.width, cfg.height, mesh), (0.0, 0.0), *scene.leaves()
        )
        return _binned_gbuffer(cfg, *_band_rows(cfg, outs))
