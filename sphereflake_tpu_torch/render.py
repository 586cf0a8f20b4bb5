"""Full-frame G-buffer rendering: camera -> expansion -> binning -> the
fused kernel -> untile, and `render_frame` = G-buffer + post chain.

Counterpart of the reference package's `render.py` (itself the
replacement of the C++ app's worker-thread loop,
`Sphereflake.cpp:86-214`). The output is the C++ app's G-buffer
(`Sphereflake.h:7-11`): a position plane and a normal plane
(camera-relative positions, unit normals, zeros for sky), plus its live
metrics (`Sphereflake.h:30-58`) as 0-d device tensors.

Only `algorithm="binned"` is ported; any other raises
`NotImplementedError`. The frame runs under `torch.no_grad()` and reads
nothing back to the host between entry and return.
"""

from __future__ import annotations

import dataclasses

import torch

from sphereflake_tpu_torch.config import (
    RenderConfig,
    SceneParams,
    resolve_device,
)

_BIG = 3.0e38


@dataclasses.dataclass
class RenderMetrics:
    """The C++ app's title-bar counters (`main.cpp:271-294`), computed
    as reductions. Every field is a 0-d tensor on the frame's device."""

    max_depth_reached: torch.Tensor  # [] int32
    nodes_visited: torch.Tensor  # [] int32 — pair-table slots tested
    overflow: torch.Tensor  # [] int32 — nodes/pairs dropped at capacity
    closest_distance: torch.Tensor  # [] f32 — min hit t (drives SSAO radius)
    rays_traced: torch.Tensor  # [] int32


@dataclasses.dataclass
class GBuffer:
    position: torch.Tensor  # [H, W, 3] camera-relative hit positions (dir * t)
    normal: torch.Tensor  # [H, W, 3] unit normals, zeros at sky
    min_t: torch.Tensor  # [H, W] hit distance, _BIG at sky
    hit: torch.Tensor  # [H, W] bool
    metrics: RenderMetrics


def _tile(img, cfg: RenderConfig):
    """[pH, pW, ...] -> [T, R, ...] row-major over (tile_y, tile_x).
    Operates on the padded image."""
    rest = img.shape[2:]
    x = img.reshape(cfg.tiles_y, cfg.tile_h, cfg.tiles_x, cfg.tile_w, *rest)
    x = torch.movedim(x, 2, 1)
    return x.reshape(cfg.tiles_y * cfg.tiles_x, cfg.tile_h * cfg.tile_w, *rest)


def _untile(tiles, cfg: RenderConfig):
    """[T, R, ...] -> [H, W, ...] inverse of `_tile` (crops padding)."""
    rest = tiles.shape[2:]
    x = tiles.reshape(cfg.tiles_y, cfg.tiles_x, cfg.tile_h, cfg.tile_w, *rest)
    x = torch.movedim(x, 2, 1)
    x = x.reshape(cfg.padded_height, cfg.padded_width, *rest)
    return x[: cfg.height, : cfg.width]


def _untile_rows(out, cfg: RenderConfig) -> list:
    """[T, C, 8, 128] kernel rows -> list of C [H, W] images."""
    T, C = out.shape[0], out.shape[1]
    rays = cfg.tile_h * cfg.tile_w
    return [_untile(out[:, c].reshape(T, rays), cfg) for c in range(C)]


def _algorithm_not_ported(algorithm: str):
    return NotImplementedError(
        f"algorithm={algorithm!r} is not ported to sphereflake_tpu_torch "
        "yet (ROADMAP.md queue 1, M10 'Side paths'); only 'binned' renders"
    )


def grow_capacity(cfg: RenderConfig) -> RenderConfig:
    """Next config in the capacity ladder after an overflow (capacity
    may cost speed, never correctness — the C++ app's recursion visits
    every LOD-passing node, `Sphereflake.h:165-172`).

    Double global_cap until every level-5 parent fits the expansion
    gate cap (ecap = global_cap/9 >= 59049), then cut the band height —
    banding slices the live set per band, which bounds capacity at ANY
    pose."""
    if cfg.algorithm != "binned":
        raise _algorithm_not_ported(cfg.algorithm)
    if cfg.global_cap < (9 << 16):
        return dataclasses.replace(cfg, global_cap=cfg.global_cap * 2)
    rows = cfg.effective_band_rows or cfg.tiles_y
    new_rows = max(1, rows // 4)
    while new_rows > 1 and cfg.tiles_y % new_rows:
        new_rows -= 1
    if (cfg.effective_band_rows or cfg.tiles_y) == new_rows:
        raise RuntimeError(
            "capacity ladder exhausted (1-tile-row bands still overflow)"
        )
    return dataclasses.replace(cfg, band_tile_rows=new_rows)


def _binned_rows(scene: SceneParams, cfg: RenderConfig, frame):
    """Shaded kernel rows [T, 7, 8, 128] (min_t, pos3, nrm3) for cfg's
    full tile grid, plus (depth_reached, nodes_visited, overflow).

    `frame` = (frame_w, frame_h, x_off, y_off): cfg may describe one
    block of a larger frame. When `cfg.effective_band_rows` is set
    (explicitly, or automatically for tile counts that would blow the
    pair budget), the grid renders in horizontal bands, one after the
    other: each band is a further y-offset block of the same frame."""
    from sphereflake_tpu_torch.ops.binned import binned_gbuffer
    from sphereflake_tpu_torch.ops.pallas_traversal import depth_reached_soa

    fw, fh, x0, y0 = frame

    def one(c, y_off):
        (min_t, px, py, pz, nx, ny, nz, _hitf, lo, hi, m, povf) = (
            binned_gbuffer(c, fw, fh, scene, (x0, y_off))
        )
        Tb = c.tiles_y * c.tiles_x
        rows = torch.movedim(
            torch.stack([min_t, px, py, pz, nx, ny, nz], dim=0)
            .reshape(7, Tb, 8, 128),
            0, 1,
        )
        return (
            rows,
            depth_reached_soa(lo, c, hi),
            m[..., 0].sum(dtype=torch.int32),
            m[..., 1].sum(dtype=torch.int32) + povf,
        )

    band_rows = cfg.effective_band_rows
    if band_rows is None:
        rows, depth_r, nodes_n, ovf = one(cfg, y0)
        return rows, (depth_r, nodes_n, ovf)

    band_px = band_rows * cfg.tile_h
    n_bands = cfg.tiles_y // band_rows
    bcfg = dataclasses.replace(
        cfg, height=band_px, band_tile_rows=None, width=cfg.padded_width
    )
    bands = [one(bcfg, y0 + float(b * band_px)) for b in range(n_bands)]
    rows_b, depth_b, nodes_b, ovf_b = zip(*bands)
    return (
        torch.cat(rows_b),
        (
            torch.stack(depth_b).max(),
            torch.stack(nodes_b).sum(dtype=torch.int32),
            torch.stack(ovf_b).sum(dtype=torch.int32),
        ),
    )


def _render_gbuffer_binned(scene: SceneParams, cfg: RenderConfig) -> GBuffer:
    """The fused production pipeline: ONE kernel launch per band
    computes raygen + binned ray tests + G-buffer shading; torch's
    remaining jobs are the node binning and the tile->image untiles."""
    rows, (depth_r, nodes_n, overflow) = _binned_rows(
        scene, cfg, (cfg.width, cfg.height, 0.0, 0.0)
    )
    imgs = _untile_rows(rows, cfg)
    min_t_img = imgs[0]
    metrics = RenderMetrics(
        max_depth_reached=depth_r,
        nodes_visited=nodes_n,
        overflow=overflow,
        closest_distance=torch.min(min_t_img),
        rays_traced=torch.tensor(
            cfg.width * cfg.height, dtype=torch.int32, device=min_t_img.device
        ),
    )
    return GBuffer(
        position=torch.stack(imgs[1:4], dim=-1),
        normal=torch.stack(imgs[4:7], dim=-1),
        min_t=min_t_img,
        hit=min_t_img < _BIG,
        metrics=metrics,
    )


def render_gbuffer(
    scene: SceneParams, cfg: RenderConfig, device="cuda"
) -> GBuffer:
    """Render the full-frame G-buffer for `scene` on `device` (the
    scene's leaves are moved there; asking for "cuda" without one
    raises). Forward only."""
    if cfg.algorithm != "binned":
        raise _algorithm_not_ported(cfg.algorithm)
    scene = scene.to(resolve_device(device))
    with torch.no_grad():
        return _render_gbuffer_binned(scene, cfg)


def render_frame(scene: SceneParams, cfg: RenderConfig, device="cuda"):
    """The complete pipeline of the C++ app's `Render()`
    (`main.cpp:301-335`): trace -> SSAO -> blur x2 -> composite.
    Returns (image [H, W, 3], GBuffer), both on `device`."""
    from sphereflake_tpu_torch.ops.noise import ssao_noise_texture
    from sphereflake_tpu_torch.ops.post import postprocess

    dev = resolve_device(device)
    scene = scene.to(dev)
    gb = render_gbuffer(scene, cfg, device=dev)
    noise = torch.from_numpy(ssao_noise_texture(cfg.noise_size)).to(dev)
    with torch.no_grad():
        image = postprocess(
            gb.position, gb.normal, gb.metrics.closest_distance, scene, cfg,
            noise,
        )
    return image, gb
