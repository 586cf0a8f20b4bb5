"""Full-frame G-buffer rendering and `render_frame` = G-buffer + post
chain, by `cfg.algorithm`:

- "binned" (production): camera -> global expansion -> binning -> the
  fused raygen + trace + shade kernel -> untile;
- "pallas": raygen -> per-tile frustum planes -> the per-tile traversal
  kernel (`ops/pallas_traversal.py`) -> path-code resolve -> shade ->
  untile (`_render_gbuffer_soa`);
- "fast", "strict", "loose": the same tiles through a plain-op
  traversal (`ops/traversal.tile_tracer`: the cone-culled
  `trace_tile_fast`, or the parity traversal `trace_tile`, gated per ray
  when `cfg.strict_lod`), `cfg.tile_batch` tiles at a time.

Counterpart of the reference package's `render.py` (itself the
replacement of the C++ app's worker-thread loop,
`Sphereflake.cpp:86-214`). The output is the C++ app's G-buffer
(`Sphereflake.h:7-11`): a position plane and a normal plane
(camera-relative positions, unit normals, zeros for sky), plus its live
metrics (`Sphereflake.h:30-58`) as 0-d device tensors.

Differentiable on every path: when a scene leaf requires grad (and
grad mode is on) the frame builds its graph — through
`ops.binned.BinnedGBuffer` on the binned path, through the path-code
resolve after the detached traversal kernel on the pallas path, through
plain ops on the fast, strict and loose paths; otherwise it runs under
`torch.no_grad()`.
On the card it reads nothing back to the host between entry and return.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from sphereflake_tpu_torch import spans
from sphereflake_tpu_torch.camera import (
    corner_rays,
    pixel_grid,
    ray_directions,
    tile_frustum_planes,
)
from sphereflake_tpu_torch.config import (
    RenderConfig,
    SceneParams,
    resolve_device,
)
from sphereflake_tpu_torch.models.sphereflake import (
    child_templates,
    root_frame,
)
from sphereflake_tpu_torch.ops.traversal import (
    TraceResult,
    shade_gbuffer,
    tile_tracer,
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


def grow_capacity(cfg: RenderConfig) -> RenderConfig:
    """Next config in the capacity ladder after an overflow (capacity
    may cost speed, never correctness — the C++ app's recursion visits
    every LOD-passing node, `Sphereflake.h:165-172`).

    Binned path: double global_cap until every level-5 parent fits the
    expansion gate cap (ecap = global_cap/9 >= 59049), then cut the band
    height — banding cuts the live set per band, which bounds capacity
    at ANY pose (the fronts made at once stay within
    `ops.binned.FRONT_SLOTS`, however many bands). Per-tile paths: double max_frontier (the traversal
    kernel's scratch in device memory grows with it)."""
    if cfg.algorithm != "binned":
        return dataclasses.replace(cfg, max_frontier=cfg.max_frontier * 2)
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


def band_layout(cfg: RenderConfig, frame):
    """(band config, y offsets) of cfg's full tile grid at `frame` =
    (frame_w, frame_h, x_off, y_off).

    cfg may describe one block of a larger frame. When
    `cfg.effective_band_rows` is set (explicitly, or automatically for
    tile counts that would blow the pair budget), the grid renders in
    horizontal bands: each band is a further y-offset block of the same
    frame. Otherwise the one band is the whole grid, with cfg itself."""
    y0 = frame[3]
    band_rows = cfg.effective_band_rows
    if band_rows is None:
        return cfg, [y0]
    band_px = band_rows * cfg.tile_h
    bcfg = dataclasses.replace(
        cfg, height=band_px, band_tile_rows=None, width=cfg.padded_width
    )
    return bcfg, [y0 + float(b * band_px)
                  for b in range(cfg.tiles_y // band_rows)]


def _band_rows(c: RenderConfig, outs):
    """Shaded kernel rows [T, 7, 8, 128] (min_t, pos3, nrm3) of one
    block's `binned_gbuffer` outputs, plus (depth_reached,
    nodes_visited, overflow)."""
    from sphereflake_tpu_torch.ops.pallas_traversal import depth_reached_soa

    (min_t, px, py, pz, nx, ny, nz, _hitf, lo, hi, m, povf) = outs
    Tb = c.tiles_y * c.tiles_x
    with spans.span("gbuffer.untile"):
        rows = torch.movedim(
            torch.stack([min_t, px, py, pz, nx, ny, nz], dim=0)
            .reshape(7, Tb, 8, 128),
            0, 1,
        )
        return rows, (
            depth_reached_soa(lo, c, hi),
            m[..., 0].sum(dtype=torch.int32),
            m[..., 1].sum(dtype=torch.int32) + povf,
        )


def _binned_rows(scene: SceneParams, cfg: RenderConfig, frame):
    """`_band_rows` for cfg's full tile grid at `frame` = (frame_w,
    frame_h, x_off, y_off): the bands of `band_layout`, concatenated.
    Their fronts come a run of bands at a time (`ops.binned.front_groups`,
    one `band_fronts` call a run), and each band's front is let go once
    its kernel is queued."""
    from sphereflake_tpu_torch.ops.binned import (
        band_fronts,
        binned_gbuffer,
        front_groups,
    )

    fw, fh, x0, _y0 = frame
    bcfg, offsets = band_layout(cfg, frame)
    bands = []
    for run in front_groups(bcfg, offsets):
        fronts = band_fronts(scene, bcfg, fw, fh, x0, run)
        for y_off in run:
            bands.append(_band_rows(bcfg, binned_gbuffer(
                bcfg, fw, fh, scene, (x0, y_off), fronts.pop(0))))
    if cfg.effective_band_rows is None:
        return bands[0]
    rows_b, metrics_b = zip(*bands)
    depth_b, nodes_b, ovf_b = zip(*metrics_b)
    with spans.span("gbuffer.untile"):
        return (
            torch.cat(rows_b),
            (
                torch.stack(depth_b).max(),
                torch.stack(nodes_b).sum(dtype=torch.int32),
                torch.stack(ovf_b).sum(dtype=torch.int32),
            ),
        )


def _binned_gbuffer(cfg: RenderConfig, rows, metrics) -> GBuffer:
    """The fused production pipeline's `GBuffer` from its kernel rows
    and (depth_reached, nodes_visited, overflow) (`_binned_rows`): ONE
    kernel call per band computes raygen + binned ray tests + G-buffer
    shading; torch's remaining jobs are the node binning and the
    tile->image untiles."""
    depth_r, nodes_n, overflow = metrics
    with spans.span("gbuffer.untile"):
        imgs = _untile_rows(rows, cfg)
        position = torch.stack(imgs[1:4], dim=-1)
        normal = torch.stack(imgs[4:7], dim=-1)
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
        position=position,
        normal=normal,
        min_t=min_t_img,
        hit=min_t_img < _BIG,
        metrics=metrics,
    )


def trace_tiles(
    tiles,  # [T, R, 3] unit ray dirs
    tile_planes,  # [T, 4, 3] frustum planes (pallas path only)
    scene: SceneParams,
    cfg: RenderConfig,
) -> TraceResult:
    """Trace a batch of ray tiles — the unified dispatch over the
    per-tile traversal implementations (`cfg.algorithm`), batched over
    tiles. Differentiable on the pallas path through the path-code
    recompute (`ops/pallas_traversal.resolve_codes`)."""
    root = root_frame(scene.camera.position)
    templates = child_templates(scene.fractal)

    assert cfg.algorithm != "binned", (
        "the binned path renders whole blocks (raygen is fused into "
        "the kernel) — use render_gbuffer"
    )
    if cfg.algorithm == "pallas":
        from sphereflake_tpu_torch.ops.pallas_traversal import (
            resolve_codes,
            trace_tiles_pallas,
        )

        _, code, m = trace_tiles_pallas(
            tiles, tile_planes, root, templates, scene.fractal, cfg
        )
        min_t, center, hit = resolve_codes(
            tiles, code, root, templates, scene.fractal, cfg
        )
        return TraceResult(
            min_t=min_t,
            center=center,
            hit=hit,
            max_depth_reached=torch.max(m[:, 0, 2]),
            nodes_visited=m[:, 0, 0].sum(dtype=torch.int32),
            overflow=m[:, 0, 1].sum(dtype=torch.int32),
        )

    tracer = tile_tracer(cfg)
    batch = max(1, cfg.tile_batch)
    parts = [
        tracer(tiles[s:s + batch], root, templates, scene.fractal, cfg)
        for s in range(0, tiles.shape[0], batch)
    ]
    cat = lambda name: torch.cat([getattr(p, name) for p in parts])
    return TraceResult(
        min_t=cat("min_t"),
        center=cat("center"),
        hit=cat("hit"),
        max_depth_reached=torch.max(cat("max_depth_reached")),
        nodes_visited=cat("nodes_visited").sum(dtype=torch.int32),
        overflow=cat("overflow").sum(dtype=torch.int32),
    )


def _frame_metrics(cfg: RenderConfig, depth_r, nodes_n, overflow, min_t_img,
                   hit_img) -> RenderMetrics:
    big = torch.full_like(min_t_img, _BIG)
    return RenderMetrics(
        max_depth_reached=depth_r,
        nodes_visited=nodes_n,
        overflow=overflow,
        closest_distance=torch.min(torch.where(hit_img, min_t_img, big)),
        rays_traced=torch.tensor(
            cfg.width * cfg.height, dtype=torch.int32, device=min_t_img.device
        ),
    )


def _soa_raygen(scene: SceneParams, cfg: RenderConfig) -> list:
    """Unit ray direction components (dx, dy, dz), each [T, 1024] in
    tile order, of cfg's padded frame. Same association order as
    `camera.ray_directions` ((tl + (ex*u + ey*v)) - origin), so the two
    direction computations agree to the last ulp; the divisors are
    tensors (a true division on every device)."""
    origin, tl, tr, bl = corner_rays(scene.camera, cfg.width / cfg.height)
    dev = origin.device
    ex, ey = tr - tl, bl - tl
    u = torch.arange(
        cfg.padded_width, dtype=torch.float32, device=dev
    )[None, :] / origin.new_tensor(float(cfg.width))
    v = torch.arange(
        cfg.padded_height, dtype=torch.float32, device=dev
    )[:, None] / origin.new_tensor(float(cfg.height))
    comps = [(tl[a] + (ex[a] * u + ey[a] * v)) - origin[a] for a in range(3)]
    # Matches `transforms.normalize` (exact math, eps 0).
    dnorm = torch.sqrt(comps[0] ** 2 + comps[1] ** 2 + comps[2] ** 2)
    return [_tile(c / dnorm, cfg) for c in comps]


def _soa_shade(dx, dy, dz, min_t, cx, cy, cz, hit):
    """G-buffer shading on flat component tensors (same math as
    `ops.traversal.shade_gbuffer`): (px, py, pz, nx, ny, nz), zeros at
    sky."""
    from sphereflake_tpu_torch.ops.intersect import safe_sqrt

    zero = torch.zeros_like(min_t)
    t0 = torch.where(hit, min_t, zero)
    px, py, pz = dx * t0, dy * t0, dz * t0
    wx, wy, wz = px - cx, py - cy, pz - cz
    nn = safe_sqrt(wx * wx + wy * wy + wz * wz)
    nn = torch.where(nn > 0, nn, torch.ones_like(nn))
    return (
        torch.where(hit, px, zero),
        torch.where(hit, py, zero),
        torch.where(hit, pz, zero),
        torch.where(hit, wx / nn, zero),
        torch.where(hit, wy / nn, zero),
        torch.where(hit, wz / nn, zero),
    )


def _render_gbuffer_soa(scene: SceneParams, cfg: RenderConfig) -> GBuffer:
    """SoA pipeline for the per-tile traversal kernel: every
    intermediate is a [T, 1024]- or [N]-shaped component tensor, which
    is the kernel's own layout ([T, 3, 8, 128] in, [T, 2, 8, 128] out);
    the [H, W, 3] G-buffer planes materialize exactly once, at the end."""
    from sphereflake_tpu_torch.ops.pallas_traversal import (
        resolve_codes_soa,
        trace_tiles_pallas_soa,
    )

    T = cfg.tiles_y * cfg.tiles_x
    rays = cfg.tile_h * cfg.tile_w
    tiled = _soa_raygen(scene, cfg)  # [T, R] each
    dirs_k = torch.stack([t.reshape(T, 8, 128) for t in tiled], dim=1)

    root = root_frame(scene.camera.position)
    templates = child_templates(scene.fractal)
    planes = tile_frustum_planes(
        scene.camera, cfg.width, cfg.height, cfg.tile_h, cfg.tile_w,
        block_h=cfg.padded_height, block_w=cfg.padded_width,
    )
    out, m = trace_tiles_pallas_soa(
        dirs_k, planes.contiguous(), root, templates, scene.fractal, cfg
    )
    code = out[:, 1].reshape(-1)
    dx, dy, dz = (t.reshape(-1) for t in tiled)
    min_t, cx, cy, cz, hit = resolve_codes_soa(
        dx, dy, dz, code, root, templates, scene.fractal, cfg
    )
    shaded = _soa_shade(dx, dy, dz, min_t, cx, cy, cz, hit)

    def img(flat):
        return _untile(flat.reshape(T, rays), cfg)

    min_t_img = img(min_t)
    hit_img = img(hit)
    return GBuffer(
        position=torch.stack([img(c) for c in shaded[:3]], dim=-1),
        normal=torch.stack([img(c) for c in shaded[3:]], dim=-1),
        min_t=min_t_img,
        hit=hit_img,
        metrics=_frame_metrics(
            cfg, torch.max(m[:, 0, 2]), m[:, 0, 0].sum(dtype=torch.int32),
            m[:, 0, 1].sum(dtype=torch.int32), min_t_img, hit_img,
        ),
    )


def _render_gbuffer_tiles(scene: SceneParams, cfg: RenderConfig) -> GBuffer:
    """The generic per-tile pipeline (`trace_tiles` + `shade_gbuffer`)."""
    # Ray math uses the ORIGINAL width/height for the NDC mapping; the
    # grid extends to the padded dims (extra rows/cols extrapolate the
    # corner interpolation and are cropped by `_untile`).
    xs, ys = pixel_grid(
        cfg.padded_width, cfg.padded_height, device=scene.device
    )
    dirs = ray_directions(scene.camera, xs, ys, cfg.width, cfg.height)
    tiles = _tile(dirs, cfg)  # [T, R, 3]
    planes = tile_frustum_planes(
        scene.camera, cfg.width, cfg.height, cfg.tile_h, cfg.tile_w,
        block_h=cfg.padded_height, block_w=cfg.padded_width,
    )
    res = trace_tiles(tiles, planes, scene, cfg)
    position_t, normal_t = shade_gbuffer(tiles, res)
    min_t = _untile(res.min_t, cfg)
    hit = _untile(res.hit, cfg)
    return GBuffer(
        position=_untile(position_t, cfg),
        normal=_untile(normal_t, cfg),
        min_t=min_t,
        hit=hit,
        metrics=_frame_metrics(
            cfg, res.max_depth_reached, res.nodes_visited, res.overflow,
            min_t, hit,
        ),
    )


def _grad_mode(scene: SceneParams):
    """The frame's autograd context: record the graph when grad mode is
    on and some leaf requires grad, else `torch.no_grad()` (forward-mode
    tangents pass either way)."""
    if torch.is_grad_enabled() and any(
        leaf.requires_grad for leaf in scene.leaves()
    ):
        return contextlib.nullcontext()
    return torch.no_grad()


def render_gbuffer(
    scene: SceneParams, cfg: RenderConfig, device="cuda"
) -> GBuffer:
    """Render the full-frame G-buffer for `scene` on `device` (the
    scene's leaves are moved there; asking for "cuda" without one
    raises). Position, normal and min_t are differentiable in the
    scene's leaves."""
    with spans.span("gbuffer"):
        scene = scene.to(resolve_device(device))
        with _grad_mode(scene):
            if cfg.algorithm == "binned":
                return _binned_gbuffer(cfg, *_binned_rows(
                    scene, cfg, (cfg.width, cfg.height, 0.0, 0.0)
                ))
            if cfg.algorithm == "pallas":
                return _render_gbuffer_soa(scene, cfg)
            return _render_gbuffer_tiles(scene, cfg)


def render_frame(scene: SceneParams, cfg: RenderConfig, device="cuda"):
    """The complete pipeline of the C++ app's `Render()`
    (`main.cpp:301-335`): trace -> SSAO -> blur x2 -> composite.
    Returns (image [H, W, 3], GBuffer), both on `device`; the image is
    differentiable in every leaf, the SSAO uniforms included (the radius
    law's radius only places nearest-texel taps, so — as in the
    reference — it adds no gradient)."""
    from sphereflake_tpu_torch.ops.noise import ssao_noise_texture
    from sphereflake_tpu_torch.ops.post import postprocess

    dev = resolve_device(device)
    scene = scene.to(dev)
    gb = render_gbuffer(scene, cfg, device=dev)
    noise = torch.from_numpy(ssao_noise_texture(cfg.noise_size)).to(dev)
    with _grad_mode(scene):
        image = postprocess(
            gb.position, gb.normal, gb.metrics.closest_distance, scene, cfg,
            noise,
        )
    return image, gb
