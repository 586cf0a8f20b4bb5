"""Levelwise frontier traversal of the sphereflake (plain torch): the
parity traversal `trace_tile` ("strict" / "loose"), the cone-culled
`trace_tile_fast` ("fast"), their dispatch (`tile_tracer`,
`trace_rays`), and `TraceResult` / `shade_gbuffer`.

Counterpart of the reference package's `ops/traversal.py`. The C++ app
traverses the 9-ary fractal by per-packet recursive DFS
(`Sphereflake.h:86-226`); here a whole level is one batched operation:
every sphere of level L has the radius root_radius * ratio^L, a tile's
rays test a frontier of N spheres as one [rays, N] elementwise chain,
and the frontier is expanded by one batched 3x4 compose against the 9
template frames and compacted to a static capacity.

- `trace_tile` expands a node iff some ray of the tile wants to recurse
  into it (bounding-sphere hit + LOD cut, `Sphereflake.h:140-153`);
  with `cfg.strict_lod` each ray also carries its own reachability
  mask down the tree — the packet-width-1 limit of the C++ app, the
  semantics of the golden model (`models/golden.py`). Without it the
  gate is per node (`--loose-lod`).
- `trace_tile_fast` decides expansion by the tile's bounding cone and
  gates per node; the per-tile traversal kernel
  (`ops/pallas_traversal.py`) has its semantics with frustum planes in
  place of the cone.

Both are batched over tiles ([B, R, 3] rays) and differentiable: the
winner of a level is a masked argmin whose gathered centre carries the
gradient; the visit masks are discrete.
"""

from __future__ import annotations

import dataclasses

import torch

from sphereflake_tpu_torch.config import FractalParams, RenderConfig
from sphereflake_tpu_torch.ops.intersect import ray_sphere, safe_sqrt
from sphereflake_tpu_torch.ops.transforms import rt_multiply

_BIG = 3.0e38  # ~FLT_MAX: the C++ app's miss sentinel


@dataclasses.dataclass
class TraceResult:
    """Per-ray hit state — the G-buffer precursor plus live metrics
    (the C++ app's counters, `Sphereflake.h:30-58`)."""

    min_t: torch.Tensor  # [...]: hit distance, _BIG where sky
    center: torch.Tensor  # [..., 3] center of the winning sphere
    hit: torch.Tensor  # [...] bool
    max_depth_reached: torch.Tensor  # [] int32 (`Sphereflake.h:157-160`)
    nodes_visited: torch.Tensor  # [] int32: pair / frontier slots tested
    overflow: torch.Tensor  # [] int32: nodes dropped at capacity


def shade_gbuffer(dirs, res: TraceResult):
    """Turn a TraceResult into (position, normal) G-buffer planes —
    camera-relative position = dir * t, normal = normalize(pos - center),
    zeros for sky (`Sphereflake.cpp:186-201`)."""
    hit = res.hit[..., None]
    t = torch.where(res.hit, res.min_t, torch.zeros_like(res.min_t))
    position = dirs * t[..., None]
    delta = position - res.center
    norm = safe_sqrt(torch.sum(delta * delta, dim=-1, keepdim=True))
    normal = torch.where(
        hit,
        delta / torch.where(norm > 0, norm, torch.ones_like(norm)),
        torch.zeros_like(delta),
    )
    position = torch.where(hit, position, torch.zeros_like(position))
    return position, normal


# Frontier nodes tested per vectorised step of `trace_tile_fast`: bounds
# the live [tiles, rays, nodes] working set.
_NODE_CHUNK = 64


def _dot3(v, axis):
    """v [B, N, 3] . axis [B, 3] -> [B, N], elementwise (full f32)."""
    return (
        v[..., 0] * axis[:, None, 0]
        + v[..., 1] * axis[:, None, 1]
        + v[..., 2] * axis[:, None, 2]
    )


def tile_cone(dirs):
    """Bounding cone of ray tiles `dirs` [B, R, 3]: (axis [B, 3],
    cos_half_angle [B]); for one tile [R, 3]: ([3], []).

    The replacement for the C++ app's per-packet movemask early-out
    (`Sphereflake.h:140-144`): a sphere that misses the tile's cone
    misses every ray in the tile, so it can be culled once per tile
    instead of once per ray. Exactly conservative for unit rays from a
    common origin."""
    if dirs.dim() == 2:
        axis, cos_theta = tile_cone(dirs[None])
        return axis[0], cos_theta[0]
    axis = torch.sum(dirs, dim=1)
    axis = axis / torch.sqrt(
        torch.clamp_min(torch.sum(axis * axis, dim=-1, keepdim=True), 1e-20)
    )
    return axis, torch.amin(_dot3(dirs, axis), dim=1)


def _cone_cull(centers, radius, axis, cos_theta, lod_sq):
    """[B, N] keep-mask: cone-vs-sphere(2r) overlap AND conservative
    LOD, for centers [B, N, 3], axis [B, 3], cos_theta [B].

    keep iff angle(axis, c) <= theta + asin(min(2r/|c|, 1)) (or origin
    inside the bounding sphere), and the closest possible bounding hit
    |c| - 2r still passes the LOD cut t < lod^2 * r."""
    cos_theta = cos_theta[:, None]
    cc = torch.sum(centers * centers, dim=-1)
    dist = torch.sqrt(torch.clamp_min(cc, 1e-20))
    sin_phi = torch.clamp_max(2.0 * radius / dist, 1.0)
    cos_phi = torch.sqrt(torch.clamp_min(1.0 - sin_phi * sin_phi, 0.0))
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    # cos(theta + phi) = cos t cos p - sin t sin p
    cos_sum = cos_theta * cos_phi - sin_theta * sin_phi
    cos_beta = _dot3(centers, axis) / dist
    inside = dist <= 2.0 * radius
    hit = inside | (cos_beta >= cos_sum)
    lod_ok = (dist - 2.0 * radius) < lod_sq * radius
    return hit & lod_ok


def _compact(mask, cap: int):
    """Pack the indices where mask [B, N] is true into [B, cap] slots,
    in order (cumsum + scatter). Returns (indices [B, cap] int64, valid
    [B, cap], dropped [B] int32); unfilled slots hold index 0."""
    B, n = mask.shape
    dev = mask.device
    pos = torch.cumsum(mask, dim=1) - 1
    total = mask.sum(dim=1)
    # Ranks past the cap fall into a dump slot that is cut off again.
    slot = torch.where(mask & (pos < cap), pos, torch.full_like(pos, cap))
    idx = torch.zeros((B, cap + 1), dtype=torch.int64, device=dev)
    idx.scatter_(1, slot, torch.arange(n, device=dev).expand(B, n))
    valid = torch.arange(cap, device=dev)[None, :] < total[:, None]
    dropped = torch.clamp_min(total - cap, 0).to(torch.int32)
    return idx[:, :cap], valid, dropped


def _level_frontier_sizes(cfg: RenderConfig) -> list[int]:
    """Static frontier capacity per level: 9^L capped at max_frontier
    (rounded to a multiple of 9 past the cap)."""
    cap = max(9, (cfg.max_frontier // 9) * 9)
    return [min(9**level, cap) for level in range(cfg.max_depth + 1)]


# Elements of one [tiles, rays, nodes] float temporary of `trace_tile`
# (256 MiB): its ray tests walk the frontier in node chunks of at most
# this size. Every chunk costs some 50 launches; at 1080p depth 6 (16
# tiles of 768 rays, 4,095 slots a level) a level is one chunk.
_STRICT_CHUNK_ELEMS = 1 << 26


def trace_tile(dirs, root, templates, fractal: FractalParams,
               cfg: RenderConfig) -> TraceResult:
    """The parity traversal, batched over tiles: dirs [B, R, 3] unit ray
    directions (origin 0, camera-relative space), or [R, 3] for one
    tile; root [3, 4]; templates [9, 3, 4]. Per-tile fields of the
    result carry the batch dimension (min_t [B, R], center [B, R, 3],
    the three metrics [B]); one tile gives the reference's shapes.

    Per level: cont[b, r, n] = the ray reaches node n (its own gate with
    `cfg.strict_lod`, else every valid node), hits its bounding sphere
    (2r) and passes the LOD cut; the self test (r) of the nodes in cont
    gives the level's winner, the first minimum of one masked argmin
    over the frontier, which replaces the running best on strict `<`.
    A node is expanded iff some ray of its tile has it in cont; past
    the level's capacity the wanted nodes are packed in order into the
    first `n_next // 9` parent slots and the rest counted as overflow.

    The float temporaries are cut into node chunks (first minimum of a
    chunk against the running best on strict `<`: the same winner as
    one argmin over the level); the boolean cont stays whole, since the
    expansion and the children's gates are built from it."""
    if dirs.dim() == 2:
        res = trace_tile(dirs[None], root, templates, fractal, cfg)
        return TraceResult(
            **{f.name: getattr(res, f.name)[0]
               for f in dataclasses.fields(res)}
        )
    B, R, _ = dirs.shape
    dev = dirs.device
    lod_sq = torch.tensor(cfg.lod_factor**2, dtype=torch.float32, device=dev)
    sizes = _level_frontier_sizes(cfg)
    dx, dy, dz = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]  # [B, R, 1]

    min_t = torch.full((B, R), _BIG, dtype=torch.float32, device=dev)
    best_center = torch.zeros((B, R, 3), dtype=torch.float32, device=dev)
    max_depth = torch.zeros((B,), dtype=torch.int32, device=dev)
    nodes = torch.zeros((B,), dtype=torch.int32, device=dev)
    overflow = torch.zeros((B,), dtype=torch.int32, device=dev)

    frames = root[None, None].expand(B, 1, 3, 4)
    valid = torch.ones((B, 1), dtype=torch.bool, device=dev)
    gate = torch.ones((B, R, 1), dtype=torch.bool, device=dev)
    radius = fractal.root_radius
    chunk = max(_NODE_CHUNK, _STRICT_CHUNK_ELEMS // (B * R))

    for level in range(cfg.max_depth + 1):
        centers = frames[:, :, :, 3]  # [B, N, 3]
        n = centers.shape[1]
        r_sq = radius * radius
        lodr = lod_sq * radius
        reach = valid[:, None, :]
        if cfg.strict_lod:
            reach = gate & reach
        cont = torch.empty((B, R, n), dtype=torch.bool, device=dev)
        for n0 in range(0, n, chunk):
            c = centers[:, None, n0:n0 + chunk]  # [B, 1, n, 3]
            cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
            tca = dx * cx + dy * cy + dz * cz  # [B, R, n]
            d2 = (cx * cx + cy * cy + cz * cz) - tca * tca
            bhit, tb = ray_sphere(tca, d2, 4.0 * r_sq)  # bounding sphere 2r
            cont_c = reach[:, :, n0:n0 + chunk] & bhit & (tb < lodr)
            cont[:, :, n0:n0 + chunk] = cont_c
            # Self test (radius r), depth-tested against min_t
            # (`Sphereflake.h:185-225`).
            shit, ts = ray_sphere(tca, d2, r_sq)
            ts = torch.where(cont_c & shit, ts, torch.full_like(ts, _BIG))
            j = torch.argmin(ts, dim=-1, keepdim=True)  # first minimum
            t_best = torch.gather(ts, 2, j)[..., 0]
            upd = t_best < min_t
            min_t = torch.where(upd, t_best, min_t)
            won = torch.gather(centers, 1, (j + n0).expand(B, R, 3))
            best_center = torch.where(upd[..., None], won, best_center)

        any_cont = cont.any(dim=1)  # [B, N]: node wanted by some ray
        max_depth = torch.where(
            any_cont.any(dim=1), torch.full_like(max_depth, level), max_depth
        )
        nodes = nodes + valid.sum(dim=1, dtype=torch.int32)
        if level == cfg.max_depth:
            break

        # ---- expansion: frontier level -> level + 1 ----
        n_next = sizes[level + 1]
        if 9 * n <= n_next:
            # Dense expansion: every child of every node keeps a slot.
            parents, pvalid, pgate = frames, any_cont, cont
        else:
            # Compaction: the wanted nodes in order into the first
            # n_next // 9 slots; the drops are counted.
            keep = n_next // 9
            idx, pvalid, dropped = _compact(any_cont, keep)
            parents = torch.gather(
                frames, 1, idx[:, :, None, None].expand(B, keep, 3, 4)
            )
            pgate = torch.gather(cont, 2, idx[:, None, :].expand(B, R, keep))
            overflow = overflow + dropped
        scale = (1.0 + fractal.radius_ratio) * radius  # tangent distance
        scaled_tmpl = torch.cat(
            [templates[:, :, :3], templates[:, :, 3:] * scale], dim=2
        )
        frames = rt_multiply(
            parents[:, :, None], scaled_tmpl[None, None]
        ).reshape(B, -1, 3, 4)  # [B, 9P, 3, 4]
        valid = torch.repeat_interleave(pvalid, 9, dim=1)
        if cfg.strict_lod:
            gate = torch.repeat_interleave(pgate, 9, dim=2)
        radius = radius * fractal.radius_ratio

    return TraceResult(
        min_t=min_t,
        center=best_center,
        hit=min_t < _BIG,
        max_depth_reached=max_depth,
        nodes_visited=nodes,
        overflow=overflow,
    )


def trace_tile_fast(dirs, root, templates, fractal: FractalParams,
                    cfg: RenderConfig) -> TraceResult:
    """Cone-culled levelwise traversal, batched over tiles: dirs
    [B, R, 3] unit ray directions (origin 0, camera-relative space), or
    [R, 3] for one tile; root [3, 4]; templates [9, 3, 4]. Per-tile
    fields of the result carry the batch dimension (min_t [B, R],
    center [B, R, 3], the three metrics [B]); one tile gives the
    reference's shapes.

    - frontier expansion is decided by the tile's bounding cone
      (O(nodes) per level);
    - per-ray gating is local to each node (bounding + LOD at the node,
      no ancestor-chain mask), i.e. the packet-style semantics of the
      C++ app with the tile as the packet.

    The ray tests walk the frontier `_NODE_CHUNK` nodes at a time, the
    first minimal node of a chunk against the running best on strict
    `<`: the winner is the first minimal node of the level, as one
    argmin over the whole frontier would give."""
    if dirs.dim() == 2:
        res = trace_tile_fast(dirs[None], root, templates, fractal, cfg)
        return TraceResult(
            **{f.name: getattr(res, f.name)[0]
               for f in dataclasses.fields(res)}
        )
    B, R, _ = dirs.shape
    dev = dirs.device
    lod_sq = torch.tensor(cfg.lod_factor**2, dtype=torch.float32, device=dev)
    axis, cos_theta = tile_cone(dirs)
    dx, dy, dz = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]  # [B, R, 1]

    min_t = torch.full((B, R), _BIG, dtype=torch.float32, device=dev)
    best_center = torch.zeros((B, R, 3), dtype=torch.float32, device=dev)
    max_depth = torch.zeros((B,), dtype=torch.int32, device=dev)
    nodes = torch.zeros((B,), dtype=torch.int32, device=dev)
    overflow = torch.zeros((B,), dtype=torch.int32, device=dev)

    frames = root[None, None].expand(B, 1, 3, 4)
    valid = torch.ones((B, 1), dtype=torch.bool, device=dev)
    radius = fractal.root_radius
    cap = max(9, (cfg.max_frontier // 9) * 9)

    for level in range(cfg.max_depth + 1):
        centers = frames[:, :, :, 3]  # [B, N, 3]
        r_sq = radius * radius
        lodr = lod_sq * radius

        # Fused per-ray test: bounding(2r) + LOD gate + self(r) + min-t.
        for n0 in range(0, centers.shape[1], _NODE_CHUNK):
            c = centers[:, None, n0:n0 + _NODE_CHUNK]  # [B, 1, n, 3]
            cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
            tca = dx * cx + dy * cy + dz * cz  # [B, R, n]
            d2 = (cx * cx + cy * cy + cz * cz) - tca * tca
            front = (tca >= 0.0) & valid[:, None, n0:n0 + _NODE_CHUNK]
            tb = tca - safe_sqrt(4.0 * r_sq - d2)
            shit = front & (tb < lodr) & (d2 <= r_sq)
            ts = tca - safe_sqrt(r_sq - d2)
            ts = torch.where(shit, ts, torch.full_like(ts, _BIG))
            j = torch.argmin(ts, dim=-1, keepdim=True)  # first minimum
            t_best = torch.gather(ts, 2, j)[..., 0]
            upd = t_best < min_t
            min_t = torch.where(upd, t_best, min_t)
            won = torch.gather(
                centers, 1, (j + n0).expand(B, R, 3)
            )
            best_center = torch.where(upd[..., None], won, best_center)

        nodes = nodes + valid.sum(dim=1, dtype=torch.int32)
        max_depth = torch.where(
            valid.any(dim=1), torch.full_like(max_depth, level), max_depth
        )
        if level == cfg.max_depth:
            break

        # Expansion: all children of valid nodes -> cone + LOD cull ->
        # compact to capacity.
        scale = (1.0 + fractal.radius_ratio) * radius
        scaled_tmpl = torch.cat(
            [templates[:, :, :3], templates[:, :, 3:] * scale], dim=2
        )
        children = rt_multiply(
            frames[:, :, None], scaled_tmpl[None, None]
        ).reshape(B, -1, 3, 4)  # [B, 9N, 3, 4]
        child_valid = torch.repeat_interleave(valid, 9, dim=1)
        r_child = radius * fractal.radius_ratio
        keep = child_valid & _cone_cull(
            children[:, :, :, 3], r_child, axis, cos_theta, lod_sq
        )
        n_next = min(9 * frames.shape[1], cap)
        if children.shape[1] <= n_next:
            frames, valid = children, keep
        else:
            idx, valid, dropped = _compact(keep, n_next)
            frames = torch.gather(
                children, 1, idx[:, :, None, None].expand(B, n_next, 3, 4)
            )
            overflow = overflow + dropped
        radius = r_child

    return TraceResult(
        min_t=min_t,
        center=best_center,
        hit=min_t < _BIG,
        max_depth_reached=max_depth,
        nodes_visited=nodes,
        overflow=overflow,
    )


def tile_tracer(cfg: RenderConfig):
    """Select the plain-op traversal implementation for `cfg.algorithm`."""
    if cfg.algorithm == "fast":
        return trace_tile_fast
    if cfg.algorithm in ("strict", "loose"):
        return trace_tile
    if cfg.algorithm in ("pallas", "binned"):
        raise ValueError(
            f"algorithm {cfg.algorithm!r} is a Pallas kernel path; it is "
            "dispatched by render.trace_tiles / render_gbuffer and the "
            "progressive runtime, not by the per-tile XLA tracer"
        )
    raise ValueError(f"unknown algorithm {cfg.algorithm!r}")


def trace_rays(dirs, camera_position, fractal: FractalParams,
               cfg: RenderConfig) -> TraceResult:
    """Trace an arbitrary ray bundle [..., 3] (flattened into one tile)."""
    from sphereflake_tpu_torch.models.sphereflake import (
        child_templates,
        root_frame,
    )

    shape = dirs.shape[:-1]
    res = tile_tracer(cfg)(
        dirs.reshape(-1, 3),
        root_frame(camera_position),
        child_templates(fractal),
        fractal,
        cfg,
    )
    return TraceResult(
        min_t=res.min_t.reshape(shape),
        center=res.center.reshape(*shape, 3),
        hit=res.hit.reshape(shape),
        max_depth_reached=res.max_depth_reached,
        nodes_visited=res.nodes_visited,
        overflow=res.overflow,
    )
