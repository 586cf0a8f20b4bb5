"""Frameless progressive rendering — the C++ app's defining feature.

Counterpart of the reference package's `runtime/progressive.py`. The
C++ app's worker threads loop forever, each iteration drawing one
Sobol-distributed pixel, tracing a packet around it, and scattering the
result into the shared G-buffer with no frame barrier
(`Sphereflake.cpp:86-214`). The display thread snapshots whatever is in
the buffer at vsync.

Two equivalents here, both pure step functions (a step returns a new
state and leaves the old one as it was):

- **Tile-granular** (`progressive_tiles_step`, the production mode):
  the refresh unit is a whole 1024-ray tile — one kernel block, as the
  C++ app's is 8 AVX lanes. Sobol chooses TILES; each step traces them
  through the subset mode of the fused kernel and overwrites their rows
  densely.
- **Sample-granular** (`progressive_step`, the C++ app's semantics):
  Sobol chooses PIXELS; batches are tile-sorted into 1024-ray bundles,
  traced over conservative pair-segment spans by the ray-bundle mode of
  the pair kernel ("binned") or each on its own by the per-tile
  traversal kernel ("pallas"), or traced as one tile by a plain-op
  traversal ("fast", "strict", "loose"), and scattered per pixel. It
  exists for parity with the C++ app's exact sampling law.

The display analogue is reading the state's tensors between steps.

Determinism: the C++ app scrambles every sample with a fresh `mt19937`
draw seeded by `time(NULL)` (`Sphereflake.cpp:88-90,139-141`). Here each
step derives its scrambles from a hash of the user-provided seed —
reproducible, and with `scramble="fixed"` the Sobol stream keeps its
stratification (`scramble="per_sample"` mimics the C++ app's
white-noise behaviour).

**The cursor lives on the host.** `sample_lo`, `sample_hi`, `seed` and
`samples_traced` are Python ints on the state (each a uint32 value,
wrapped by `& 0xFFFFFFFF`): nothing computed on the device determines
them, so keeping them on the host costs no transfer in either
direction, and a step reads nothing back (no `.item()`, `int(tensor)`
or `bool(tensor)`). What the device does determine —
`closest_distance`, `overflow`, the G-buffer — stays in 0-d and dense
device tensors. Steps run under `torch.no_grad()`.
"""

from __future__ import annotations

import dataclasses

import torch

from sphereflake_tpu_torch import spans
from sphereflake_tpu_torch.camera import ray_directions
from sphereflake_tpu_torch.config import (
    RenderConfig,
    SceneParams,
    resolve_device,
)
from sphereflake_tpu_torch.models.sphereflake import (
    child_templates,
    root_frame,
)
from sphereflake_tpu_torch.ops.sobol import sobol_sample
from sphereflake_tpu_torch.ops.traversal import (
    _BIG,
    TraceResult,
    shade_gbuffer,
    tile_tracer,
)

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9  # second scramble stream: seed ^ golden-ratio constant


@dataclasses.dataclass
class ProgressiveState:
    """Persistent frameless G-buffer + sample-stream cursor."""

    position: torch.Tensor  # [H, W, 3]
    normal: torch.Tensor  # [H, W, 3]
    min_t: torch.Tensor  # [H, W]
    sample_lo: int  # uint32 — global Sobol index cursor (low word)
    sample_hi: int  # uint32 — high word (52-bit stream like the C++ app)
    seed: int  # uint32 — scramble stream seed
    closest_distance: torch.Tensor  # [] f32, resettable like the C++ metric
    samples_traced: int  # uint32, wraps
    overflow: torch.Tensor  # [] int32 — accumulated pair drops (never silent)


def progressive_init(
    cfg: RenderConfig, seed: int = 0, device="cuda"
) -> ProgressiveState:
    dev = resolve_device(device)
    h, w = cfg.height, cfg.width
    return ProgressiveState(
        position=torch.zeros((h, w, 3), dtype=torch.float32, device=dev),
        normal=torch.zeros((h, w, 3), dtype=torch.float32, device=dev),
        min_t=torch.full((h, w), _BIG, dtype=torch.float32, device=dev),
        sample_lo=0,
        sample_hi=0,
        seed=int(seed) & _M32,
        closest_distance=torch.full((), _BIG, dtype=torch.float32, device=dev),
        samples_traced=0,
        overflow=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _hash_u32(x):
    """Stateless integer hash (PCG-ish mix) for per-sample scrambles,
    on uint32 values: a Python int gives a Python int, an int64 tensor
    of values in [0, 2^32) gives one. Every multiply and shift is masked
    back to 32 bits; the tensor products are split into 16-bit halves of
    the constant so that no int64 intermediate overflows."""
    if isinstance(x, torch.Tensor):
        def mul(v, c):
            lo = v * (c & 0xFFFF)
            hi = (v * (c >> 16)) & 0xFFFF
            return (lo + (hi << 16)) & _M32

        x = x.to(torch.int64) & _M32
    else:
        def mul(v, c):
            return (v * c) & _M32

        x = int(x) & _M32
    x = x ^ (x >> 16)
    x = mul(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x & _M32


def _cursor_indices(sample_lo: int, sample_hi: int, n: int, device):
    """The n Sobol indices from the 64-bit cursor on, as uint32 halves
    in int64 tensors (idx_lo, idx_hi) — the hi word picks up the carry
    where the lo word wraps — and the cursor after them (lo, hi)."""
    lane = torch.arange(n, dtype=torch.int64, device=device)
    full = lane + (sample_lo & _M32)
    idx_lo = full & _M32
    idx_hi = ((full >> 32) + (sample_hi & _M32)) & _M32
    end = (sample_lo & _M32) + n
    return idx_lo, idx_hi, end & _M32, (sample_hi + (end >> 32)) & _M32


def progressive_prepare(scene: SceneParams, cfg: RenderConfig, device="cuda"):
    """Bin the frame ONCE for a camera/fractal pose, for reuse across
    progressive steps (`progressive_step(..., prepared=...)`).

    The pair table depends only on (scene, cfg) — exactly the state the
    C++ app's workers reread each iteration (`Sphereflake.cpp:155-173`)
    — so the caller re-prepares when the camera moves, and steps stay
    pure. Returns (pairs, starts, lens, pair_overflow) on `device`."""
    from sphereflake_tpu_torch.ops.binned import binned_pairs

    scene = scene.to(resolve_device(device))
    with torch.no_grad():
        root = root_frame(scene.camera.position)
        templates = child_templates(scene.fractal)
        pairs, t_starts, t_lens, (_n, pair_ovf) = binned_pairs(
            scene, cfg, root, templates
        )
    return pairs, t_starts, t_lens, pair_ovf


class FramelessCapacityError(RuntimeError):
    """The frameless capacity ladder reached its ceiling."""


def grow_frameless_capacity(cfg: RenderConfig) -> RenderConfig:
    """One rung of the FRAMELESS capacity ladder: double global_cap.

    The full-frame ladder (`render.grow_capacity`) falls back to
    BANDING past the global_cap ceiling, but banding cannot help the
    frameless path — its prepared pair table spans the whole frame —
    so this ladder ends with a clean error instead of spinning through
    futile re-prepares on band settings the prepare ignores. Callers:
    `cli.py --progressive` and `runtime.animate.frameless_animate`."""
    if cfg.global_cap >= (9 << 16):
        raise FramelessCapacityError(
            "frameless pair table overflows at the capacity ceiling; "
            "render this pose full-frame (banded) instead"
        )
    return dataclasses.replace(cfg, global_cap=cfg.global_cap * 2)


def progressive_prepare_trimmed(
    scene: SceneParams, cfg: RenderConfig, device="cuda"
):
    """`progressive_prepare` + occlusion trim: renders the frame once
    through the fused kernel, then drops every (node, tile) pair that
    PROVABLY cannot win any pixel of its tile — the node's closest
    possible hit distance exceeds the tile's farthest winner.

    Output-preserving by construction: a self-hit on a sphere at
    center c, radius r has t >= |c| - r exactly, and numerically-fuzzy
    tangent grazes stay within the same whole-r margin the 2r binning
    radius provides (`bin_nodes`), so the bound used here is
    t_lo = |c| - 2r - eps. A pair with t_lo > max(min_t over the tile)
    can never beat the incumbent winner at any pixel (sky pixels hold
    min_t = BIG, so any tile containing sky keeps all its candidates).
    A second, exact sphere-vs-tile-frustum cull drops bbox-corner
    phantoms the interval binning admits. The sort that closes the gaps
    is stable, so every tile keeps its pairs in their old order and
    every step's output is bit-identical to the untrimmed table's
    (pinned by the tests and by `chip_smoke.py` on the card).
    Static-camera refresh re-traces the same view continuously, so the
    one-time trim cost is amortized across the whole accumulation while
    every remaining step tests fewer candidates.

    Returns (pairs, starts, lens, pair_overflow) — drop-in for the
    `prepared` argument of the step functions."""
    from sphereflake_tpu_torch.camera import tile_frustum_planes
    from sphereflake_tpu_torch.ops.binned import (
        camera_vector,
        trace_pairs_fused_soa,
    )

    dev = resolve_device(device)
    scene = scene.to(dev)
    pairs, starts, lens, pair_ovf = progressive_prepare(scene, cfg, dev)
    with torch.no_grad():
        cam = camera_vector(scene, cfg)
        out, _m = trace_pairs_fused_soa(cam, pairs, starts, lens, cfg)
        T = cfg.tiles_y * cfg.tiles_x
        t_max = torch.amax(out[:, 0].reshape(T, -1), dim=1)  # BIG if any sky

        cap = pairs.shape[1]
        iota = torch.arange(cap, dtype=torch.int32, device=dev)
        bounds = torch.cat([starts, (starts[-1] + lens[-1])[None]])
        tile_of = torch.clamp(
            torch.searchsorted(bounds, iota, right=True, out_int32=True) - 1,
            0, T,
        )
        tile_c = torch.clamp_max(tile_of, T - 1).long()
        in_seg = iota < bounds[-1]
        # Fat-rows payload: rc = r^2 - |c|^2 at row 3, rc4 = 4r^2 - |c|^2
        # at the last row; recover |c| and rad = 2r (f32 round-off here
        # is dwarfed by the whole-r margins below). The divisor is a
        # tensor: a true division on every device.
        rc, rc4 = pairs[3], pairs[-1]
        three = torch.full((), 3.0, dtype=torch.float32, device=dev)
        cc = torch.clamp_min((rc4 - 4.0 * rc) / three, 0.0)
        r2 = torch.clamp_min((rc4 - rc) / three, 0.0)
        rad = 2.0 * torch.sqrt(r2)
        # Occlusion bound: the exact minimum self-hit distance is
        # |c| - r; keep the same whole-r fuzz margin the 2r binning
        # radius provides, i.e. t_lo = |c| - 2r.
        t_lo = torch.sqrt(cc) - rad - 1e-3
        keep = in_seg & (t_lo <= t_max[tile_c])
        # Exact sphere-vs-tile-frustum cull: a tile ray that registers a
        # (fuzzy) self-hit has a point within 2r of the center, so
        # plane distance < -2r proves no hit.
        planes = tile_frustum_planes(
            scene.camera, cfg.width, cfg.height, cfg.tile_h, cfg.tile_w,
            block_h=cfg.padded_height, block_w=cfg.padded_width,
        )  # [T, 4, 3] unit inward normals
        pp = planes[tile_c]  # [cap, 4, 3]
        cx, cy, cz = pairs[0], pairs[1], pairs[2]
        dmin = torch.amin(
            pp[:, :, 0] * cx[:, None]
            + pp[:, :, 1] * cy[:, None]
            + pp[:, :, 2] * cz[:, None],
            dim=1,
        )
        keep = keep & (dmin >= -(rad + 1e-3))
        new_tile = torch.where(keep, tile_of, torch.full_like(tile_of, T))

        # Stable sort keeps the per-tile pair order.
        key_sorted, idx = torch.sort(new_tile, stable=True)
        pairs2 = pairs[:, idx]
        dead = key_sorted >= T
        pairs2[3] = torch.where(
            dead, torch.full_like(pairs2[3], -_BIG), pairs2[3]
        )
        bounds2 = torch.searchsorted(
            key_sorted,
            torch.arange(T + 1, dtype=torch.int32, device=dev),
            out_int32=True,
        )
        starts2 = bounds2[:-1].contiguous()
        lens2 = (bounds2[1:] - bounds2[:-1]).contiguous()
    return pairs2, starts2, lens2, pair_ovf


def _trace_bundled(dirs, xi, yi, scene, cfg: RenderConfig, root, templates,
                   prepared) -> TraceResult:
    """Trace a batch of sample rays `dirs` [B, 3] at pixels (xi, yi)
    through a 1024-ray-bundle kernel: the pair kernel's ray-bundle mode
    ("binned") or the per-tile traversal kernel ("pallas")."""
    from sphereflake_tpu_torch.ops.pallas_traversal import (
        TILE_RAYS,
        depth_reached_soa,
        resolve_codes,
    )

    dev = dirs.device
    # The kernels want 1024-ray bundles. Sobol samples are scattered
    # across the screen, so the batch is sorted into spatially-local
    # groups first (samples of nearby tiles land in the same bundle),
    # then the results are unsorted.
    tile_id = torch.div(
        yi, cfg.tile_h, rounding_mode="floor"
    ) * cfg.tiles_x + torch.div(xi, cfg.tile_w, rounding_mode="floor")
    tid_sorted, order = torch.sort(tile_id, stable=True)
    groups = dirs[order].reshape(-1, TILE_RAYS, 3)

    if cfg.algorithm == "binned":
        from sphereflake_tpu_torch.ops.binned import (
            binned_pairs,
            trace_pairs_pallas,
        )

        # Give each bundle the contiguous pair-segment SPAN of the tiles
        # it touches (tile segments are adjacent in tile order, so the
        # union of tiles [t_lo, t_hi] is pairs[starts[t_lo] :
        # starts[t_hi] + lens[t_hi]]) — a conservative superset;
        # per-ray tests are exact, and the kernel walks spans of any
        # length.
        if prepared is not None:
            pairs, t_starts, t_lens, pair_ovf = prepared
        else:
            pairs, t_starts, t_lens, (_n, pair_ovf) = binned_pairs(
                scene, cfg, root, templates
            )
        tid_sorted = tid_sorted.reshape(-1, TILE_RAYS)
        t_lo, t_hi = tid_sorted[:, 0].long(), tid_sorted[:, -1].long()
        b_start = t_starts[t_lo]
        b_len = t_starts[t_hi] + t_lens[t_hi] - b_start
        _, code, code_hi, m = trace_pairs_pallas(
            groups, pairs, b_start, b_len, cfg
        )
        depth_r = depth_reached_soa(code, cfg, code_hi)
        overflow = m[:, 0, 1].sum(dtype=torch.int32) + pair_ovf
    else:
        from sphereflake_tpu_torch.camera import bundle_frustum_planes
        from sphereflake_tpu_torch.ops.pallas_traversal import (
            trace_tiles_pallas,
        )

        planes = bundle_frustum_planes(groups)
        _, code, m = trace_tiles_pallas(
            groups, planes, root, templates, scene.fractal, cfg
        )
        code_hi = None
        depth_r = torch.max(m[:, 0, 2])
        overflow = m[:, 0, 1].sum(dtype=torch.int32)
    mt_s, center_s, hit_s = resolve_codes(
        groups, code, root, templates, scene.fractal, cfg,
        code_hi_f=code_hi,
    )
    # Undo the tile sort: sample order[j] gets sorted row j.
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], dtype=order.dtype, device=dev)
    return TraceResult(
        min_t=mt_s.reshape(-1)[inv],
        center=center_s.reshape(-1, 3)[inv],
        hit=hit_s.reshape(-1)[inv],
        max_depth_reached=depth_r,
        nodes_visited=m[:, 0, 0].sum(dtype=torch.int32),
        overflow=overflow,
    )


def progressive_step(
    state: ProgressiveState,
    scene: SceneParams,
    cfg: RenderConfig,
    batch_size: int = 16384,
    scramble: str = "fixed",
    prepared=None,
) -> ProgressiveState:
    """Trace one batch of Sobol samples and scatter into the G-buffer,
    on the state's device.

    By `cfg.algorithm`: "binned" sorts the batch into 1024-ray bundles
    for the pair kernel's ray-bundle mode, "pallas" for the per-tile
    traversal kernel (each bundle culled by its own bounding pyramid);
    "fast", "strict" and "loose" trace the whole batch as one tile
    through their plain-op traversal (`ops/traversal.tile_tracer`).

    `prepared` (binned only): the cached `progressive_prepare` pair
    table (the UNTRIMMED one — bundle spans need the segments of
    neighbouring tiles adjacent in the table); without it every step
    re-bins the whole frame."""
    from sphereflake_tpu_torch.ops.pallas_traversal import TILE_RAYS

    bundled = cfg.algorithm in ("pallas", "binned")
    if bundled:
        assert batch_size % TILE_RAYS == 0, (
            f"pallas/binned progressive needs batch_size % {TILE_RAYS} == 0"
        )
    dev = state.min_t.device
    scene = scene.to(dev)
    h, w = cfg.height, cfg.width
    with torch.no_grad():
        idx_lo, idx_hi, next_lo, next_hi = _cursor_indices(
            state.sample_lo, state.sample_hi, batch_size, dev
        )
        if scramble == "per_sample":
            scr0 = _hash_u32(idx_lo ^ state.seed)
            scr1 = _hash_u32(idx_lo ^ (state.seed ^ _GOLDEN))
        else:  # fixed per-stream scramble: keeps the (0,2)-sequence structure
            scr0 = _hash_u32(state.seed)
            scr1 = _hash_u32(state.seed ^ _GOLDEN)

        # Pixel selection mirrors `Sphereflake.cpp:139-141`:
        # x = 1 + floor(sobol0 * (W-2)), y likewise (AVX path).
        sx = sobol_sample(idx_lo, 0, scr0, idx_hi)
        sy = sobol_sample(idx_lo, 1, scr1, idx_hi)
        px = 1.0 + torch.floor(sx * (w - 2))
        py = 1.0 + torch.floor(sy * (h - 2))

        dirs = ray_directions(scene.camera, px, py, w, h)  # [B, 3]
        root = root_frame(scene.camera.position)
        templates = child_templates(scene.fractal)
        xi = px.to(torch.int32)
        yi = py.to(torch.int32)

        if bundled:
            res = _trace_bundled(
                dirs, xi, yi, scene, cfg, root, templates, prepared
            )
        else:
            res = tile_tracer(cfg)(dirs, root, templates, scene.fractal, cfg)
        pos, nrm = shade_gbuffer(dirs, res)

        # Deterministic duplicate resolution: the C++ app's racy
        # G-buffer lets whichever thread writes last win
        # (`Sphereflake.cpp:186-201`); here duplicates within a batch
        # resolve to the LAST sample in batch order, made explicit by
        # scattering only each pixel's final winner (the losers all go
        # to a dump slot past the image, which is cut off again).
        pix = yi * w + xi
        pix_s, s_order = torch.sort(pix, stable=True)
        is_winner = torch.cat([
            pix_s[:-1] != pix_s[1:],
            torch.ones((1,), dtype=torch.bool, device=dev),
        ])
        dst = torch.where(
            is_winner, pix_s, torch.full_like(pix_s, w * h)
        ).long()

        def scatter_plane(plane, updates):
            flat = plane.reshape(w * h, *updates.shape[1:])
            pad = torch.zeros((1, *updates.shape[1:]), dtype=flat.dtype,
                              device=dev)
            out = torch.cat([flat, pad], dim=0)
            out[dst] = updates[s_order]
            return out[: w * h].reshape(plane.shape)

        position = scatter_plane(state.position, pos)
        normal = scatter_plane(state.normal, nrm)
        min_t = scatter_plane(state.min_t, res.min_t)

        batch_closest = torch.min(
            torch.where(res.hit, res.min_t, torch.full_like(res.min_t, _BIG))
        )
        return ProgressiveState(
            position=position,
            normal=normal,
            min_t=min_t,
            # 64-bit cursor advance: +1 past the last index, carrying
            # into the hi word when lo wraps (power-of-two batch sizes
            # land the cursor exactly on the 2^32 boundary, where
            # dropping the carry would restart the Sobol stream).
            sample_lo=next_lo,
            sample_hi=next_hi,
            seed=state.seed,
            closest_distance=torch.minimum(
                state.closest_distance, batch_closest
            ),
            samples_traced=(state.samples_traced + batch_size) & _M32,
            overflow=state.overflow + res.overflow,
        )


def reset_closest_distance(state):
    """`Sphereflake::ResetClosestSphereDistance` (`Sphereflake.h:55-58`)."""
    return dataclasses.replace(
        state, closest_distance=torch.full_like(state.closest_distance, _BIG)
    )


@dataclasses.dataclass
class TileProgressiveState:
    """Frameless accumulation at TILE granularity. The C++ app's workers
    refresh 8-pixel AVX packets chosen by a Sobol stream
    (`Sphereflake.cpp:139-150`); the packet here is a 1024-ray tile (one
    kernel row), so the frameless unit becomes a tile: each step
    traces a Sobol-chosen batch of whole tiles through the SAME fused
    kernel as full frames (raygen + trace + shade in one call) and
    overwrites those tiles' rows."""

    rows: torch.Tensor  # [T, 7, 8, 128] shaded kernel rows (min_t, pos3, nrm3)
    covered: torch.Tensor  # [T] bool — tile refreshed at least once
    sample_lo: int  # uint32 Sobol cursor
    sample_hi: int
    seed: int
    closest_distance: torch.Tensor  # [] f32
    samples_traced: int  # uint32, wraps
    overflow: torch.Tensor  # [] int32 — pair-table/kernel drops, accumulated
    # per step (the project invariant: overflow is counted, never
    # silent — the CLI retries via the capacity ladder on it, like the
    # full-frame path)


def progressive_tiles_init(
    cfg: RenderConfig, seed: int = 0, device="cuda"
) -> TileProgressiveState:
    dev = resolve_device(device)
    T = cfg.tiles_y * cfg.tiles_x
    rows = torch.zeros((T, 7, 8, 128), dtype=torch.float32, device=dev)
    rows[:, 0] = _BIG  # min_t row: sky until traced
    return TileProgressiveState(
        rows=rows,
        covered=torch.zeros((T,), dtype=torch.bool, device=dev),
        sample_lo=0,
        sample_hi=0,
        seed=int(seed) & _M32,
        closest_distance=torch.full((), _BIG, dtype=torch.float32, device=dev),
        samples_traced=0,
        overflow=torch.zeros((), dtype=torch.int32, device=dev),
    )


def progressive_tile_ids(state, cfg: RenderConfig, tiles_per_step: int):
    """The `tiles_per_step` Sobol-chosen frame tile ids ([K] int32, on
    the state's device) of the step that starts at the state's cursor,
    and the cursor after it (lo, hi)."""
    T = cfg.tiles_y * cfg.tiles_x
    idx_lo, idx_hi, next_lo, next_hi = _cursor_indices(
        state.sample_lo, state.sample_hi, tiles_per_step, state.rows.device
    )
    s = sobol_sample(idx_lo, 0, _hash_u32(state.seed), idx_hi)
    # s can be exactly 1.0 (see `sobol_sample`): clamp.
    ids = torch.clamp_max((s * T).to(torch.int32), T - 1)
    return ids, next_lo, next_hi


def progressive_tiles_step(
    state: TileProgressiveState,
    scene: SceneParams,
    cfg: RenderConfig,
    tiles_per_step: int = 128,
    prepared=None,
) -> TileProgressiveState:
    """Trace `tiles_per_step` Sobol-chosen tiles and refresh them, on
    the state's device.

    `prepared`: cached `progressive_prepare[_trimmed]` pair table
    (static camera); without it the frame is re-binned each step."""
    from sphereflake_tpu_torch.ops.binned import (
        binned_pairs,
        camera_vector,
        trace_pairs_fused_subset,
    )

    with spans.unit("tiles_step"), torch.no_grad():
        dev = state.rows.device
        scene = scene.to(dev)
        with spans.span("tiles_step.ids"):
            ids, next_lo, next_hi = progressive_tile_ids(
                state, cfg, tiles_per_step
            )
        if prepared is not None:
            pairs, starts, lens, pair_ovf = prepared
        else:
            root = root_frame(scene.camera.position)
            templates = child_templates(scene.fractal)
            pairs, starts, lens, (_n, pair_ovf) = binned_pairs(
                scene, cfg, root, templates
            )
        with spans.span("tiles_step.pack"):
            cam = camera_vector(scene, cfg)
        # shade_only: the state never stores path codes, so the code
        # accumulators leave the kernel's loop and the output rows ARE
        # the state layout (min_t, pos3, nrm3) — no re-pack copy.
        with spans.span("tiles_step.k2"):
            out, m = trace_pairs_fused_subset(
                cam, pairs, starts, lens, ids, cfg, shade_only=True
            )
        with spans.span("tiles_step.scatter"):
            # Duplicate tile ids within a batch write IDENTICAL rows (same
            # camera), so the unordered scatter is deterministic by value.
            ids_l = ids.long()
            rows = state.rows.clone()
            rows[ids_l] = out
            covered = state.covered.clone()
            covered[ids_l] = True
            # Includes the padded extrapolation columns of edge tiles;
            # `tile_progressive_composite` recomputes it from the cropped
            # plane.
            batch_closest = torch.min(out[:, 0])
            return TileProgressiveState(
                rows=rows,
                covered=covered,
                # hi-word carry at the 2^32 lo wrap (`_cursor_indices`).
                sample_lo=next_lo,
                sample_hi=next_hi,
                seed=state.seed,
                closest_distance=torch.minimum(
                    state.closest_distance, batch_closest
                ),
                samples_traced=(
                    state.samples_traced + tiles_per_step * 1024
                ) & _M32,
                overflow=(
                    state.overflow + pair_ovf
                    + m[..., 1].sum(dtype=torch.int32)
                ),
            )


def tile_progressive_gbuffer(state: TileProgressiveState, cfg: RenderConfig):
    """Snapshot the accumulated tile rows as (position, normal, min_t,
    hit) images — the display read of the frameless loop."""
    from sphereflake_tpu_torch.render import _untile_rows

    imgs = _untile_rows(state.rows, cfg)
    min_t = imgs[0]
    hit = min_t < _BIG
    position = torch.stack(imgs[1:4], dim=-1)
    normal = torch.stack(imgs[4:7], dim=-1)
    return position, normal, min_t, hit


def tile_progressive_composite(
    state: TileProgressiveState,
    scene: SceneParams,
    cfg: RenderConfig,
    noise=None,
):
    """SSAO -> blur -> blur -> composite over the IN-FLIGHT frameless
    buffer — the C++ app's display loop, which every vsync uploads
    whatever the workers have written so far and runs the full post
    chain on it (`main.cpp:301-335`, `SSAO.cpp:106-142`). Tiles never
    refreshed still hold their init rows (sky).

    At full coverage the result equals `render_frame(scene, cfg)[0]`
    of the same scene: the closest distance feeding the SSAO radius law
    (`main.cpp:316`) is recomputed from the cropped min_t plane with
    the full renderer's exact formula, not the running metric (which
    also sees padded extrapolation columns).
    """
    from sphereflake_tpu_torch.ops.noise import ssao_noise_texture
    from sphereflake_tpu_torch.ops.post import postprocess

    dev = state.rows.device
    scene = scene.to(dev)
    with torch.no_grad():
        position, normal, min_t, _hit = tile_progressive_gbuffer(state, cfg)
        closest = torch.min(min_t)  # `render._binned_gbuffer` metric formula
        if noise is None:
            noise = torch.from_numpy(ssao_noise_texture(cfg.noise_size)).to(dev)
        return postprocess(position, normal, closest, scene, cfg, noise)
