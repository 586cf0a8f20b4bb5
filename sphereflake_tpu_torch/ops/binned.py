"""Binned traversal: frame-global expansion + screen-tile binning (plain
torch) feeding ONE fused CUDA kernel (raygen + ray tests + shading).

Counterpart of the reference package's `ops/binned.py`. The tree is
walked once per frame:

1. **Global expansion** (`expand_global`): dense SoA frontier per level,
   culled by the whole-frame frustum and the conservative LOD bound —
   the C++ app's recursion (`Sphereflake.h:86-226`) with the screen for
   a packet. Levels wider than `cfg.global_cap` are compacted to the
   cap's closest live nodes (stable sort + gather), overflow counted.
2. **Binning** (`bin_nodes`): every live node's bounding sphere (radius
   2r) is projected to a conservative screen-space tile range by
   interval arithmetic in the corner-ray basis; behind-camera nodes are
   dropped by a corner-ray dot cull; (node, tile) pairs are laid out by
   one packed-key sort into dense per-tile segments of a 7|8-row
   payload (`node_rows`).
3. **Fused kernel** (`trace_pairs_fused_soa`): one row per tile, cut
   into work items of `ITEM_PAIRS` pairs; the kernel derives its ray
   directions from 16 camera scalars, walks the tile's segment and
   shades the winner to (min_t, position, normal).
   The kernel is hand-written CUDA (`csrc/pairs_kernel.cu`); its plain
   torch version (`trace_pairs_fused_plain`) lives here beside it.
   Two more launch modes of the same kernel serve the frameless
   refresh: an indirect list of tiles (`trace_pairs_fused_subset`) and
   bundles of given ray directions against pair-table spans
   (`trace_pairs_pallas_soa`), each with its plain version; the three
   plain versions share one walk (`_walk_pairs`).

All shapes are static functions of `RenderConfig` (`global_cap`,
`pair_cap`, counted overflow): nothing between a frame's entry and its
return reads a value back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from sphereflake_tpu_torch import kernels, spans
from sphereflake_tpu_torch.config import FractalParams, RenderConfig
from sphereflake_tpu_torch.ops.recompute_vjp import level_radii, recompute_vjp

_BIG = 3.0e38  # rounds to np.float32(3.0e38) in every f32 tensor op

PAIR_CAP = 1 << 20  # upper bound on cfg.pair_cap
_RAYS = 1024  # rays per tile (one kernel block)

_POW7 = 9**7  # path-code hi/lo split: lo < 9^7 stays f32-exact
# Depth bound of the two-lane f32 path code: a level-d code (with its
# sentinel) lies in [9^d, 9^(d+1)), so at d = 13 hi = code // 9^7 stays
# below 9^7 = 4,782,969 < 2^24 and both lanes are f32-exact. 13 is also
# the physical f32 limit: level-13 spheres have radius 3^-13 ~ 6.3e-7,
# approaching the f32 relative-precision floor of the center
# coordinates themselves.
DEEP_MAX_DEPTH = 13


def _expand_cap(cfg: RenderConfig) -> int:
    """Pre-expansion live cap: once a level's children would exceed
    global_cap, the parents are compacted this hard first. global_cap
    defaults to exactly 9x this, so compacted parents' children fill
    the emitted level with no second (emit-time) compaction sort."""
    return max(4096, cfg.global_cap // 9)


def expand_global(
    root: torch.Tensor,  # [3, 4]
    templates: torch.Tensor,  # [9, 3, 4]
    fractal: FractalParams,
    cfg: RenderConfig,
    frame_planes: torch.Tensor,  # [4, 3] (or [B, 4, 3]) inward unit planes
):
    """Levelwise SoA expansion of the whole LOD-passing tree.

    Levels stay DENSE (masked, no data movement) while their 9^l width
    fits `cfg.global_cap`; wider levels are compacted to the cap's
    CLOSEST live nodes before emission, which bounds the binning
    stage's arrays and makes the C++ app's unbounded LOD-terminated
    recursion depth (`Sphereflake.h:146-153`) reachable.

    Path codes ride two lanes (code = hi * 9^7 + lo) so depths past 7
    stay exact in f32 kernel rows (`DEEP_MAX_DEPTH` = 13).

    `frame_planes` of shape [B, 4, 3] expands B blocks (the bands of
    one frame) at once: every op is one launch for all of them, and
    block b's nodes and overflow equal those of its own [4, 3] call bit
    for bit (the same elementwise ops on the same values, one stable
    sort per block). Until the first compaction the blocks share every
    node and differ only in `live`.

    Returns (nodes dict with [N] ([B, N]) component tensors over all
    levels concatenated — cx, cy, cz, cc, r2, code (lo, int32),
    code_hi (int32), live (bool), rad — and the compaction overflow
    count, a 0-d ([B]) int32 tensor).
    """
    assert cfg.max_depth <= DEEP_MAX_DEPTH, (
        f"binned path supports max_depth <= {DEEP_MAX_DEPTH} "
        "(two-lane path-code exactness)"
    )
    dev = root.device
    depth = cfg.max_depth
    cap = cfg.global_cap
    lod_sq = torch.tensor(cfg.lod_factor**2, dtype=torch.float32, device=dev)
    ratio = fractal.radius_ratio
    radius0 = fractal.root_radius
    batched = frame_planes.dim() == 3
    planes = frame_planes if batched else frame_planes[None]
    nb = planes.shape[0]

    rot = [[templates[:, a, b] for b in range(3)] for a in range(3)]  # [9]
    disp = [templates[:, a, 3] for a in range(3)]

    # Level 0: the root frame. Node arrays are [1 or B, N]: one row
    # shared by every block until a compaction gives each its own.
    r = [root[a, b].reshape(1, 1) for a in range(3) for b in range(3)]
    t = [root[a, 3].reshape(1, 1) for a in range(3)]
    lo = torch.ones((1, 1), dtype=torch.int32, device=dev)
    hi = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    live = torch.ones((1, 1), dtype=torch.bool, device=dev)
    overflow = torch.zeros((nb,), dtype=torch.int32, device=dev)

    out = {k: [] for k in ("cx", "cy", "cz", "cc", "r2", "code",
                            "code_hi", "live", "rad")}

    def cull(t, live, radius):
        cx, cy, cz = t
        cc = cx * cx + cy * cy + cz * cz
        # Whole-frame frustum + LOD cull.
        lim = lod_sq * radius + 2.0 * radius
        keep = live & (cc < lim * lim)
        for p in range(4):
            d_p = (
                planes[:, p, 0, None] * cx
                + planes[:, p, 1, None] * cy
                + planes[:, p, 2, None] * cz
            )
            keep = keep & (d_p >= -2.0 * radius)
        return keep

    def emit(t, lo, hi, live, radius):
        cx, cy, cz = t
        ones = torch.ones(cx.shape, dtype=torch.float32, device=dev)
        out["cx"].append(cx)
        out["cy"].append(cy)
        out["cz"].append(cz)
        out["cc"].append(cx * cx + cy * cy + cz * cz)
        out["r2"].append(ones * (radius * radius))
        out["code"].append(lo)
        out["code_hi"].append(hi)
        out["live"].append(live)
        out["rad"].append(ones * (2.0 * radius))

    def compact(r, t, lo, hi, live, cap=cap):
        """Sort-and-gather compaction of live nodes to [cap] slots: one
        stable sort by (dead, distance) orders the closest live nodes
        first, so the over-cap drop policy is LOD-consistent — the
        FARTHEST nodes go, never the near subtree an approach dive
        exists to reveal."""
        total_all = live.sum(dim=-1, dtype=torch.int32)
        cc = t[0] * t[0] + t[1] * t[1] + t[2] * t[2]
        key = torch.where(live, cc, torch.full_like(cc, _BIG))
        idx = torch.sort(key, dim=-1, stable=True).indices[:, :cap]
        total = torch.clamp_max(total_all, cap)
        new_live = (torch.arange(cap, dtype=torch.int32, device=dev)
                    < total[:, None])

        def take(x):
            return torch.gather(x.expand(nb, x.shape[1]), 1, idx)

        return (
            [take(x) for x in r],
            [take(x) for x in t],
            take(lo),
            take(hi),
            new_live,
            torch.clamp_min(total_all - cap, 0),
        )

    radius = radius0
    live = cull(t, live, radius)
    emit(t, lo, hi, live, radius)
    ecap = _expand_cap(cfg)
    j9 = torch.arange(9, dtype=torch.int32, device=dev)[:, None]
    for _level in range(depth):
        n = live.shape[1]
        if 9 * n > cap and n > ecap:
            # Children would exceed the cap. Only parents that can
            # produce a LOD-passing child need to survive: a child's
            # emit cull needs |c_child| < lod^2*r_c + 2*r_c, and
            # |c_child| >= |c_parent| - (1+ratio)*r_p, so the gate
            # below is exactly conservative.
            r_c = radius * ratio
            lim = lod_sq * r_c + 2.0 * r_c + (1.0 + ratio) * radius
            cc_cur = t[0] * t[0] + t[1] * t[1] + t[2] * t[2]
            gate = live & (cc_cur < lim * lim)
            r, t, lo, hi, live, ovf = compact(r, t, lo, hi, gate, ecap)
            overflow = overflow + ovf
        scale = (1.0 + ratio) * radius
        # Children: [., 9, N] via broadcasting template constants.
        new_r = [
            sum(r[3 * a + k][:, None, :] * rot[k][b][:, None]
                for k in range(3))
            for a in range(3)
            for b in range(3)
        ]
        new_t = [
            sum(r[3 * a + k][:, None, :] * (scale * disp[k])[:, None]
                for k in range(3))
            + t[a][:, None, :]
            for a in range(3)
        ]
        lo9 = lo[:, None, :] * 9 + j9
        carry = torch.div(lo9, _POW7, rounding_mode="floor")
        lo = lo9 - carry * _POW7
        hi = hi[:, None, :] * 9 + carry
        n9 = 9 * lo.shape[2]
        r = [x.reshape(x.shape[0], n9) for x in new_r]
        t = [x.reshape(x.shape[0], n9) for x in new_t]
        lo = lo.reshape(lo.shape[0], n9)
        hi = hi.reshape(hi.shape[0], n9)
        live = live[:, None, :].expand(-1, 9, -1).reshape(-1, n9)
        radius = radius * ratio
        live = cull(t, live, radius)
        # Compact wide levels before emission too, so the binning
        # stage's arrays stay <= global_cap per level.
        if n9 > cap:
            r, t, lo, hi, live, ovf = compact(r, t, lo, hi, live)
            overflow = overflow + ovf
        emit(t, lo, hi, live, radius)

    nodes = {k: torch.cat([x.expand(nb, x.shape[1]) for x in v], dim=1)
             for k, v in out.items()}
    if not batched:
        return {k: v[0] for k, v in nodes.items()}, overflow[0]
    return nodes, overflow


def corner_basis(cam, width: int, height: int):
    """Rows of M^-1 for the corner-ray basis: a camera-relative point c
    projects to screen uv' = (s0/s2, s1/s2) with s = M^-1 c, where
    M = [TR-TL | BL-TL | TL-origin] (`Sphereflake.cpp:162-167`).

    The inverse is the closed-form adjugate over the determinant (cross
    products of M's columns): no solver library, no synchronisation.
    It rounds differently from an LU inverse by a few ulps, which the
    conservative tile ranges built on it absorb."""
    from sphereflake_tpu_torch.camera import corner_rays

    origin, tl, tr, bl = corner_rays(cam, width / height)
    a, b, c = tr - tl, bl - tl, tl - origin  # columns of M
    bc = torch.linalg.cross(b, c)
    ca = torch.linalg.cross(c, a)
    ab = torch.linalg.cross(a, b)
    det = torch.sum(a * bc)
    return torch.stack([bc, ca, ab]) / det  # [3, 3], rows of M^-1


def bin_geometry(nodes, minv, cfg: RenderConfig, frame=None, corners=None):
    """Per-node screen-space geometry of the pair fill (all elementwise
    — no scatters/sorts): conservative tile ranges from interval
    arithmetic in the corner-ray basis, the behind-camera cull, and
    the pair-slot layout (counts / first / n_pairs).

    Nodes of B blocks at once ([B, N] arrays, from a batched
    `expand_global`) take `corners` [B, 4, 3] and a frame whose y_off is
    a [B, 1] tensor; each block's geometry equals its own call's."""
    pair_cap = cfg.pair_cap
    tw, th = cfg.tile_w, cfg.tile_h
    tx_n, ty_n = cfg.tiles_x, cfg.tiles_y
    frame_w, frame_h, x_off, y_off = (
        frame if frame is not None else (cfg.width, cfg.height, 0.0, 0.0)
    )
    # NDC scale: uv' of 1.0 = frame_w pixels (original dims); the block
    # offset shifts pixel coords into block-local tile units.
    sx = frame_w / tw
    sy = frame_h / th
    ox = x_off / tw
    oy = y_off / th

    c = [nodes["cx"], nodes["cy"], nodes["cz"]]
    # Binning radius = 2r (the C++ app's bounding radius), NOT the self
    # radius r, even though only self-hits are tested: the f32 kernel's
    # disc = tca^2 + (r^2 - |c|^2) suffers catastrophic cancellation,
    # so rays slightly OUTSIDE the exact r-sphere can still register
    # tangent "hits". The extra r of margin keeps those grazes
    # deterministic across band layouts.
    rad = nodes["rad"]
    s = [
        minv[k, 0] * c[0] + minv[k, 1] * c[1] + minv[k, 2] * c[2]
        for k in range(3)
    ]
    mnorm = [torch.sqrt(torch.sum(minv[k] * minv[k])) for k in range(3)]
    ds = [mnorm[k] * rad for k in range(3)]

    # Interval arithmetic on u' = s0/s2, v' = s1/s2 over the sphere.
    s2_lo = s[2] - ds[2]
    s2_hi = s[2] + ds[2]
    front = s2_lo > 0.0  # safely in front of the camera plane

    def ratio_bounds(num, dnum):
        n_lo, n_hi = num - dnum, num + dnum
        cands = [
            n_lo / s2_lo, n_lo / s2_hi, n_hi / s2_lo, n_hi / s2_hi
        ]
        return (
            torch.minimum(torch.minimum(cands[0], cands[1]),
                          torch.minimum(cands[2], cands[3])),
            torch.maximum(torch.maximum(cands[0], cands[1]),
                          torch.maximum(cands[2], cands[3])),
        )

    u_lo, u_hi = ratio_bounds(s[0], ds[0])
    v_lo, v_hi = ratio_bounds(s[1], ds[1])

    def tile_index(x, n):
        # Clamp in float BEFORE the int cast: the ratios are inf/nan for
        # nodes that are not `front` (masked below), and a float->int
        # cast of those is undefined.
        return torch.clamp(torch.floor(x), 0, n - 1).to(torch.int32)

    # Tile ranges (conservative; behind-camera nodes take everything).
    tx0 = tile_index(u_lo * sx - ox, tx_n)
    tx1 = tile_index(u_hi * sx - ox, tx_n)
    ty0 = tile_index(v_lo * sy - oy, ty_n)
    ty1 = tile_index(v_hi * sy - oy, ty_n)
    zero = torch.zeros_like(tx0)
    tx0 = torch.where(front, tx0, zero)
    ty0 = torch.where(front, ty0, zero)
    tx1 = torch.where(front, tx1, torch.full_like(tx1, tx_n - 1))
    ty1 = torch.where(front, ty1, torch.full_like(ty1, ty_n - 1))
    bw = tx1 - tx0 + 1
    keep = nodes["live"]
    if corners is not None:
        cd = torch.full_like(c[0], -1.0)
        for i in range(4):
            cd = torch.maximum(
                cd,
                corners[..., i, 0, None] * c[0]
                + corners[..., i, 1, None] * c[1]
                + corners[..., i, 2, None] * c[2],
            )
        keep = keep & (cd >= 0.0)
    counts = torch.where(keep, bw * (ty1 - ty0 + 1), zero)

    offsets = torch.cumsum(counts, dim=-1, dtype=torch.int32)  # inclusive
    n_pairs = offsets[..., -1]
    pair_overflow = torch.clamp_min(n_pairs - pair_cap, 0)

    first = offsets - counts
    n_nodes = counts.shape[-1]
    return dict(
        tx0=tx0, ty0=ty0, bw=bw, counts=counts, first=first,
        n_pairs=n_pairs, n_nodes=n_nodes, pair_overflow=pair_overflow,
    )


def _decode_tiles_window(geo, cfg: RenderConfig, lo: int, width: int):
    """Decode (tile, node) for pair slots [lo, lo + width) from the
    per-node geometry dict — the heart of the pair fill. `bin_nodes`
    calls it with the full window (lo=0, width=pair_cap).

    Node i owns the gapless slot range [first[i], first[i] + counts[i]),
    so the owner of slot p is found by one binary search of the
    inclusive offsets (the reference builds the same table with an
    out-of-bounds-dropping scatter and a running max; the result, slot
    for slot, is identical):

    - p < n_pairs: the node whose range holds p; the tile is that
      node's range origin advanced by the slot's rank within it;
    - p >= n_pairs: tile = n_tiles (the sentinel that sorts to the
      end), node = the last node that has a slot in the table (0 when
      there is none).
    """
    pair_cap = cfg.pair_cap
    tx_n, ty_n = cfg.tiles_x, cfg.tiles_y
    n_tiles = tx_n * ty_n
    n_nodes = geo["n_nodes"]
    first, counts = geo["first"], geo["counts"]
    tx0, ty0, bw = geo["tx0"], geo["ty0"], geo["bw"]
    n_pairs = geo["n_pairs"]
    dev = first.device
    assert pair_cap <= PAIR_CAP

    offsets = first + counts  # inclusive cumsum, non-decreasing
    iota_n = torch.arange(n_nodes, dtype=torch.int32, device=dev)
    iota_p = lo + torch.arange(width, dtype=torch.int32, device=dev)
    in_table = (counts > 0) & (first < pair_cap)
    last_node = torch.amax(
        torch.where(in_table, iota_n, torch.zeros_like(iota_n)),
        dim=-1, keepdim=True,
    )
    pair_valid = iota_p < n_pairs[..., None]  # offsets are gapless
    owner = torch.searchsorted(
        offsets, iota_p.expand(*offsets.shape[:-1], width).contiguous(),
        right=True, out_int32=True,
    )
    pair_node = torch.where(pair_valid, owner, last_node)

    node_l = pair_node.long()

    def of_node(x):
        return torch.gather(x, -1, node_l)

    pair_rank = iota_p - of_node(first)
    nb_w = of_node(bw)
    p_tx = of_node(tx0) + pair_rank % nb_w
    p_ty = of_node(ty0) + torch.div(pair_rank, nb_w, rounding_mode="floor")
    tile = torch.where(
        pair_valid,
        torch.clamp_max(p_ty * tx_n + p_tx, n_tiles),
        torch.full_like(p_tx, n_tiles),
    )
    return tile, pair_node


def _sort_pairs(tile, pair_node, n_nodes: int, n_tiles: int):
    """One sort into tile-segment order. Packed single key (tile <<
    node_bits | node) when both fit 31 bits; else a stable sort by tile
    carrying the node along."""
    node_bits = max(1, (n_nodes - 1).bit_length())
    tile_bits = (n_tiles + 1).bit_length()
    if node_bits + tile_bits <= 31:
        packed = (tile << node_bits) | pair_node
        packed = torch.sort(packed).values
        tile_sorted = packed >> node_bits
        node_sorted = packed & ((1 << node_bits) - 1)
    else:
        tile_sorted, order = torch.sort(tile, stable=True)
        node_sorted = torch.gather(pair_node, -1, order)
    return tile_sorted, node_sorted


def node_rows(nodes, cfg: RenderConfig):
    """The fat-rows node attribute matrix [7|8, N] the pair gather
    pulls from: every scalar the kernel's node loop consumes rides the
    pair table — (cx, cy, cz, rc = r2 - cc, code[, code_hi],
    lodr = lod^2*r, rc4 = 4r^2 - cc), 7 rows (8 from depth 7 on: level-7
    codes already spill their sentinel into the hi lane)."""
    deep_rows = cfg.max_depth >= 7
    lod_sq_f = float(np.float32(cfg.lod_factor) ** 2)
    cc_n = nodes["cc"]
    r2_n = nodes["r2"]
    row_list = [
        nodes["cx"], nodes["cy"], nodes["cz"],
        r2_n - cc_n,
        nodes["code"].to(torch.float32),
    ]
    if deep_rows:
        row_list.append(nodes["code_hi"].to(torch.float32))
    row_list.append(lod_sq_f * torch.sqrt(torch.clamp_min(r2_n, 0.0)))
    row_list.append(4.0 * r2_n - cc_n)
    return torch.stack(row_list, dim=-2)


def bin_nodes(nodes, minv, cfg: RenderConfig, frame=None, corners=None):
    """Conservative (node, tile) pairing + one sort into tile segments.

    `frame` = (frame_w, frame_h, x_off, y_off) describes the full image
    this cfg's block is cut from (a band is a y-offset block of the
    frame whose corner-ray basis `minv` was built from). Defaults to
    the identity (cfg.width, cfg.height, 0, 0).

    `corners` = [4, 3] frame corner-ray directions (unnormalized is
    fine). When given, nodes BEHIND every corner ray are dropped: the
    kernel rejects tca = dot(c, dir) < 0, and tca is linear in dir over
    the frustum, so max_i dot(c, corner_i) < 0 proves no frame ray can
    hit the node. Without this cull, behind-camera nodes take the
    ENTIRE tile grid (the conservative straddle fallback).

    Returns (pairs [7|8, cfg.pair_cap], starts [T], lens [T], (n_pairs,
    pair_overflow)); for the nodes of B blocks (`bin_geometry`), each
    with a leading [B]."""
    pair_cap = cfg.pair_cap
    n_tiles = cfg.tiles_x * cfg.tiles_y
    geo = bin_geometry(nodes, minv, cfg, frame=frame, corners=corners)
    n_pairs, pair_overflow = geo["n_pairs"], geo["pair_overflow"]
    n_nodes = geo["n_nodes"]
    tile, pair_node = _decode_tiles_window(geo, cfg, 0, pair_cap)
    tile_sorted, node_sorted = _sort_pairs(tile, pair_node, n_nodes, n_tiles)
    rows = node_rows(nodes, cfg)  # [7|8, N]
    pairs = torch.gather(  # [R, pair_cap]
        rows, -1,
        node_sorted.long()[..., None, :].expand(*rows.shape[:-1], pair_cap),
    )
    # Dead pairs (tile == n_tiles) sit at the end; starts/lens ignore
    # them, but stamp rc = -BIG defensively (disc = tca^2 + rc can then
    # never reach 0) so no ray test can ever pass on them.
    dead = tile_sorted >= n_tiles
    rc = pairs[..., 3, :]
    pairs[..., 3, :] = torch.where(dead, torch.full_like(rc, -_BIG), rc)

    bounds = torch.searchsorted(
        tile_sorted,
        torch.arange(n_tiles + 1, dtype=torch.int32, device=tile_sorted.device)
        .expand(*tile_sorted.shape[:-1], n_tiles + 1).contiguous(),
        out_int32=True,
    )
    starts, lens = bounds[..., :-1], bounds[..., 1:] - bounds[..., :-1]
    return pairs, starts.contiguous(), lens.contiguous(), (
        n_pairs, pair_overflow
    )


# --------------------------------------------------------------------
# The pairs kernel (`csrc/pairs_kernel.cu`) in its three launch modes —
# full tile grid, tile subset, ray bundles — each with its plain torch
# version, its CUDA launch and its wrapper.
# --------------------------------------------------------------------


def _tile_raygen(cam, tid, cfg: RenderConfig):
    """Unit ray directions (dx, dy, dz), each [len(tid), 1024], of the
    frame tiles `tid` from the 16-scalar camera pack — the kernel's
    in-kernel raygen, same association order."""
    tile_w, tile_h, tiles_x = cfg.tile_w, cfg.tile_h, cfg.tiles_x
    assert tile_w & (tile_w - 1) == 0 and tile_w * tile_h == _RAYS
    flat = torch.arange(_RAYS, dtype=torch.int32, device=tid.device)
    col = flat & (tile_w - 1)
    row = flat >> (tile_w.bit_length() - 1)
    txs = tid % tiles_x
    tys = torch.div(tid, tiles_x, rounding_mode="floor")
    fpx = (txs[:, None] * tile_w + col[None, :]).to(torch.float32)
    fpy = (tys[:, None] * tile_h + row[None, :]).to(torch.float32)
    u = (fpx + cam[12]) / cam[14]
    v = (fpy + cam[13]) / cam[15]
    dx = (cam[0] + (cam[3] * u + cam[6] * v)) - cam[9]
    dy = (cam[1] + (cam[4] * u + cam[7] * v)) - cam[10]
    dz = (cam[2] + (cam[5] * u + cam[8] * v)) - cam[11]
    dnorm = torch.sqrt(dx * dx + dy * dy + dz * dz)
    return dx / dnorm, dy / dnorm, dz / dnorm


def _walk_pairs(dx, dy, dz, pairs, row_start, row_len, deep: bool,
                codes: bool = True):
    """The kernel's loop, shared by the three plain versions: rays
    [N, 1024] (dx, dy, dz) against the segment
    pairs[:, row_start[n] : row_start[n] + row_len[n]] of their row n,
    vectorised over [N, 1024] with a loop over the segment position k,
    in the kernel's association order and with its tie rule (winner =
    smallest (ts, k mod 8, k)). Returns the winner (bt, blo, bhi, bcx,
    bcy, bcz), each [N, 1024]: bt stays BIG and the rest 0 where no
    candidate passed; blo / bhi stay 0 without `codes` (bhi also when
    not `deep`). Reads max(row_len) back to the host."""
    n_rows, n_cols = dx.shape[0], pairs.shape[1]
    dev = pairs.device
    zero = torch.zeros((n_rows, _RAYS), dtype=torch.float32, device=dev)
    bt = torch.full_like(zero, _BIG)
    blo, bhi = zero, zero
    bcx, bcy, bcz = zero, zero, zero
    bk7 = torch.zeros((n_rows, _RAYS), dtype=torch.int32, device=dev)
    r_lodr, r_rc4 = (6, 7) if deep else (5, 6)
    starts_l = row_start.long()

    k_max = int(row_len.max()) if n_rows else 0
    for k in range(k_max):
        in_seg = (k < row_len)[:, None]  # [N, 1]
        cols = pairs[:, torch.clamp_max(starts_l + k, n_cols - 1)]  # [R, N]
        cx, cy, cz = cols[0][:, None], cols[1][:, None], cols[2][:, None]
        rc = cols[3][:, None]
        lodr = cols[r_lodr][:, None]
        rc4 = cols[r_rc4][:, None]
        tca = dx * cx + dy * cy + dz * cz
        t2 = tca * tca
        disc = t2 + rc
        c1p = torch.clamp_min(tca - lodr, 0.0)
        ok = in_seg & (tca >= 0.0) & (c1p * c1p < t2 + rc4) & (disc >= 0.0)
        ts = tca - torch.sqrt(torch.clamp_min(disc, 0.0))
        better = ok & ((ts < bt) | ((ts == bt) & ((k & 7) < bk7)))
        bt = torch.where(better, ts, bt)
        bk7 = torch.where(better, torch.full_like(bk7, k & 7), bk7)
        if codes:
            blo = torch.where(better, cols[4][:, None], blo)
            if deep:
                bhi = torch.where(better, cols[5][:, None], bhi)
        bcx = torch.where(better, cx, bcx)
        bcy = torch.where(better, cy, bcy)
        bcz = torch.where(better, cz, bcz)
    return bt, blo, bhi, bcx, bcy, bcz


# The item walk of the pair kernel (all three modes), in plain pieces: the
# kernel cuts a span into items of at most `ITEM_PAIRS` pairs, walks
# each item keeping one key (ts, k) per ray, merges the items' keys by
# minimum and reads the winner's column once. The same three steps in
# eager ops, for the tests; no main path runs them.

# Low word of a key: k mod 8 in bits 31..29, k in bits 28..0; all ones
# means "no candidate", so the largest k must stay below 2^29 - 1.
_KEY_K_BITS = 29
MAX_KEYED_PAIR_CAP = (1 << _KEY_K_BITS) - 1
_EMPTY_KEY = torch.iinfo(torch.int64).max
# Pairs per work item: `kItemLen` of csrc/item_walk.cuh (the traversal
# kernel's items are as long).
ITEM_PAIRS = 64


def _ordered_key(ts, low):
    """int64 keys whose (signed) order is the order of (ts, low), `low`
    a tie-break word below 2^32 - 1: the order-preserving image of
    `ts`'s f32 bits in the high word (-0.0 packed as +0.0, as `==` ties
    them), `low` in the low word. The kernels (`csrc/item_walk.cuh:
    pack_key`) pack the same bits into an unsigned 64-bit word; this
    one has the top bit flipped, so that int64's order is that word's
    unsigned order and `_EMPTY_KEY` its all-ones."""
    bits = ts.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = torch.where(bits == 0x80000000, torch.zeros_like(bits), bits)
    ordered = torch.where(
        bits >= 0x80000000, 0xFFFFFFFF - bits, bits + 0x80000000
    )
    low = torch.as_tensor(low, dtype=torch.int64, device=ts.device)
    return ((ordered - 0x80000000) << 32) | low


def _winner_key(ts, k):
    """The pair kernel's key (`_ordered_key`): its order is the order of
    (ts, k mod 8, k), with k mod 8 then k in the low word."""
    k = torch.as_tensor(k, dtype=torch.int64, device=ts.device)
    return _ordered_key(ts, ((k & 7) << _KEY_K_BITS) | k)


def _walk_keys(dx, dy, dz, pairs, row_start, row_len, deep: bool,
               k_first=0, k_count=None):
    """The kernel's code-free walk over positions
    [k_first, k_first + k_count) of every row's span (the whole span by
    default): per ray the smallest key (`_winner_key`) among the
    candidates that pass, `_EMPTY_KEY` where none does. [N, 1024] int64.
    Reads max(row_len) back to the host."""
    n_rows, n_cols = dx.shape[0], pairs.shape[1]
    best = torch.full((n_rows, _RAYS), _EMPTY_KEY, dtype=torch.int64,
                      device=pairs.device)
    r_lodr, r_rc4 = (6, 7) if deep else (5, 6)
    starts_l = row_start.long()
    k_max = int(row_len.max()) if n_rows else 0
    if k_count is not None:
        k_max = min(k_max, k_first + k_count)
    for k in range(k_first, k_max):
        in_seg = (k < row_len)[:, None]
        cols = pairs[:, torch.clamp_max(starts_l + k, n_cols - 1)]
        cx, cy, cz = cols[0][:, None], cols[1][:, None], cols[2][:, None]
        rc = cols[3][:, None]
        lodr = cols[r_lodr][:, None]
        rc4 = cols[r_rc4][:, None]
        tca = dx * cx + dy * cy + dz * cz
        t2 = tca * tca
        disc = t2 + rc
        c1p = torch.clamp_min(tca - lodr, 0.0)
        ok = in_seg & (tca >= 0.0) & (c1p * c1p < t2 + rc4) & (disc >= 0.0)
        ts = tca - torch.sqrt(torch.clamp_min(disc, 0.0))
        key = torch.where(ok, _winner_key(ts, k), best)
        best = torch.minimum(best, key)
    return best


def _winner_from_keys(keys, dx, dy, dz, pairs, row_start, deep: bool,
                      codes: bool = True):
    """The kernel's finish: the winner (bt, blo, bhi, bcx, bcy, bcz) of
    `_walk_pairs` from merged keys — k from the key's low word, the
    column pairs[:, start + k] read once per ray, ts recomputed from it
    by the walk's own expression (so a -0.0 keeps its sign)."""
    none = keys == _EMPTY_KEY
    k = keys & ((1 << _KEY_K_BITS) - 1)
    col = torch.clamp_max(row_start.long()[:, None] + k, pairs.shape[1] - 1)
    zero = torch.zeros(keys.shape, dtype=torch.float32, device=keys.device)
    pick = lambda r: torch.where(none, zero, pairs[r][col])
    cx, cy, cz = pairs[0][col], pairs[1][col], pairs[2][col]
    tca = dx * cx + dy * cy + dz * cz
    t2 = tca * tca
    disc = t2 + pairs[3][col]
    ts = tca - torch.sqrt(torch.clamp_min(disc, 0.0))
    bt = torch.where(none, torch.full_like(zero, _BIG), ts)
    blo = pick(4) if codes else zero
    bhi = pick(5) if codes and deep else zero
    return bt, blo, bhi, pick(0), pick(1), pick(2)


def _walk_pairs_split(dx, dy, dz, pairs, row_start, row_len, deep: bool,
                      item_pairs: int, codes: bool = True):
    """`_walk_pairs` the way the item kernels take it: every span cut
    into items of `item_pairs` pairs, each walked on its own
    (`_walk_keys`), the keys merged by minimum — in reverse order here:
    any order gives the same keys — and the winner read back
    (`_winner_from_keys`)."""
    k_max = int(row_len.max()) if dx.shape[0] else 0
    merged = torch.full(dx.shape, _EMPTY_KEY, dtype=torch.int64,
                        device=pairs.device)
    for k_first in reversed(range(0, k_max, item_pairs)):
        merged = torch.minimum(merged, _walk_keys(
            dx, dy, dz, pairs, row_start, row_len, deep, k_first, item_pairs
        ))
    return _winner_from_keys(
        merged, dx, dy, dz, pairs, row_start, deep, codes=codes
    )


def _shade_rows(dx, dy, dz, winner, deep: bool, shade_only: bool = False):
    """The kernel's G-buffer epilogue: [N, C, 8, 128] rows (min_t,
    code_lo[, code_hi], pos3, nrm3) of the winner — or, with
    `shade_only`, (min_t, pos3, nrm3) where a hit is "some candidate
    beat the BIG init" and min_t is the accumulator itself."""
    bt, blo, bhi, bcx, bcy, bcz = winner
    zero = torch.zeros_like(bt)
    if shade_only:
        hit = bt < 0.5 * _BIG
    else:
        hit = blo >= 1.0
        if deep:
            hit = hit | (bhi >= 1.0)
    t0 = torch.where(hit, bt, zero)
    px, py, pz = dx * t0, dy * t0, dz * t0
    wx, wy, wz = px - bcx, py - bcy, pz - bcz
    nn = torch.sqrt(torch.clamp_min(wx * wx + wy * wy + wz * wz, 0.0))
    nn = torch.where(nn > 0.0, nn, torch.ones_like(nn))
    hf = hit.to(torch.float32)
    if shade_only:
        rows = [bt]
    else:
        rows = [torch.where(hit, bt, torch.full_like(bt, _BIG)), blo]
        if deep:
            rows.append(bhi)
    rows += [px, py, pz, hf * (wx / nn), hf * (wy / nn), hf * (wz / nn)]
    return torch.stack(rows, dim=1).reshape(bt.shape[0], len(rows), 8, 128)


def _length_metrics(row_len):
    """metrics [N, 1, 4] int32: column 0 is the segment length, the
    rest 0 (a chunked walk drops nothing)."""
    metrics = torch.zeros(
        (row_len.shape[0], 1, 4), dtype=torch.int32, device=row_len.device
    )
    metrics[:, 0, 0] = row_len
    return metrics


def trace_pairs_fused_plain(cam, pairs, starts, lens, cfg: RenderConfig):
    """Plain torch version of the fused kernel's full-grid mode — the
    same function as `csrc/pairs_kernel.cu` in eager ops (`_walk_pairs`).
    The CPU tests use it, and the kernel is held against it on the
    card; it reads max(lens) back to the host, so it is not a
    frame-path function. Returns (out [T, 8|9, 8, 128], metrics
    [T, 1, 4])."""
    T = cfg.tiles_y * cfg.tiles_x
    deep = cfg.max_depth >= 7
    tid = torch.arange(T, dtype=torch.int32, device=pairs.device)
    dx, dy, dz = _tile_raygen(cam, tid, cfg)
    winner = _walk_pairs(dx, dy, dz, pairs, starts, lens, deep)
    return _shade_rows(dx, dy, dz, winner, deep), _length_metrics(lens)


def trace_pairs_fused_subset_plain(cam, pairs, starts, lens, tile_ids,
                                   cfg: RenderConfig,
                                   shade_only: bool = False):
    """Plain torch version of the kernel's subset mode: row k holds
    frame tile `tile_ids[k]`, whose segment comes from the full-frame
    `starts` / `lens`. Returns (out [K, 7 | 8|9, 8, 128], metrics
    [K, 1, 4]); with `shade_only` the 7 rows are (min_t, pos3, nrm3)."""
    deep = cfg.max_depth >= 7
    ids = tile_ids.long()
    row_start, row_len = starts[ids], lens[ids]
    dx, dy, dz = _tile_raygen(cam, tile_ids, cfg)
    winner = _walk_pairs(
        dx, dy, dz, pairs, row_start, row_len, deep, codes=not shade_only
    )
    return (
        _shade_rows(dx, dy, dz, winner, deep, shade_only=shade_only),
        _length_metrics(row_len),
    )


def trace_pairs_pallas_soa_plain(dirs_k, pairs, starts, lens,
                                 cfg: RenderConfig):
    """Plain torch version of the kernel's ray-bundle mode: bundle b's
    1024 rays dirs_k[b] ([3, 8, 128]) against the span
    pairs[:, starts[b] : starts[b] + lens[b]]. Returns the raw winner
    (out [B, 5|6, 8, 128] = (t, code_lo[, code_hi], cx, cy, cz),
    metrics [B, 1, 4])."""
    B = dirs_k.shape[0]
    deep = cfg.max_depth >= 7
    d = dirs_k.reshape(B, 3, _RAYS)
    bt, blo, bhi, bcx, bcy, bcz = _walk_pairs(
        d[:, 0], d[:, 1], d[:, 2], pairs, starts, lens, deep
    )
    rows = [bt, blo] + ([bhi] if deep else []) + [bcx, bcy, bcz]
    out = torch.stack(rows, dim=1).reshape(B, len(rows), 8, 128)
    return out, _length_metrics(lens)


def _check_kernel_inputs(cam, pairs, starts, lens, cfg: RenderConfig,
                         tile_ids=None):
    """Raise on anything the fused (raygen) modes do not take."""
    T = cfg.tiles_y * cfg.tiles_x
    n_rows = 8 if cfg.max_depth >= 7 else 7
    tile_w = cfg.tile_w
    if tile_w & (tile_w - 1) or tile_w * cfg.tile_h != _RAYS:
        raise ValueError(
            f"tile {cfg.tile_h}x{tile_w}: tile_w must be a power of two "
            f"and tile_h * tile_w == {_RAYS}"
        )
    specs = [
        ("cam", cam, torch.float32, (16,)),
        ("pairs", pairs, torch.float32, (n_rows, None)),
        ("starts", starts, torch.int32, (T,)),
        ("lens", lens, torch.int32, (T,)),
    ]
    if tile_ids is not None:
        specs.append(("tile_ids", tile_ids, torch.int32, (None,)))
    kernels.check_tensors(specs, pairs, "pairs")


def _launch_pairs_kernel(cam, pairs, starts, lens, cfg: RenderConfig):
    """Enqueue the full-grid mode of `csrc/pairs_kernel.cu` (its
    prologue and its walk: one call, one count)."""
    fn = kernels.entry_point("pairs_kernel", "sf_trace_pairs_fused", 8, 6)
    T = cfg.tiles_y * cfg.tiles_x
    deep = cfg.max_depth >= 7
    dev = pairs.device
    out = torch.empty((T, 9 if deep else 8, 8, 128), dtype=torch.float32,
                      device=dev)
    metrics = torch.empty((T, 1, 4), dtype=torch.int32, device=dev)
    kernels.enqueue(
        fn, "pairs_kernel (full)",
        (cam, pairs, starts, lens, out, metrics, *_item_scratch(T, dev)),
        (T, pairs.shape[1], cfg.tile_w.bit_length() - 1, cfg.tile_h,
         cfg.tiles_x, int(deep)),
        dev,
    )
    trace_pairs_fused_soa.launches += 1
    return out, metrics


def trace_pairs_fused_soa(
    cam: torch.Tensor,  # [16] f32: tl(3), ex(3), ey(3), origin(3), x_off,
    # y_off, frame_w, frame_h
    pairs: torch.Tensor,  # [7|8, cfg.pair_cap] f32
    starts: torch.Tensor,  # [T] int32
    lens: torch.Tensor,  # [T] int32
    cfg: RenderConfig,
):
    """The fused production kernel: raygen + ray tests + G-buffer
    shading in ONE walk launch behind a small prologue launch (no
    ray-direction array ever exists in device memory). Returns (out [T, C, 8, 128], metrics [T, 1, 4]) with rows
    (min_t, code_lo[, code_hi], px, py, pz, nx, ny, nz): C = 9 when
    cfg.max_depth >= 7, else 8. min_t is BIG at sky; pos/nrm are zeros
    at sky. metrics column 0 is the tile's segment length.

    CUDA tensors launch the hand-written kernel (or raise); CPU tensors
    run the plain version. Launches on the current stream, never
    synchronises. A pair table wider than `MAX_KEYED_PAIR_CAP` columns
    raises (the kernel's merge key). `trace_pairs_fused_soa.launches`
    counts calls that launched."""
    _check_kernel_inputs(cam, pairs, starts, lens, cfg)
    _check_keyed_pair_cap(pairs.shape[1])
    if pairs.device.type == "cuda":
        return _launch_pairs_kernel(cam, pairs, starts, lens, cfg)
    return trace_pairs_fused_plain(cam, pairs, starts, lens, cfg)


trace_pairs_fused_soa.launches = 0


def _check_keyed_pair_cap(pair_cap: int):
    """The kernel merges on a key whose low word holds k in
    `_KEY_K_BITS` bits, all ones meaning "no candidate"."""
    if pair_cap > MAX_KEYED_PAIR_CAP:
        raise ValueError(
            f"pair table of {pair_cap} columns: the pair kernel takes at "
            f"most {MAX_KEYED_PAIR_CAP} (a span position must "
            f"fit the {_KEY_K_BITS}-bit field of the merge key)"
        )


def _item_scratch(n_rows: int, dev):
    """(keys [n_rows, 1024] int64, work [8 * n_rows + 8] int32) for one
    item launch: sized by shapes only, written before read on the card."""
    return (
        torch.empty((n_rows, _RAYS), dtype=torch.int64, device=dev),
        torch.empty((8 * n_rows + 8,), dtype=torch.int32, device=dev),
    )


def _launch_subset_kernel(cam, pairs, starts, lens, tile_ids,
                          cfg: RenderConfig, shade_only: bool):
    """Enqueue the subset mode of `csrc/pairs_kernel.cu` (its prologue
    and its walk: one call, one count)."""
    K = tile_ids.shape[0]
    deep = cfg.max_depth >= 7
    n_out = 7 if shade_only else (9 if deep else 8)
    dev = pairs.device
    out = torch.empty((K, n_out, 8, 128), dtype=torch.float32, device=dev)
    metrics = torch.empty((K, 1, 4), dtype=torch.int32, device=dev)
    if K == 0:
        return out, metrics
    fn = kernels.entry_point(
        "pairs_kernel", "sf_trace_pairs_fused_subset", 9, 7
    )
    kernels.enqueue(
        fn, "pairs_kernel (subset)",
        (cam, pairs, starts, lens, tile_ids, out, metrics,
         *_item_scratch(K, dev)),
        (K, pairs.shape[1], cfg.tile_w.bit_length() - 1, cfg.tile_h,
         cfg.tiles_x, int(deep), int(shade_only)),
        dev,
    )
    trace_pairs_fused_subset.launches += 1
    return out, metrics


def trace_pairs_fused_subset(
    cam: torch.Tensor,  # [16] f32 camera pack (`camera_vector`)
    pairs: torch.Tensor,  # [7|8, cfg.pair_cap] f32
    starts: torch.Tensor,  # [T] int32 — FULL frame segment table
    lens: torch.Tensor,  # [T] int32
    tile_ids: torch.Tensor,  # [K] int32 frame tile ids to render
    cfg: RenderConfig,
    shade_only: bool = False,
):
    """Fused raygen+trace+shade for an arbitrary SUBSET of the frame's
    tiles — the frameless refresh unit: whole 1024-ray tiles are
    refreshed the way the C++ app refreshes 8-ray packets. Row k of the
    output renders frame tile `tile_ids[k]`; starts/lens stay the
    full-frame tables; ids may repeat and come in any order. Returns
    (out [K, C, 8, 128], metrics [K, 1, 4]) with the rows of
    `trace_pairs_fused_soa` — or, with `shade_only`, exactly 7 rows
    (min_t, pos3, nrm3; min_t is BIG at sky): the code rows are neither
    read nor accumulated, for callers that never read codes.

    Every id must lie in [0, T): that is the caller's contract (an id
    outside reads outside the tables). CUDA tensors launch the
    hand-written kernel (or raise); CPU tensors run the plain version.
    K = 0 returns empty outputs without a launch. A pair table wider
    than `MAX_KEYED_PAIR_CAP` columns raises (the kernel's merge key).
    `trace_pairs_fused_subset.launches` counts calls that launched."""
    _check_kernel_inputs(cam, pairs, starts, lens, cfg, tile_ids=tile_ids)
    _check_keyed_pair_cap(pairs.shape[1])
    if pairs.device.type == "cuda":
        return _launch_subset_kernel(
            cam, pairs, starts, lens, tile_ids, cfg, shade_only
        )
    return trace_pairs_fused_subset_plain(
        cam, pairs, starts, lens, tile_ids, cfg, shade_only=shade_only
    )


trace_pairs_fused_subset.launches = 0


def _launch_dirs_kernel(dirs_k, pairs, starts, lens, cfg: RenderConfig):
    """Enqueue the ray-bundle mode of `csrc/pairs_kernel.cu` (its
    prologue and its walk: one call, one count)."""
    B = dirs_k.shape[0]
    deep = cfg.max_depth >= 7
    dev = pairs.device
    out = torch.empty((B, 6 if deep else 5, 8, 128), dtype=torch.float32,
                      device=dev)
    metrics = torch.empty((B, 1, 4), dtype=torch.int32, device=dev)
    if B == 0:
        return out, metrics
    if dirs_k.data_ptr() % 16:
        dirs_k = dirs_k.clone()  # the kernel loads four rays at a time
    fn = kernels.entry_point("pairs_kernel", "sf_trace_pairs_dirs", 8, 3)
    kernels.enqueue(
        fn, "pairs_kernel (dirs)",
        (dirs_k, pairs, starts, lens, out, metrics, *_item_scratch(B, dev)),
        (B, pairs.shape[1], int(deep)), dev,
    )
    trace_pairs_pallas_soa.launches += 1
    return out, metrics


def trace_pairs_pallas_soa(
    dirs_k: torch.Tensor,  # [B, 3, 8, 128] f32 unit directions, ray-major
    pairs: torch.Tensor,  # [7|8, cfg.pair_cap] f32
    starts: torch.Tensor,  # [B] int32 per-bundle span starts
    lens: torch.Tensor,  # [B] int32 per-bundle span lengths
    cfg: RenderConfig,
):
    """Ray tests of 1024-ray bundles against spans of the pair table,
    directions given (the sample-granular frameless mode: bundles of
    tile-sorted Sobol pixels, each against the union of the segments of
    the tiles it touches). Returns (out [B, C, 8, 128], metrics
    [B, 1, 4]) with the raw winner rows (t, code_lo[, code_hi], cx, cy,
    cz): C = 6 when cfg.max_depth >= 7, else 5; t stays BIG and the
    rest 0 where no candidate passed. The name is the reference
    package's (its kernel is written in Pallas).

    CUDA tensors launch the hand-written kernel (or raise); CPU tensors
    run the plain version. B = 0 returns empty outputs without a
    launch. A pair table wider than `MAX_KEYED_PAIR_CAP` columns raises
    (the kernel's merge key). `trace_pairs_pallas_soa.launches` counts
    calls that launched."""
    n_rows = 8 if cfg.max_depth >= 7 else 7
    B = dirs_k.shape[0] if isinstance(dirs_k, torch.Tensor) else None
    kernels.check_tensors(
        [
            ("dirs_k", dirs_k, torch.float32, (None, 3, 8, 128)),
            ("pairs", pairs, torch.float32, (n_rows, None)),
            ("starts", starts, torch.int32, (B,)),
            ("lens", lens, torch.int32, (B,)),
        ],
        pairs, "pairs",
    )
    _check_keyed_pair_cap(pairs.shape[1])
    if pairs.device.type == "cuda":
        return _launch_dirs_kernel(dirs_k, pairs, starts, lens, cfg)
    return trace_pairs_pallas_soa_plain(dirs_k, pairs, starts, lens, cfg)


trace_pairs_pallas_soa.launches = 0


def trace_pairs_pallas(tile_dirs, pairs, starts, lens, cfg: RenderConfig):
    """Per-bundle ray tests against pair-table spans (AoS directions
    wrapper over `trace_pairs_pallas_soa`): tile_dirs [B, 1024, 3].
    Returns (min_t [B, 1024], code_lo [B, 1024], code_hi [B, 1024] or
    None, metrics [B, 1, 4]); the winner's centre rows are dropped."""
    B, rays, _ = tile_dirs.shape
    assert rays == _RAYS
    dirs_k = torch.movedim(tile_dirs, 2, 1).reshape(B, 3, 8, 128).contiguous()
    out, metrics = trace_pairs_pallas_soa(dirs_k, pairs, starts, lens, cfg)
    deep = cfg.max_depth >= 7
    code_hi = out[:, 2].reshape(B, rays) if deep else None
    return (
        out[:, 0].reshape(B, rays),
        out[:, 1].reshape(B, rays),
        code_hi,
        metrics,
    )


def _block_planes(scene, cfg: RenderConfig, frame):
    """[4, 3] frustum planes of the block cfg describes at `frame` =
    (frame_w, frame_h, x_off, y_off): one "tile" = this whole block."""
    from sphereflake_tpu_torch.camera import tile_frustum_planes

    frame_w, frame_h, x_off, y_off = frame
    return tile_frustum_planes(
        scene.camera, frame_w, frame_h,
        cfg.padded_height, cfg.padded_width,
        x_off=x_off, y_off=y_off,
        block_h=cfg.padded_height, block_w=cfg.padded_width,
    )[0]


def _corner_hull(corner_rays, cfg: RenderConfig, frame_w, frame_h, x_off, ys):
    """The corner-ray directions [B, 4, 3] of the blocks at pixel rows
    `ys` ([B, 1] f32) (padded extent included: the padded rows/cols
    extrapolate the corner interpolation, so the hull must cover them
    for the behind-camera cull to be exact)."""
    origin, tl, tr, bl = corner_rays
    ex, ey = tr - tl, bl - tl
    f32 = lambda x: origin.new_tensor(float(x))
    u0 = f32(x_off) / f32(frame_w)
    u1 = (f32(x_off) + cfg.padded_width) / f32(frame_w)
    v0 = ys / f32(frame_h)
    v1 = (ys + cfg.padded_height) / f32(frame_h)
    base = tl - origin
    return torch.stack(
        [base + u * ex + v * ey for u in (u0, u1) for v in (v0, v1)], dim=-2
    )


def _expand_blocks(scene, cfg: RenderConfig, root, templates, frame, y_offs):
    """The replicated front of the bin for the blocks of one frame at
    pixel rows `y_offs`, all at once: the global expansion culled by
    each block's frustum, the corner-ray basis and each block's corner
    rays. `frame` = (frame_w, frame_h, x_off). Returns (nodes [B, N],
    expansion overflow [B], minv, corners [B, 4, 3], the rows as a
    [B, 1] tensor, the frame's `corner_rays`)."""
    from sphereflake_tpu_torch.camera import corner_rays

    frame_w, frame_h, x_off = frame
    planes = torch.stack([
        _block_planes(scene, cfg, (frame_w, frame_h, x_off, y))
        for y in y_offs
    ])
    nodes, exp_overflow = expand_global(
        root, templates, scene.fractal, cfg, planes
    )
    minv = corner_basis(scene.camera, frame_w, frame_h)
    rays = corner_rays(scene.camera, frame_w / frame_h)
    ys = rays[0].new_tensor([float(y) for y in y_offs])[:, None]
    corners = _corner_hull(rays, cfg, frame_w, frame_h, x_off, ys)
    return nodes, exp_overflow, minv, corners, ys, rays


def _bin_blocks(scene, cfg: RenderConfig, root, templates, frame, y_offs):
    """Expansion + binning of those blocks: (pairs, starts, lens,
    (n_pairs, overflow)), each with a leading [B], and the frame's
    `corner_rays`; overflow counts pair-table AND deep-level compaction
    drops."""
    with spans.span("gbuffer.expand"):
        nodes, exp_overflow, minv, corners, ys, rays = _expand_blocks(
            scene, cfg, root, templates, frame, y_offs
        )
    with spans.span("gbuffer.bin"):
        pairs, starts, lens, (n_pairs, pair_ovf) = bin_nodes(
            nodes, minv, cfg, frame=(*frame, ys), corners=corners
        )
    return (pairs, starts, lens, (n_pairs, pair_ovf + exp_overflow)), rays


def _camera_packs(rays, frame, y_offs):
    """The 16-scalar camera packs [B, 16] consumed by the fused kernel's
    raygen: [tl(3), ex(3), ey(3), origin(3), x_off, y_off, frame_w,
    frame_h] (`Sphereflake.cpp:162-167` corner parameterization), one a
    block at pixel rows `y_offs`; `rays` = the frame's `corner_rays`."""
    frame_w, frame_h, x_off = frame
    origin, tl, tr, bl = rays
    head = torch.cat([tl, tr - tl, bl - tl, origin])
    tails = origin.new_tensor([
        [float(x_off), float(y), float(frame_w), float(frame_h)]
        for y in y_offs
    ])
    return torch.cat([head.expand(len(y_offs), head.shape[0]), tails], dim=1)


def _one_block(cfg: RenderConfig, frame):
    """((frame_w, frame_h, x_off), [y_off]) of the one block at `frame`
    (cfg's whole image by default): the last arguments of
    `_expand_blocks`, `_bin_blocks` and `_camera_packs`."""
    frame_w, frame_h, x_off, y_off = (
        frame if frame is not None else (cfg.width, cfg.height, 0.0, 0.0)
    )
    return (frame_w, frame_h, x_off), [y_off]


def frame_nodes(scene, cfg: RenderConfig, root, templates, frame=None):
    """`_expand_blocks` of one block: (nodes, expansion overflow, minv,
    corners) — what `bin_nodes` takes, or `bin_geometry` and a windowed
    decode (the shared bin, `parallel/shared_bin.py`).

    `frame` = (frame_w, frame_h, x_off, y_off) when cfg describes one
    block (band) of a larger frame (see `bin_nodes`)."""
    nodes, exp_overflow, minv, corners, _ys, _rays = _expand_blocks(
        scene, cfg, root, templates, *_one_block(cfg, frame)
    )
    return ({k: v[0] for k, v in nodes.items()}, exp_overflow[0], minv,
            corners[0])


def binned_pairs(scene, cfg: RenderConfig, root, templates, frame=None):
    """`_bin_blocks` of one block: (pairs, starts, lens, (n_pairs,
    overflow)).

    `frame` = (frame_w, frame_h, x_off, y_off) when cfg describes one
    block (band) of a larger frame (see `bin_nodes`)."""
    (pairs, starts, lens, (n_pairs, overflow)), _rays = _bin_blocks(
        scene, cfg, root, templates, *_one_block(cfg, frame)
    )
    return pairs[0], starts[0], lens[0], (n_pairs[0], overflow[0])


def camera_vector(scene, cfg: RenderConfig, frame=None):
    """`_camera_packs` of one block: its [16] camera pack."""
    from sphereflake_tpu_torch.camera import corner_rays

    (frame_w, frame_h, x_off), ys = _one_block(cfg, frame)
    rays = corner_rays(scene.camera, frame_w / frame_h)
    return _camera_packs(rays, (frame_w, frame_h, x_off), ys)[0]


# The pair-table slots the fronts of one `band_fronts` call may hold
# together: 16 tables at the table's bound. A frame's bands share a call
# while their tables fit (all of a 4K frame's 4 bands and a 16384^2 mesh
# block's 32 at depth 8); where the capacity ladder has cut the bands
# to a tile row, each with a table of PAIR_CAP slots, a call holds 16
# of them, not every band's.
FRONT_SLOTS = 16 * PAIR_CAP


def front_groups(cfg: RenderConfig, y_offs):
    """`y_offs` cut into runs of nearly equal length, in order, for one
    `band_fronts` call each: as few runs as keep every run's pair tables
    (`cfg.pair_cap` slots a band) within `FRONT_SLOTS`, and at least one
    band a run."""
    n = len(y_offs)
    calls = -(-n // max(1, FRONT_SLOTS // cfg.pair_cap))
    return [y_offs[i * n // calls:(i + 1) * n // calls] for i in range(calls)]


def band_fronts(scene, cfg: RenderConfig, frame_w, frame_h, x_off, y_offs):
    """The fronts of the blocks of one frame at pixel rows `y_offs` (the
    bands of a block, `render.band_layout`, or a run of them,
    `front_groups`), made at once: expansion, binning and the camera
    packs, each op one launch for every block (`expand_global` over
    [B, 4, 3] planes, `bin_nodes` over its [B, N] nodes). The small
    uploads that wait for the card (a `new_tensor` synchronizes its
    stream) all come before the blocks' kernels are queued. Made from
    the leaves' values: no graph and no forward-mode tangent (a front is
    the kernel's input, never differentiated). Every block's pair table
    is held at once.

    Returns block b's front, (pairs, starts, lens, (n_pairs, overflow),
    camera pack), for each b: what `_gbuffer_primal` takes."""
    from sphereflake_tpu_torch.config import SceneParams
    from sphereflake_tpu_torch.models.sphereflake import (
        child_templates,
        root_frame,
    )

    scene = SceneParams.from_leaves([x.detach() for x in scene.leaves()])
    frame = (frame_w, frame_h, x_off)
    with spans.span("gbuffer.expand"):
        root = root_frame(scene.camera.position)
        templates = child_templates(scene.fractal)
    (pairs, starts, lens, (n_pairs, overflow)), rays = _bin_blocks(
        scene, cfg, root, templates, frame, y_offs
    )
    with spans.span("gbuffer.k1"):
        cams = _camera_packs(rays, frame, y_offs)
    return [(pairs[b], starts[b], lens[b], (n_pairs[b], overflow[b]), cams[b])
            for b in range(len(y_offs))]


def _gbuffer_primal(cfg: RenderConfig, front):
    """One block's forward from its front (an entry of `band_fronts`):
    ONE fused kernel call (raygen + binned ray tests + G-buffer
    shading)."""
    pairs, starts, lens, (_n, povf), cam = front
    with spans.span("gbuffer.k1"):
        out, m = trace_pairs_fused_soa(cam, pairs, starts, lens, cfg)
    deep = cfg.max_depth >= 7
    flat = lambda r: out[:, r].reshape(-1)
    min_t = flat(0)
    lo = flat(1)
    hi = flat(2) if deep else torch.zeros_like(lo)
    px, py, pz = flat(-6), flat(-5), flat(-4)
    nx, ny, nz = flat(-3), flat(-2), flat(-1)
    hit = ((lo >= 1.0) | (hi >= 1.0)).to(torch.float32)
    return (min_t, px, py, pz, nx, ny, nz, hit, lo, hi, m, povf)


def _band_rays(cfg: RenderConfig, frame_w, frame_h, scene, offs):
    """The block's unit ray directions (dx, dy, dz), each [T*1024], in
    the kernel's flat tile order: its raygen, differentiable in the
    camera."""
    from sphereflake_tpu_torch.camera import corner_rays
    from sphereflake_tpu_torch.render import _tile

    origin, tl, tr, bl = corner_rays(scene.camera, frame_w / frame_h)
    dev = origin.device
    ex, ey = tr - tl, bl - tl
    u = (
        torch.arange(cfg.padded_width, dtype=torch.float32, device=dev)[None, :]
        + float(offs[0])
    ) / origin.new_tensor(float(frame_w))
    v = (
        torch.arange(cfg.padded_height, dtype=torch.float32, device=dev)[:, None]
        + float(offs[1])
    ) / origin.new_tensor(float(frame_h))
    comps = [(tl[a] + (ex[a] * u + ey[a] * v)) - origin[a] for a in range(3)]
    dnorm = torch.sqrt(comps[0] ** 2 + comps[1] ** 2 + comps[2] ** 2)
    return tuple(_tile(c / dnorm, cfg).reshape(-1) for c in comps)


def _shade_codes(dx, dy, dz, lo, hi, root, templates, fractal, cfg):
    """The rays' winners re-derived from the (detached) path codes by
    `resolve_codes_soa`, then the shading: the 7 outputs (min_t, px, py,
    pz, nx, ny, nz), each [N]. The plain chain that
    `ops/recompute_vjp.py`'s kernel differentiates in one pass."""
    from sphereflake_tpu_torch.ops.intersect import safe_sqrt
    from sphereflake_tpu_torch.ops.pallas_traversal import resolve_codes_soa

    min_t, cx, cy, cz, hit = resolve_codes_soa(
        dx, dy, dz, lo, root, templates, fractal, cfg,
        code_hi_f=hi if cfg.max_depth >= 7 else None,
    )
    t0 = torch.where(hit, min_t, torch.zeros_like(min_t))
    px, py, pz = dx * t0, dy * t0, dz * t0
    wx, wy, wz = px - cx, py - cy, pz - cz
    nn = safe_sqrt(wx * wx + wy * wy + wz * wz)
    nn = torch.where(nn > 0, nn, torch.ones_like(nn))
    hf = hit.to(torch.float32)
    return (min_t, px, py, pz, hf * (wx / nn), hf * (wy / nn), hf * (wz / nn))


def _gbuffer_recompute(cfg: RenderConfig, frame_w, frame_h, scene, offs,
                       lo, hi):
    """The differentiable surface of one block, h(scene) of the
    reference's custom JVP: the block's raygen in the kernel's flat tile
    order (`_band_rays`), the winner re-derived from the (detached) path
    codes and the shading (`_shade_codes`). Returns the 7 differentiable
    outputs (min_t, px, py, pz, nx, ny, nz), each [T*1024]."""
    from sphereflake_tpu_torch.models.sphereflake import (
        child_templates,
        root_frame,
    )

    dx, dy, dz = _band_rays(cfg, frame_w, frame_h, scene, offs)
    root = root_frame(scene.camera.position)
    templates = child_templates(scene.fractal)
    return _shade_codes(dx, dy, dz, lo, hi, root, templates, scene.fractal,
                        cfg)


class BinnedGBuffer(torch.autograd.Function):
    """The reference's custom JVP of the binned block
    (`_gbuffer_primal` + `_gbuffer_jvp`) as an autograd Function over
    the scene's 15 leaves.

    forward: the kernel's primal over the block's front
    (`_gbuffer_primal`; the shared bin's subclass brings its own), with
    no graph; it saves the path codes and the leaves. backward: the
    straight-through gradient of the reference (the discrete winner is
    the kernel's, the distance and frame are re-derived): under grad it
    rebuilds the recompute's small differentiable front (the band's
    raygen, the root frame, the child templates, the level radii), takes
    the vector-Jacobian product of the rest (`_shade_codes`) from
    `ops/recompute_vjp.py:recompute_vjp` (one kernel a band on the card,
    its plain version on the CPU) and hands it to autograd over the
    front, into the leaves. jvp: `_gbuffer_recompute` in forward mode.
    hit, the codes, the metrics and the overflow are not
    differentiable; leaves that take no part (ssao) get no gradient."""

    @staticmethod
    def forward(statics, offs, *leaves):
        cfg, _frame_w, _frame_h, front = statics
        return _owned(_gbuffer_primal(cfg, front))

    @staticmethod
    def setup_context(ctx, inputs, output):
        statics, offs, *leaves = inputs
        ctx.statics, ctx.offs = statics[:3], offs
        lo, hi = output[8], output[9]
        ctx.save_for_backward(lo, hi, *leaves)
        ctx.save_for_forward(lo, hi, *leaves)
        ctx.mark_non_differentiable(*output[7:])

    @staticmethod
    def backward(ctx, *grads):
        from sphereflake_tpu_torch.config import SceneParams
        from sphereflake_tpu_torch.models.sphereflake import (
            child_templates,
            root_frame,
        )

        cfg, frame_w, frame_h = ctx.statics
        lo, hi = ctx.saved_tensors[:2]
        saved = ctx.saved_tensors[2:]
        wanted = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [
                x.detach().requires_grad_(w) for x, w in zip(saved, wanted)
            ]
            scene = SceneParams.from_leaves(leaves)
            with spans.span("gbuffer.recompute"):
                fractal = scene.fractal
                front = (
                    *_band_rays(cfg, frame_w, frame_h, scene, ctx.offs),
                    root_frame(scene.camera.position),
                    child_templates(fractal),
                    fractal.radius_ratio, fractal.root_radius,
                    level_radii(fractal, cfg.max_depth),
                )
                held = [f.detach() for f in front]
                vjp = recompute_vjp(
                    *held[:3], lo, hi, [g.contiguous() for g in grads[:7]],
                    *held[3:], depth=cfg.max_depth,
                )
            tied = [(f, g) for f, g in zip(front, vjp) if f.requires_grad]
            inputs = [x for x, w in zip(leaves, wanted) if w]
            got = iter(torch.autograd.grad(
                [f for f, _ in tied], inputs, [g for _, g in tied],
                allow_unused=True,
            ) if tied else [None] * len(inputs))
        return (None, None, *(next(got) if w else None for w in wanted))

    @staticmethod
    def jvp(ctx, _d_statics, _d_offs, *tangents):
        import torch.autograd.forward_ad as fwAD

        from sphereflake_tpu_torch.config import SceneParams

        cfg, frame_w, frame_h = ctx.statics
        lo, hi = ctx.saved_tensors[:2]
        saved = ctx.saved_tensors[2:]
        # The Function's jvp runs with forward grad switched off; the
        # recompute needs it on (at the caller's dual level). The switch
        # is private to torch (checked on 2.11 and 2.13):
        # tests/test_torch_grad.py::test_forward_grad_switch_is_there
        # fails by name if a release drops it.
        with fwAD._set_fwd_grad_enabled(True):
            leaves = [
                x.detach() if t is None else fwAD.make_dual(x.detach(), t)
                for x, t in zip(saved, tangents)
            ]
            with spans.span("gbuffer.recompute"):
                outs = _gbuffer_recompute(
                    cfg, frame_w, frame_h, SceneParams.from_leaves(leaves),
                    ctx.offs, lo, hi,
                )
            d7 = tuple(
                fwAD.unpack_dual(o).tangent
                if fwAD.unpack_dual(o).tangent is not None
                else torch.zeros_like(o)
                for o in outs
            )
        return d7 + (None,) * 5


def _owned(outs):
    """A block's forward outputs, each owning its storage: a one-tile
    block's rows are views of the kernel output, and forward mode needs
    outputs that own theirs."""
    return tuple(o.clone() if o._is_view() else o for o in outs)


def binned_gbuffer(cfg: RenderConfig, frame_w, frame_h, scene, offs, front):
    """The production forward pass of one block from its front (an
    entry of `band_fronts`: expansion + binning in plain torch): ONE
    fused kernel call computes raygen + binned ray tests + G-buffer
    shading. Differentiable through `BinnedGBuffer` (a recompute from
    the saved path codes); no graph is built when no leaf requires grad.

    offs = (x_off, y_off) pixel offsets of this block within the frame.
    Returns flat [T*1024] tensors (min_t, px, py, pz, nx, ny, nz,
    hit (f32 0/1), code_lo, code_hi), then metrics (int32 [T, 1, 4])
    and the pair/compaction overflow (0-d int32); min_t/pos/nrm carry
    derivatives.
    """
    return BinnedGBuffer.apply(
        (cfg, frame_w, frame_h, front), tuple(offs), *scene.leaves()
    )
