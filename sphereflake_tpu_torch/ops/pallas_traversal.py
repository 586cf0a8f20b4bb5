"""The per-tile traversal kernel and the path-code resolve.

Counterpart of the reference package's `ops/pallas_traversal.py`. One
call of the kernel traces every 1024-ray bundle (a screen tile, or a bundle
of tile-sorted Sobol pixels) on its own: the bundle walks the 9-ary
sphere tree level by level, culls each node's children against its own
4 frustum planes and the conservative LOD bound, keeps the survivors in
order in a per-level queue, and then every ray tests exactly the queued
nodes. Semantics are those of `ops/traversal.trace_tile_fast` with the
bundle as the packet: per-node bounding(2r) + LOD culls decide which
spheres are *candidates*; per-ray bounding/LOD/self tests decide hits.

- `trace_tiles_pallas_soa` is the wrapper. For CUDA tensors it launches
  the hand-written kernel `csrc/traverse_kernel.cu` (or raises); for CPU
  tensors it runs `trace_tiles_pallas_soa_plain`, the same function in
  eager torch ops. `trace_tiles_pallas` is the AoS-directions wrapper.
  The names are the reference package's (its kernel is written in
  Pallas).
- The hit payload is the winner's base-9 path code (sentinel-prefixed:
  root = 1, child = 9 * code + j), riding an f32 lane: `max_depth <= 7`
  here. `resolve_codes[_soa]` re-derives the winning sphere's frame and
  the analytic hit distance from the code in plain ops, which is also
  where gradients flow; `depth_reached_soa` reads the deepest level out
  of a batch of codes.

**Level caps are semantics** (`level_caps`): level l holds at most
`min(round_up_128(9**l), max(128, max_frontier // 128 * 128))` nodes;
survivors past the cap are dropped in order and counted as overflow.

**Where the kernel keeps a bundle's working set.** In device memory,
sized by shapes alone (`queue_words`, `panel_words`): the node launch
writes every bundle's queue — (x, y, z, |c|^2, code) of each queued
node, levels packed from position 0 — into the bundle's region of a
queue pool, and keeps the rotation panels of the level it expands in a
region per resident block; the ray launch then tests the queues as
work items (`ITEM_NODES` nodes each) and merges the items' winners by
minimum. One kernel body serves every `max_frontier`. Nothing is cut
silently and the plain version never stands in for the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import torch

from sphereflake_tpu_torch import kernels
from sphereflake_tpu_torch.config import FractalParams, RenderConfig
from sphereflake_tpu_torch.ops.binned import (
    _EMPTY_KEY,
    ITEM_PAIRS,
    _item_scratch,
    _ordered_key,
)
from sphereflake_tpu_torch.ops.intersect import safe_sqrt

_BIG = 3.0e38

_LANES = 128  # parent-chunk width; a chunk has 9 * 128 child lanes
TILE_RAYS = 1024  # rays per kernel bundle

PALLAS_MAX_DEPTH = 7  # f32 path-code exactness bound (2*9^7 < 2^24)

_PANEL_ROWS = 9  # rotation rows of a frontier panel (two panels)
_QUEUE_ROWS = 5  # x, y, z, |c|^2, code of a queued node
_PLAIN_QUEUE_CHUNK = 32  # queue positions per vectorised ray-test step
# Queue positions per work item of the ray launch: the pair kernel's
# item size, `kItemLen` of csrc/item_walk.cuh.
ITEM_NODES = ITEM_PAIRS


def _ru128(n: int) -> int:
    return ((n + 127) // 128) * 128


def level_caps(cfg: RenderConfig) -> list[int]:
    """Static frontier capacity per level, each a multiple of 128.

    The expansion walks live 128-node chunks with data-dependent trip
    counts, so a generous cap costs memory only, not time. Overflow
    (survivors beyond the cap) is counted and surfaced in the metrics."""
    cap = max(128, (cfg.max_frontier // 128) * 128)
    return [
        min(_ru128(9**level), cap) for level in range(cfg.max_depth + 1)
    ]


def queue_words(cfg: RenderConfig) -> int:
    """f32 words of one bundle's region of the kernel's queue pool: the
    5 rows (x, y, z, |c|^2, code) of as many nodes as the level caps
    hold together."""
    return _QUEUE_ROWS * sum(level_caps(cfg))


def panel_words(cfg: RenderConfig) -> int:
    """f32 words of one node block's two 9-row rotation panels of the
    widest level."""
    return 2 * _PANEL_ROWS * max(level_caps(cfg))


def _level_tables(templates, fractal: FractalParams, cfg: RenderConfig):
    """(level_tab [4, depth+1], expand [max(depth, 1), 9, 12]) — the
    per-level scalars (radius, r^2, 4r^2, lod^2 * r) and, per level and
    child, the 9 template rotation entries (row-major) followed by the
    3 displacement entries scaled by the level's tangent distance
    (1 + ratio) * radius (`Sphereflake.h:162-168`). Computed in plain
    ops outside the kernel, as the reference does."""
    depth = cfg.max_depth
    dev = templates.device
    levels = torch.arange(depth + 1, dtype=torch.float32, device=dev)
    radii = fractal.root_radius * fractal.radius_ratio ** levels
    lod_sq = torch.tensor(cfg.lod_factor**2, dtype=torch.float32, device=dev)
    level_tab = torch.stack(
        [radii, radii * radii, 4.0 * radii * radii, lod_sq * radii]
    )
    n_expand = max(depth, 1)
    scales = torch.zeros((n_expand,), dtype=torch.float32, device=dev)
    if depth > 0:
        scales = (1.0 + fractal.radius_ratio) * radii[:-1]
    rot = templates[:, :, :3].reshape(1, 9, 9).expand(n_expand, 9, 9)
    sdisp = scales[:, None, None] * templates[None, :, :, 3]
    return level_tab.contiguous(), torch.cat([rot, sdisp], dim=2).contiguous()


def _expand_level(rot, t, code, live, planes, tmpl, r_c, lod_rc, cap_n,
                  with_rot: bool):
    """One level of the expansion for a batch of bundles: parents
    (rot [B, 9, n], t [B, 3, n], code [B, n], the first live[b] valid)
    -> their surviving children compacted in order into `cap_n` slots.
    Returns (rot', t', code', total [B]) with total the survivor count
    before the cap. Reads max(live) back to the host."""
    B = rot.shape[0]
    dev = rot.device
    n_chunks = -(-int(live.max()) // _LANES) if B else 0
    out_rot = torch.zeros((B, 9, cap_n), dtype=torch.float32, device=dev)
    out_t = torch.zeros((B, 3, cap_n), dtype=torch.float32, device=dev)
    out_code = torch.zeros((B, cap_n), dtype=torch.float32, device=dev)
    total = torch.zeros((B,), dtype=torch.int64, device=dev)
    if n_chunks == 0:
        return out_rot, out_t, out_code, total
    P = n_chunks * _LANES
    # Child lanes in order: chunk-major, then child j, then parent p —
    # arrays [B, n_chunks, 9, 128].
    shape = (B, n_chunks, 1, _LANES)
    R = [rot[:, i, :P].reshape(shape) for i in range(9)]
    T = [t[:, a, :P].reshape(shape) for a in range(3)]
    valid = (
        torch.arange(P, device=dev)[None, :] < live[:, None]
    ).reshape(shape)
    col = lambda i: tmpl[:, i].reshape(1, 1, 9, 1)
    # t'[a] = sum_k R[a, k] * (scale * disp_j[k]) + t[a], k = 0, 1, 2.
    c = [
        ((R[3 * a] * col(9) + R[3 * a + 1] * col(10)) + R[3 * a + 2] * col(11))
        + T[a]
        for a in range(3)
    ]
    cc = c[0] * c[0] + c[1] * c[1] + c[2] * c[2]
    lim = lod_rc + 2.0 * r_c
    keep = cc < lim * lim
    neg2r = -2.0 * r_c
    for p in range(4):
        n = planes[:, p].reshape(B, 3, 1, 1, 1)
        d_p = n[:, 0] * c[0] + n[:, 1] * c[1] + n[:, 2] * c[2]
        keep = keep & (d_p >= neg2r)
    keep = (keep & valid).reshape(B, -1)
    # Stable compaction: survivor w goes to slot rank(w); ranks past the
    # cap fall into a dump slot that is cut off again.
    pos = torch.cumsum(keep, dim=1) - 1
    total = keep.sum(dim=1)
    dst = torch.where(keep & (pos < cap_n), pos, torch.full_like(pos, cap_n))

    def compact(rows):  # [B, r, lanes] -> [B, r, cap_n]
        r = rows.shape[1]
        buf = torch.zeros((B, r, cap_n + 1), dtype=torch.float32, device=dev)
        buf.scatter_(2, dst[:, None, :].expand(B, r, -1), rows)
        return buf[:, :, :cap_n]

    j = torch.arange(9, dtype=torch.float32, device=dev).reshape(1, 1, 9, 1)
    child_code = 9.0 * code[:, :P].reshape(shape) + j
    small = torch.stack(
        [x.reshape(B, -1) for x in (*c, child_code.expand_as(cc))], dim=1
    )
    packed = compact(small)
    out_t, out_code = packed[:, :3], packed[:, 3]
    if with_rot:
        # R'[a, b] = sum_k R[a, k] * rot_j[k, b], k = 0, 1, 2.
        child_rot = [
            (R[3 * a] * col(b) + R[3 * a + 1] * col(3 + b))
            + R[3 * a + 2] * col(6 + b)
            for a in range(3)
            for b in range(3)
        ]
        out_rot = compact(
            torch.stack([x.reshape(B, -1) for x in child_rot], dim=1)
        )
    return out_rot, out_t, out_code, total


def _expand_bundles(planes, root, level_tab, expand, caps):
    """The kernel's node work (phase 1) for a batch of bundles with
    frustum planes [B, 4, 3]: the queue, one (t [B, 3, cap_l], code
    [B, cap_l], live [B]) per level — the first live[b] slots of bundle
    b hold its nodes in queue order — and metrics [B, 8] int32."""
    B = planes.shape[0]
    dev = planes.device
    depth = len(caps) - 1
    rot = torch.zeros((B, 9, caps[0]), dtype=torch.float32, device=dev)
    t = torch.zeros((B, 3, caps[0]), dtype=torch.float32, device=dev)
    code = torch.zeros((B, caps[0]), dtype=torch.float32, device=dev)
    rot[:, :, 0] = root[:, :3].reshape(9)
    t[:, :, 0] = root[:, 3]
    code[:, 0] = 1.0
    live = torch.ones((B,), dtype=torch.int64, device=dev)
    overflow = torch.zeros_like(live)
    max_level = torch.zeros_like(live)
    qlen = torch.zeros_like(live)

    queue = []
    for level in range(depth + 1):
        max_level = torch.where(
            live > 0, torch.full_like(live, level), max_level
        )
        qlen = qlen + live
        queue.append((t, code, live))
        if level == depth:
            break
        cap_n = caps[level + 1]
        rot, t, code, total = _expand_level(
            rot, t, code, live, planes, expand[level],
            level_tab[0, level + 1], level_tab[3, level + 1], cap_n,
            with_rot=level + 1 < depth,
        )
        live = torch.clamp_max(total, cap_n)
        overflow = overflow + torch.clamp_min(total - cap_n, 0)
    zero = torch.zeros_like(live)
    metrics = torch.stack(
        [qlen, overflow, max_level, live, zero, zero, zero, zero], dim=1
    )
    return queue, metrics.to(torch.int32)


def _walk_queue(d, queue, level_tab):
    """The kernel's ray work (phase 2), the definition: every ray of
    d [B, 3, 1024] tests its bundle's queued nodes in queue order,
    strict `<`, so the first candidate wins a tie. Returns (bt, bc),
    each [B, 1024]: BIG and 0 at a miss."""
    B = d.shape[0]
    dev = d.device
    dx, dy, dz = d[:, 0, :, None], d[:, 1, :, None], d[:, 2, :, None]
    bt = torch.full((B, TILE_RAYS), _BIG, dtype=torch.float32, device=dev)
    bc = torch.zeros((B, TILE_RAYS), dtype=torch.float32, device=dev)
    for level, (qt, qcode, qlive) in enumerate(queue):
        r2, lodr = level_tab[1, level], level_tab[3, level]
        n_live = int(qlive.max()) if B else 0
        for q0 in range(0, n_live, _PLAIN_QUEUE_CHUNK):
            q1 = min(q0 + _PLAIN_QUEUE_CHUNK, n_live)
            cx, cy, cz = (qt[:, a, None, q0:q1] for a in range(3))
            iota = torch.arange(q0, q1, device=dev)
            in_queue = (iota[None, :] < qlive[:, None])[:, None, :]
            cc = cx * cx + cy * cy + cz * cz
            tca = dx * cx + dy * cy + dz * cz  # [B, 1024, q1 - q0]
            d2 = cc - tca * tca
            c1 = tca - lodr
            lod_ok = (c1 < 0.0) | (c1 * c1 < 4.0 * r2 - d2)
            ok = in_queue & (tca >= 0.0) & lod_ok & (d2 <= r2)
            ts = tca - torch.sqrt(torch.clamp_min(r2 - d2, 0.0))
            ts = torch.where(ok, ts, torch.full_like(ts, _BIG))
            best = torch.amin(ts, dim=2)
            first = torch.amin(
                torch.where(ts == best[:, :, None], iota, q1), dim=2
            )
            better = best < bt
            bt = torch.where(better, best, bt)
            bc = torch.where(
                better, torch.gather(qcode, 1, torch.clamp_max(first, q1 - 1)),
                bc,
            )
    return bt, bc


def _trace_bundles_plain(d, planes, root, level_tab, expand, caps):
    """The kernel's two phases for a batch of bundles: d [B, 3, 1024],
    planes [B, 4, 3] -> (bt [B, 1024], bc [B, 1024], metrics [B, 8])."""
    queue, metrics = _expand_bundles(planes, root, level_tab, expand, caps)
    bt, bc = _walk_queue(d, queue, level_tab)
    return bt, bc, metrics


# The ray launch's item walk, in plain pieces: the kernel packs each
# bundle's queue from position 0, cuts it into items of at most
# `ITEM_NODES` nodes, walks each item keeping one key (ts, q) per ray,
# merges the items' keys by minimum and reads the winner's node once.
# The same steps in eager ops, for the tests; no main path runs them.


def _pack_queue(queue):
    """The kernel's queue pool for the queue of `_expand_bundles`: rows
    (x, y, z, |c|^2, code) [B, 5, Q] with bundle b's levels packed from
    position 0 (Q its longest queue), and qlen [B]."""
    B = queue[0][0].shape[0]
    dev = queue[0][0].device
    qlen = sum(live for _, _, live in queue)
    Q = int(qlen.max())
    pool = torch.zeros((B, _QUEUE_ROWS, Q + 1), dtype=torch.float32,
                       device=dev)
    off = torch.zeros_like(qlen)
    for t, code, live in queue:
        slot = torch.arange(t.shape[2], device=dev)
        # Slots past the level's live count go to a dump column.
        dst = torch.where(slot[None, :] < live[:, None],
                          off[:, None] + slot[None, :], Q)
        cc = t[:, 0] * t[:, 0] + t[:, 1] * t[:, 1] + t[:, 2] * t[:, 2]
        rows = torch.stack([t[:, 0], t[:, 1], t[:, 2], cc, code], dim=1)
        pool.scatter_(2, dst[:, None, :].expand(-1, _QUEUE_ROWS, -1), rows)
        off = off + live
    return pool[:, :, :Q], qlen


def _code_level(code):
    """The level of sentinel-prefixed path codes: a level-l code lies in
    [9^l, 2 * 9^l). int64, the shape of `code`."""
    level = torch.zeros(code.shape, dtype=torch.int64, device=code.device)
    for k in range(1, PALLAS_MAX_DEPTH + 1):
        level = level + (code >= float(9**k)).to(torch.int64)
    return level


def _walk_queue_keys(d, pool, qlen, level_tab, q_first=0, q_count=None):
    """The kernel's walk over queue positions [q_first, q_first +
    q_count) of every bundle (the whole queue by default): per ray the
    smallest key of (ts, q) (`binned._ordered_key`: the first queue
    position among equal t) among the nodes that pass,
    `_EMPTY_KEY` where none does. [B, 1024] int64. Reads max(qlen)
    back to the host."""
    B = d.shape[0]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    best = torch.full((B, TILE_RAYS), _EMPTY_KEY, dtype=torch.int64,
                      device=d.device)
    q_max = int(qlen.max()) if B else 0
    if q_count is not None:
        q_max = min(q_max, q_first + q_count)
    for q in range(q_first, q_max):
        cx, cy, cz, cc, code = (pool[:, r, q, None] for r in range(5))
        level = _code_level(code)
        r2, lodr = level_tab[1][level], level_tab[3][level]
        tca = dx * cx + dy * cy + dz * cz
        d2 = cc - tca * tca
        c1 = tca - lodr
        lod_ok = (c1 < 0.0) | (c1 * c1 < 4.0 * r2 - d2)
        ok = (q < qlen)[:, None] & (tca >= 0.0) & lod_ok & (d2 <= r2)
        ts = tca - torch.sqrt(torch.clamp_min(r2 - d2, 0.0))
        key = torch.where(ok, _ordered_key(ts, q), best)
        best = torch.minimum(best, key)
    return best


def _winner_from_queue_keys(keys, d, pool, level_tab):
    """The kernel's finish: (bt, bc) [B, 1024] from merged keys — the
    winner's node read once per ray, ts recomputed from it by the
    walk's own expression (so a -0.0 keeps its sign)."""
    none = keys == _EMPTY_KEY
    q = torch.where(none, torch.zeros_like(keys), keys & 0xFFFFFFFF)
    node = torch.gather(pool, 2, q[:, None, :].expand(-1, _QUEUE_ROWS, -1))
    cx, cy, cz, cc, code = node.unbind(1)
    r2 = level_tab[1][_code_level(code)]
    tca = d[:, 0] * cx + d[:, 1] * cy + d[:, 2] * cz
    d2 = cc - tca * tca
    ts = tca - torch.sqrt(torch.clamp_min(r2 - d2, 0.0))
    return (torch.where(none, torch.full_like(ts, _BIG), ts),
            torch.where(none, torch.zeros_like(code), code))


def _walk_queue_split(d, pool, qlen, level_tab, item_nodes: int):
    """`_walk_queue` the way the ray launch takes it: every queue cut
    into items of `item_nodes` nodes, each walked on its own
    (`_walk_queue_keys`), the keys merged by minimum — in reverse order
    here: any order gives the same keys — and the winner read back
    (`_winner_from_queue_keys`)."""
    merged = torch.full((d.shape[0], TILE_RAYS), _EMPTY_KEY,
                        dtype=torch.int64, device=d.device)
    for q_first in reversed(range(0, int(qlen.max()), item_nodes)):
        merged = torch.minimum(merged, _walk_queue_keys(
            d, pool, qlen, level_tab, q_first, item_nodes
        ))
    return _winner_from_queue_keys(merged, d, pool, level_tab)


def _empty_outputs(dev):
    """(out, metrics) of a call with no bundles."""
    return (
        torch.empty((0, 2, 8, _LANES), dtype=torch.float32, device=dev),
        torch.empty((0, 1, 8), dtype=torch.int32, device=dev),
    )


def trace_tiles_pallas_soa_plain(dirs_k, tile_planes, root, templates,
                                 fractal: FractalParams, cfg: RenderConfig):
    """Plain torch version of the traversal kernel — the same function
    as `csrc/traverse_kernel.cu` in eager ops: the same level caps, the
    same survivor order (128-parent chunk, then child, then parent), the
    same sums in the same order, the same strict `<`. Bundles are traced
    `cfg.tile_batch` at a time. The CPU tests use it, and the kernel is
    held against it on the card; it reads live counts back to the host,
    so it is not a frame-path function there. Returns (out [T, 2, 8,
    128] = (t, code), metrics [T, 1, 8] int32)."""
    T = dirs_k.shape[0]
    dev = dirs_k.device
    caps = level_caps(cfg)
    level_tab, expand = _level_tables(templates, fractal, cfg)
    d = dirs_k.reshape(T, 3, TILE_RAYS)
    outs, mets = [], []
    batch = max(1, cfg.tile_batch)
    for s in range(0, T, batch):
        bt, bc, m = _trace_bundles_plain(
            d[s:s + batch], tile_planes[s:s + batch], root, level_tab,
            expand, caps,
        )
        outs.append(torch.stack([bt, bc], dim=1))
        mets.append(m)
    if not outs:
        return _empty_outputs(dev)
    return (
        torch.cat(outs).reshape(T, 2, 8, _LANES),
        torch.cat(mets).reshape(T, 1, 8),
    )


class _Scratch(NamedTuple):
    """What one traversal launch needs besides its inputs and outputs,
    sized by shapes alone (`_traverse_scratch`)."""

    pool: torch.Tensor  # [T, queue_words] f32: the queues
    panels: torch.Tensor  # [node blocks, panel_words] f32
    counter: torch.Tensor  # [1] int32: the node launch's draw
    keys: torch.Tensor  # [T, 1024] int64: merge keys of the ray launch
    work: torch.Tensor  # [8 T + 8] int32: the ray launch's item table


def _node_slots(dev) -> int:
    """Blocks of the node launch that fit the card at once (asked at
    every launch: cards may differ)."""
    fn = getattr(kernels.load("traverse_kernel"), "sf_trace_tiles_node_slots")
    fn.argtypes, fn.restype = [], ctypes.c_int
    with torch.cuda.device(dev):
        slots = fn()
    if slots <= 0:
        raise RuntimeError(
            f"traverse_kernel occupancy query failed: CUDA error {-slots}"
        )
    return slots


def _traverse_scratch(n_bundles: int, cfg: RenderConfig, dev) -> _Scratch:
    """The scratch of a traversal launch over `n_bundles` bundles: a
    queue region per bundle and a pair of rotation panels per resident
    node block (at most one per bundle)."""
    n_blocks = min(n_bundles, _node_slots(dev))
    keys, work = _item_scratch(n_bundles, dev)
    return _Scratch(
        pool=torch.empty((n_bundles, queue_words(cfg)), dtype=torch.float32,
                         device=dev),
        panels=torch.empty((n_blocks, panel_words(cfg)), dtype=torch.float32,
                           device=dev),
        counter=torch.empty((1,), dtype=torch.int32, device=dev),
        keys=keys, work=work,
    )


def _enqueue_nodes(tile_planes, root, expand, level_tab, cfg: RenderConfig,
                   scratch: _Scratch, metrics):
    """Enqueue the node launch: every bundle's queue into the pool and
    its 8 metrics."""
    fn = kernels.entry_point("traverse_kernel", "sf_trace_tiles_nodes", 8, 4)
    kernels.enqueue(
        fn, "traverse_kernel (nodes)",
        (tile_planes, root, expand, level_tab, scratch.pool, scratch.panels,
         metrics, scratch.counter),
        (tile_planes.shape[0], cfg.max_depth, max(level_caps(cfg)),
         scratch.panels.shape[0]),
        tile_planes.device,
    )


def _enqueue_rays(dirs_k, level_tab, cfg: RenderConfig, scratch: _Scratch,
                  metrics, out):
    """Enqueue the ray launch (its prologue and its walk) over the queues
    the node launch left in the pool."""
    fn = kernels.entry_point("traverse_kernel", "sf_trace_tiles_rays", 7, 3)
    kernels.enqueue(
        fn, "traverse_kernel (rays)",
        (dirs_k, scratch.pool, level_tab, metrics, out, scratch.keys,
         scratch.work),
        (dirs_k.shape[0], cfg.max_depth, max(level_caps(cfg))),
        dirs_k.device,
    )


def _enqueue_traverse_kernel(dirs_k, tile_planes, root, expand, level_tab,
                             cfg: RenderConfig):
    """Enqueue `csrc/traverse_kernel.cu` for every bundle of `dirs_k`,
    given the level tables of `_level_tables`: the node launch, then the
    ray launch (one call, one count)."""
    T = dirs_k.shape[0]
    dev = dirs_k.device
    out = torch.empty((T, 2, 8, _LANES), dtype=torch.float32, device=dev)
    metrics = torch.empty((T, 1, 8), dtype=torch.int32, device=dev)
    if dirs_k.data_ptr() % 16:
        dirs_k = dirs_k.clone()  # the ray launch loads four rays at a time
    scratch = _traverse_scratch(T, cfg, dev)
    _enqueue_nodes(tile_planes, root, expand, level_tab, cfg, scratch, metrics)
    _enqueue_rays(dirs_k, level_tab, cfg, scratch, metrics, out)
    trace_tiles_pallas_soa.launches += 1
    return out, metrics


def _launch_traverse_kernel(dirs_k, tile_planes, root, templates,
                            fractal: FractalParams, cfg: RenderConfig):
    """The kernel path of `trace_tiles_pallas_soa`: level tables in
    plain ops, then the kernel's node and ray launches (none for
    T = 0)."""
    if dirs_k.shape[0] == 0:
        return _empty_outputs(dirs_k.device)
    level_tab, expand = _level_tables(templates, fractal, cfg)
    return _enqueue_traverse_kernel(
        dirs_k, tile_planes, root, expand, level_tab, cfg
    )


def trace_tiles_pallas_soa(
    dirs_k: torch.Tensor,  # [T, 3, 8, 128] unit ray dirs per bundle
    tile_planes: torch.Tensor,  # [T, 4, 3] inward unit frustum normals
    root: torch.Tensor,  # [3, 4]
    templates: torch.Tensor,  # [9, 3, 4]
    fractal: FractalParams,
    cfg: RenderConfig,
):
    """Trace every 1024-ray bundle through the 9-ary tree on its own:
    returns (out [T, 2, 8, 128], metrics [T, 1, 8] int32). out[:, 0] is
    the hit distance (BIG at a miss), out[:, 1] the winner's
    sentinel-prefixed base-9 path code (0.0 at a miss). metrics columns:
    queue length (nodes tested per ray), overflow (survivors dropped at
    the level caps), deepest level with a live node, live count of the
    last level, four zeros.

    Inputs are detached: gradients flow through `resolve_codes`.

    CUDA tensors launch the hand-written kernel (or raise); CPU tensors
    run the plain version. T = 0 returns empty outputs without a
    launch. Launches on the current stream, never synchronises.
    `trace_tiles_pallas_soa.launches` counts calls that launched."""
    assert cfg.max_depth <= PALLAS_MAX_DEPTH, (
        f"pallas path supports max_depth <= {PALLAS_MAX_DEPTH} "
        "(f32 path-code exactness); use an XLA algorithm for deeper"
    )
    kernels.check_tensors(
        [
            ("dirs_k", dirs_k, torch.float32, (None, 3, 8, _LANES)),
            ("tile_planes", tile_planes, torch.float32,
             (dirs_k.shape[0] if isinstance(dirs_k, torch.Tensor) else None,
              4, 3)),
            ("root", root, torch.float32, (3, 4)),
            ("templates", templates, torch.float32, (9, 3, 4)),
        ],
        dirs_k, "dirs_k",
    )
    dirs_k, tile_planes = dirs_k.detach(), tile_planes.detach()
    root, templates = root.detach(), templates.detach()
    fractal = dataclasses.replace(fractal, **{
        f.name: getattr(fractal, f.name).detach()
        for f in dataclasses.fields(fractal)
    })
    if dirs_k.device.type == "cuda":
        return _launch_traverse_kernel(
            dirs_k, tile_planes, root, templates, fractal, cfg
        )
    return trace_tiles_pallas_soa_plain(
        dirs_k, tile_planes, root, templates, fractal, cfg
    )


trace_tiles_pallas_soa.launches = 0


def trace_tiles_pallas(tile_dirs, tile_planes, root, templates,
                       fractal: FractalParams, cfg: RenderConfig):
    """Trace all bundles with the traversal kernel (AoS directions
    wrapper): tile_dirs [T, 1024, 3]. Returns (min_t [T, 1024], code
    [T, 1024], metrics [T, 1, 8] int32)."""
    T, rays, _ = tile_dirs.shape
    assert rays == TILE_RAYS, (
        f"pallas path requires {TILE_RAYS}-ray tiles (one [8,128] vreg "
        f"per tile), got {rays}; pick tile_h*tile_w == {TILE_RAYS}"
    )
    dirs_k = torch.movedim(tile_dirs, 2, 1).reshape(T, 3, 8, _LANES)
    out, metrics = trace_tiles_pallas_soa(
        dirs_k.contiguous(), tile_planes, root, templates, fractal, cfg
    )
    return (
        out[:, 0].reshape(T, TILE_RAYS),
        out[:, 1].reshape(T, TILE_RAYS),
        metrics,
    )


def resolve_codes_soa(
    dx,  # [N] unit ray direction components
    dy,
    dz,
    code_f,  # [N] f32 sentinel path codes (lo lane) from the kernel
    root,  # [3, 4]
    templates,  # [9, 3, 4]
    fractal: FractalParams,
    cfg: RenderConfig,
    code_hi_f=None,  # [N] f32 hi lane (depth >= 7)
):
    """Differentiably re-derive each ray's winning sphere from its path
    code, fully SoA: returns (min_t, cx, cy, cz, hit), each [N].

    This is the straight-through backward surface: the *discrete*
    winner choice comes from the kernel (the codes are detached); the
    winner's frame is re-composed from the templates and the analytic
    ray-sphere distance (`SIMD_AVX.h:236-270`) is recomputed in plain
    ops, so autograd flows into `root`, `templates` and `fractal` (no
    in-place op, nothing else detached).

    Codes ride two lanes from depth 7 on: full code = hi * 9^7 + lo
    (sentinel-prefixed, so level = floor(log9) of the combination);
    base-9 digit extraction never needs the sentinel stripped because
    it always lands above the `% 9`.

    The frame walk is 12 per-ray component tensors and broadcast
    multiply + sum, never `torch.matmul`: full f32 whatever the TF32
    settings say.
    """
    lo = code_f.detach().to(torch.int32).reshape(-1)
    if code_hi_f is None:
        hi = torch.zeros_like(lo)
    else:
        hi = code_hi_f.detach().to(torch.int32).reshape(-1)
    hit = (lo >= 1) | (hi >= 1)

    depth = cfg.max_depth
    pow9 = [9**k for k in range(8)]  # 9^7 is the largest ever indexed
    # level = floor(log9 code): count thresholds passed per lane.
    level = torch.zeros_like(lo)
    for k in range(1, min(depth, 7) + 1):
        level = level + ((hi == 0) & (lo >= pow9[k])).to(torch.int32)
    # hi carries from LEVEL 7 onward (expand_global splits at 9^7
    # unconditionally), so the hi-lane level count runs at depth == 7 too.
    for k in range(0, max(depth - 7, 0) + 1 if depth >= 7 else 0):
        level = level + (hi >= pow9[k]).to(torch.int32) * (7 if k == 0 else 1)
    pow_tab = torch.tensor(pow9, dtype=torch.int32, device=lo.device)

    ratio = fractal.radius_ratio
    radius0 = fractal.root_radius

    def floor_div(a, b):
        return torch.div(a, b, rounding_mode="floor")

    n = lo.shape[0]
    r = [root[a, b].expand(n) for a in range(3) for b in range(3)]
    t = [root[a, 3].expand(n) for a in range(3)]
    radius = radius0
    for k in range(depth):
        # Base-9 digit for expansion step k (most significant first):
        # digit m = level-1-k powers above the bottom; taken from hi
        # when m >= 7 (the sentinel always sits above the % 9).
        m = torch.clamp_min(level - 1 - k, 0)
        d_lo = floor_div(lo, pow_tab[torch.clamp_max(m, 7).long()]) % 9
        if depth > 7:
            d_hi = floor_div(hi, pow_tab[torch.clamp_min(m - 7, 0).long()]) % 9
            d = torch.where(m >= 7, d_hi, d_lo)
        else:
            d = d_lo
        scale = (1.0 + ratio) * radius
        oh = [(d == j).to(torch.float32) for j in range(9)]
        # Selected template entries per ray (rotation + scaled disp).
        e = [
            sum(oh[j] * templates[j, a, b] for j in range(9))
            for a in range(3)
            for b in range(3)
        ]
        disp = [
            sum(oh[j] * templates[j, a, 3] for j in range(9)) * scale
            for a in range(3)
        ]
        take = (k < level).to(torch.float32)
        keep = 1.0 - take
        new_r = [
            sum(r[3 * a + kk] * e[3 * kk + b] for kk in range(3))
            for a in range(3)
            for b in range(3)
        ]
        new_t = [
            sum(r[3 * a + kk] * disp[kk] for kk in range(3)) + t[a]
            for a in range(3)
        ]
        r = [take * nr + keep * rr for nr, rr in zip(new_r, r)]
        t = [take * nt + keep * tt for nt, tt in zip(new_t, t)]
        radius = radius * ratio

    cx, cy, cz = t
    r_hit = radius0 * fractal.radius_ratio ** level.to(torch.float32)
    tca = dx * cx + dy * cy + dz * cz
    d2 = cx * cx + cy * cy + cz * cz - tca * tca
    tt = tca - safe_sqrt(r_hit * r_hit - d2)
    min_t = torch.where(hit, tt, torch.full_like(tt, _BIG))
    hf = hit.to(torch.float32)
    return min_t, cx * hf, cy * hf, cz * hf, hit


def resolve_codes(dirs, code_f, root, templates, fractal: FractalParams,
                  cfg: RenderConfig, code_hi_f=None):
    """AoS wrapper over `resolve_codes_soa`: dirs [..., 3], codes [...]
    -> (min_t [...], center [..., 3], hit [...])."""
    shape = code_f.shape
    flat = dirs.reshape(-1, 3)
    min_t, cx, cy, cz, hit = resolve_codes_soa(
        flat[:, 0], flat[:, 1], flat[:, 2], code_f.reshape(-1),
        root, templates, fractal, cfg,
        code_hi_f=None if code_hi_f is None else code_hi_f.reshape(-1),
    )
    center = torch.stack([cx, cy, cz], dim=-1)
    return (
        min_t.reshape(shape),
        center.reshape(*shape, 3),
        hit.reshape(shape),
    )


def depth_reached_soa(code_f, cfg: RenderConfig, code_hi_f=None):
    """Max fractal level present in a batch of (lo, hi) path codes —
    the C++ app's `m_MaxDepthReached` (`Sphereflake.h:157-160`).
    Returns a 0-d int32 tensor."""
    lo = torch.max(code_f).to(torch.int32)
    depth = torch.zeros((), dtype=torch.int32, device=code_f.device)
    for k in range(1, min(cfg.max_depth, 7) + 1):
        depth = depth + (lo >= 9**k).to(torch.int32)
    if cfg.max_depth >= 7 and code_hi_f is not None:
        hi = torch.max(code_hi_f).to(torch.int32)
        deep = torch.zeros_like(depth)
        for k in range(1, cfg.max_depth - 7 + 1):
            deep = deep + (hi >= 9**k).to(torch.int32)
        depth = torch.where(hi >= 1, 7 + deep, depth)
    return depth
