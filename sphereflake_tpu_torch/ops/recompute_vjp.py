"""The fit's backward of one band in one kernel: the recompute of each
ray's winner from its path code and the vector-Jacobian product of that
recompute (`csrc/recompute_vjp.cu`), with its plain torch version beside it.

The function is the differentiable surface of a binned block
(`ops/binned.py:_shade_codes`): each ray's winning sphere re-derived from
its detached (lo, hi) path code (`resolve_codes_soa`), then the shading
tail, to (min_t, px, py, pz, nx, ny, nz). `recompute_vjp` takes the 7
outputs' upstream gradients and returns the gradients of its inputs: each
ray's direction (dx, dy, dz), the root frame [3, 4], the child templates
[9, 3, 4], the two fractal scalars through each level's scale, and the
table of level radii (`level_radii`). The caller builds those inputs
under autograd (raygen, `root_frame`, `child_templates`, `level_radii`)
and hands the gradients to `torch.autograd.grad` over them, which carries
them into the scene's leaves (`BinnedGBuffer.backward`).

The gradient is the straight-through one of the plain chain, in float32,
with no term dropped; the frame walk's product is differentiated in closed
form (`csrc/recompute_vjp.cu` states it), so it rounds a little
differently from autograd's graph. Leaf gradients are sums over the rays
in a fixed order: per thread over its rays, per block by a fixed tree,
over the blocks lane by lane and by a fixed tree. The plain version takes
the same order, and two calls of either give the same bits.

`recompute_forward` is the kernel's second mode: the 7 outputs
themselves, bit for bit those of the plain chain. The checks use it; no
main path runs it.
"""

from __future__ import annotations

import torch

from sphereflake_tpu_torch import kernels, spans

THREADS = 128  # rays in flight a block
GRID_BLOCKS = 396  # the grid's cap: 3 blocks on each of an H100's 132 SMs
LANES = 32  # the finish's lanes: rows l, l + 32, ... each
MAX_DEPTH = 13  # ops/binned.py:DEEP_MAX_DEPTH
_SCALE_SLOT = 120  # root (12) and templates (108) come first


def n_slots(depth: int) -> int:
    """Slots of a row of partial sums: root (12), templates (108), each
    level's scale (depth) and each level's radius (depth + 1)."""
    return _SCALE_SLOT + 2 * depth + 1


def grid_blocks(n: int) -> int:
    """Blocks of a launch over n rays (the plain version's too)."""
    return min(-(-n // THREADS), GRID_BLOCKS)


def level_radii(fractal, depth: int):
    """[depth + 1] radius of each level, root_radius * radius_ratio^level:
    `resolve_codes_soa`'s per-ray radius, one entry a level."""
    levels = torch.arange(depth + 1, dtype=torch.float32,
                          device=fractal.radius_ratio.device)
    return fractal.root_radius * fractal.radius_ratio ** levels


def _decode(lo_f, hi_f, depth: int):
    """(level [N] int32, digits [max(depth, 1), N] int32): the level of each
    code as `resolve_codes_soa` counts it and its base-9 digits, least
    significant first (m < 7 from lo, m >= 7 from hi)."""
    lo = lo_f.to(torch.int32)
    hi = hi_f.to(torch.int32) if depth >= 7 else torch.zeros_like(lo)
    level = torch.zeros_like(lo)
    for k in range(1, min(depth, 7) + 1):
        level = level + ((hi == 0) & (lo >= 9**k)).to(torch.int32)
    if depth >= 7:
        level = level + (hi >= 1).to(torch.int32) * 7
        for k in range(1, depth - 7 + 1):
            level = level + (hi >= 9**k).to(torch.int32)
    digits = [torch.zeros_like(lo)]
    x = lo
    for _m in range(min(depth, 7)):
        digits.append(x % 9)
        x = torch.div(x, 9, rounding_mode="floor")
    x = hi
    for _m in range(7, depth):
        digits.append(x % 9)
        x = torch.div(x, 9, rounding_mode="floor")
    digits = torch.stack(digits[1:] if depth else digits)
    return level, digits


def _scales(ratio, radius0, depth: int):
    """Each level's child displacement scale, (1 + ratio) * radius_k with
    radius_k = radius0 * ratio * ... * ratio (k times), and the radii."""
    scales, radii, radius = [], [], radius0
    for _k in range(depth):
        radii.append(radius)
        scales.append((1.0 + ratio) * radius)
        radius = radius * ratio
    return scales, radii


def _ray_terms(dx, dy, dz, lo, hi, g, root, tm, scales, rhit, depth):
    """The kernel's per-ray work on a batch of rays [W]: (hit, level, the
    direction's gradient (3), the per-level terms in the kernel's order,
    root terms, rhit term). Rays that miss are masked by the caller."""
    level, digits = _decode(lo, hi, depth)
    hit = lo.to(torch.int32) >= 1
    if depth >= 7:
        hit = hit | (hi.to(torch.int32) >= 1)
    rows = []  # per step k: (take, digit, e [W, 12])
    for k in range(depth):
        m = torch.clamp_min(level - 1 - k, 0).long()
        d = torch.gather(digits, 0, m[None])[0].long()
        rows.append((k < level, d, tm[d]))
    w_ = dx.shape[0]
    R = [root[a, b].expand(w_) for a in range(3) for b in range(3)]
    t = [root[a, 3].expand(w_) for a in range(3)]
    for k, (take, _d, e) in enumerate(rows):
        nr = [(R[3 * a] * e[:, b] + R[3 * a + 1] * e[:, 4 + b])
              + R[3 * a + 2] * e[:, 8 + b]
              for a in range(3) for b in range(3)]
        nt = [((R[3 * a] * (e[:, 3] * scales[k])
                + R[3 * a + 1] * (e[:, 7] * scales[k]))
               + R[3 * a + 2] * (e[:, 11] * scales[k])) + t[a]
              for a in range(3)]
        R = [torch.where(take, x, y) for x, y in zip(nr, R)]
        t = [torch.where(take, x, y) for x, y in zip(nt, t)]
    cx, cy, cz = t
    zero = torch.zeros_like(dx)
    rh = rhit[level.long()]
    tca = (dx * cx + dy * cy) + dz * cz
    d2 = ((cx * cx + cy * cy) + cz * cz) - tca * tca
    q = rh * rh - d2
    s = torch.where(q > 0, torch.sqrt(torch.where(q > 0, q, 1.0)), zero)
    tt = tca - s
    wx, wy, wz = dx * tt - cx, dy * tt - cy, dz * tt - cz
    m2 = (wx * wx + wy * wy) + wz * wz
    nn0 = torch.where(m2 > 0, torch.sqrt(torch.where(m2 > 0, m2, 1.0)), zero)
    nn = torch.where(nn0 > 0, nn0, 1.0)
    # The shading tail backward (the kernel's order).
    g_t, g_px, g_py, g_pz, g_nx, g_ny, g_nz = g
    nn2 = nn * nn
    g_nn = (((-g_nx) * wx) / nn2 + ((-g_ny) * wy) / nn2) + ((-g_nz) * wz) / nn2
    g_m = torch.where((nn0 > 0) & (m2 > 0), g_nn / (2.0 * nn0), zero)
    g_wx = g_nx / nn + (g_m * wx + g_m * wx)
    g_wy = g_ny / nn + (g_m * wy + g_m * wy)
    g_wz = g_nz / nn + (g_m * wz + g_m * wz)
    gp_x, gp_y, gp_z = g_px + g_wx, g_py + g_wy, g_pz + g_wz
    g_tt = g_t + ((gp_x * dx + gp_y * dy) + gp_z * dz)
    g_q = torch.where(q > 0, (-g_tt) / (2.0 * s), zero)
    g_rh = g_q * rh + g_q * rh
    g_d2 = -g_q
    g_tca = g_tt + ((-g_d2) * tca + (-g_d2) * tca)
    g_c = [(-g_w + (g_d2 * c + g_d2 * c)) + g_tca * d
           for g_w, c, d in ((g_wx, cx, dx), (g_wy, cy, dy), (g_wz, cz, dz))]
    g_d = [gp * tt + g_tca * c for gp, c in ((gp_x, cx), (gp_y, cy), (gp_z, cz))]
    # u_k = R_k^T g_c, forward.
    v = [(root[0, kk] * g_c[0] + root[1, kk] * g_c[1]) + root[2, kk] * g_c[2]
         for kk in range(3)]
    us = []
    for take, _d, e in rows:
        us.append(v)
        nv = [(e[:, b] * v[0] + e[:, 4 + b] * v[1]) + e[:, 8 + b] * v[2]
              for b in range(3)]
        v = [torch.where(take, x, y) for x, y in zip(nv, v)]
    # w_k backward: each taken level's template and scale terms.
    levels = []
    w = [zero, zero, zero]
    for k in reversed(range(depth)):
        take, d, e = rows[k]
        u = us[k]
        tmpl_terms = torch.stack([
            x for a in range(3)
            for x in (u[a] * w[0], u[a] * w[1], u[a] * w[2], u[a] * scales[k])
        ], dim=1)
        scale_term = (u[0] * e[:, 3] + u[1] * e[:, 7]) + u[2] * e[:, 11]
        levels.append((k, take, d, tmpl_terms, scale_term))
        nw = [e[:, 4 * a + 3] * scales[k]
              + ((e[:, 4 * a] * w[0] + e[:, 4 * a + 1] * w[1])
                 + e[:, 4 * a + 2] * w[2])
              for a in range(3)]
        w = [torch.where(take, x, y) for x, y in zip(nw, w)]
    root_terms = torch.stack([
        x for a in range(3)
        for x in (g_c[a] * w[0], g_c[a] * w[1], g_c[a] * w[2], g_c[a])
    ], dim=1)
    return hit, level, g_d, levels, root_terms, g_rh


def recompute_vjp_plain(dx, dy, dz, lo, hi, grads, root, templates, ratio,
                        radius0, rhit, depth: int):
    """The kernel's backward in eager torch, its reduction order included:
    rays i = (block * THREADS + thread) + s * (blocks * THREADS) by thread
    and s, each thread's column in ray order, the block's columns by the
    tree, the blocks' rows lane by lane and by the lanes' tree, then the
    scale chain. Returns what `recompute_vjp` returns."""
    n, dev = dx.shape[0], dx.device
    slots, blocks = n_slots(depth), grid_blocks(n)
    width = blocks * THREADS
    steps = -(-n // width) if n else 0
    scales, radii = _scales(ratio, radius0, depth)
    tm = templates.reshape(9, 12)
    acc = torch.zeros(width, slots, dtype=torch.float32, device=dev)
    gd = torch.zeros(3, steps * width, dtype=torch.float32, device=dev)
    twelve = torch.arange(12, device=dev)

    def step(x, s):
        x = x[s * width:(s + 1) * width]
        return torch.cat([x, x.new_zeros(width - x.shape[0])])

    for s in range(steps):
        hit, level, g_d, levels, root_terms, g_rh = _ray_terms(
            step(dx, s), step(dy, s), step(dz, s), step(lo, s), step(hi, s),
            [step(g, s) for g in grads], root, tm, scales, rhit, depth,
        )
        for a in range(3):
            gd[a, s * width:(s + 1) * width] = torch.where(hit, g_d[a], 0.0)
        for k, take, d, tmpl_terms, scale_term in levels:
            take = take & hit
            acc.scatter_add_(1, (12 + 12 * d)[:, None] + twelve,
                             torch.where(take[:, None], tmpl_terms, 0.0))
            acc[:, _SCALE_SLOT + k] += torch.where(take, scale_term, 0.0)
        acc[:, :12] += torch.where(hit[:, None], root_terms, 0.0)
        acc.scatter_add_(1, (_SCALE_SLOT + depth + level.long())[:, None],
                         torch.where(hit, g_rh, 0.0)[:, None])
    # The block's tree, then the finish's lanes and tree.
    part = acc.reshape(blocks, THREADS, slots)
    half = THREADS // 2
    while half:
        part = part[:, :half] + part[:, half:2 * half]
        half //= 2
    part = part[:, 0]
    rows = -(-blocks // LANES)
    part = torch.cat([part, part.new_zeros(rows * LANES - blocks, slots)])
    lanes = torch.zeros(LANES, slots, dtype=torch.float32, device=dev)
    for r in part.reshape(rows, LANES, slots):
        lanes = lanes + r
    off = LANES // 2
    while off:
        lanes = lanes[:off] + lanes[off:2 * off]
        off //= 2
    sums = lanes[0]
    g_ratio = torch.zeros((), dtype=torch.float32, device=dev)
    g_next = torch.zeros((), dtype=torch.float32, device=dev)
    for k in reversed(range(depth)):
        g = sums[_SCALE_SLOT + k]
        g_ratio = g_ratio + (g * radii[k] + g_next * radii[k])
        g_next = g * (1.0 + ratio) + g_next * ratio
    return (gd[0, :n], gd[1, :n], gd[2, :n], sums[:12].reshape(3, 4),
            sums[12:_SCALE_SLOT].reshape(9, 3, 4), g_ratio, g_next,
            sums[_SCALE_SLOT + depth:slots])


def _check(dx, dy, dz, lo, hi, grads, root, templates, ratio, radius0, rhit,
           depth: int):
    if not 0 <= depth <= MAX_DEPTH:
        raise ValueError(f"depth {depth} outside 0..{MAX_DEPTH}")
    if len(grads) != 7:
        raise ValueError(f"grads must hold 7 tensors, got {len(grads)}")
    n = dx.shape[0] if isinstance(dx, torch.Tensor) else None
    f32 = torch.float32
    kernels.check_tensors(
        [("dx", dx, f32, (None,))]
        + [(name, x, f32, (n,)) for name, x in (
            ("dy", dy), ("dz", dz), ("lo", lo), ("hi", hi),
            *((f"grads[{j}]", g) for j, g in enumerate(grads)),
        )] + [
            ("root", root, f32, (3, 4)),
            ("templates", templates, f32, (9, 3, 4)),
            ("ratio", ratio, f32, ()),
            ("radius0", radius0, f32, ()),
            ("rhit", rhit, f32, (depth + 1,)),
        ],
        dx, "dx",
    )


def _launch_recompute_vjp(dx, dy, dz, lo, hi, grads, root, templates, ratio,
                          radius0, rhit, depth: int):
    n, slots = dx.shape[0], n_slots(depth)
    blocks = grid_blocks(n)
    gd = torch.empty(3, n, dtype=torch.float32, device=dx.device)
    partials = torch.empty(slots, max(blocks, 1), dtype=torch.float32,
                           device=dx.device)
    out = torch.empty(slots + 2, dtype=torch.float32, device=dx.device)
    fn = kernels.entry_point("recompute_vjp", "sf_recompute_vjp", 22, 2)
    kernels.enqueue(
        fn, "recompute_vjp",
        [dx, dy, dz, lo, hi, *grads, root, templates, ratio, radius0, rhit,
         gd[0], gd[1], gd[2], partials, out],
        [n, depth], dx.device,
    )
    recompute_vjp.launches += 1
    spans.count("gbuffer.vjp_kernel", 1)
    return (gd[0], gd[1], gd[2], out[:12].reshape(3, 4),
            out[12:_SCALE_SLOT].reshape(9, 3, 4), out[slots], out[slots + 1],
            out[_SCALE_SLOT + depth:slots])


def recompute_vjp(dx, dy, dz, lo, hi, grads, root, templates, ratio, radius0,
                  rhit, depth: int):
    """The vector-Jacobian product of one band's recompute.

    dx, dy, dz [N]: the rays' unit directions (the kernel's flat tile
    order); lo, hi [N]: the detached path-code lanes (hi read at depth
    >= 7 only); grads: the 7 outputs' upstream gradients, each [N];
    root [3, 4], templates [9, 3, 4]; ratio, radius0: 0-d radius_ratio and
    root_radius; rhit [depth + 1]: `level_radii`. All float32, contiguous,
    on one device, detached.

    Returns (g_dx, g_dy, g_dz [N], g_root [3, 4], g_templates [9, 3, 4],
    g_ratio, g_radius0 (through the levels' scales; their part through
    rhit is g_rhit's), g_rhit [depth + 1]). CUDA tensors launch the
    kernel (and count `gbuffer.vjp_kernel` in the open span unit), CPU
    tensors run the plain version; any other device raises."""
    _check(dx, dy, dz, lo, hi, grads, root, templates, ratio, radius0, rhit,
           depth)
    args = (dx, dy, dz, lo, hi, list(grads), root, templates, ratio, radius0,
            rhit, depth)
    if dx.device.type == "cuda":
        return _launch_recompute_vjp(*args)
    if dx.device.type != "cpu":
        raise ValueError(
            f"recompute_vjp runs on cuda (the kernel) or cpu (its plain "
            f"version), not on {dx.device}"
        )
    return recompute_vjp_plain(*args)


recompute_vjp.launches = 0


def recompute_forward(dx, dy, dz, lo, hi, root, templates, fractal, cfg):
    """The kernel's forward mode: the recompute's 7 outputs [7, N]
    (min_t, px, py, pz, nx, ny, nz) of rays (dx, dy, dz) with path codes
    (lo, hi). On the CPU the plain chain (`binned._shade_codes`) computes
    them; on CUDA the kernel, which must equal it bit for bit."""
    if dx.device.type != "cuda":
        from sphereflake_tpu_torch.ops.binned import _shade_codes

        with torch.no_grad():
            return torch.stack(_shade_codes(dx, dy, dz, lo, hi, root,
                                            templates, fractal, cfg))
    depth = cfg.max_depth
    with torch.no_grad():
        ratio = fractal.radius_ratio.detach()
        radius0 = fractal.root_radius.detach()
        rhit = level_radii(fractal, depth).detach()
    no_grads = [dx] * 7
    _check(dx, dy, dz, lo, hi, no_grads, root, templates, ratio, radius0,
           rhit, depth)
    out = torch.empty(7, dx.shape[0], dtype=torch.float32, device=dx.device)
    fn = kernels.entry_point("recompute_vjp", "sf_recompute_forward", 11, 2)
    kernels.enqueue(
        fn, "recompute_forward",
        [dx, dy, dz, lo, hi, root.detach(), templates.detach(), ratio,
         radius0, rhit, out],
        [dx.shape[0], depth], dx.device,
    )
    return out
