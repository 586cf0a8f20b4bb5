"""Helpers shared with the per-tile traversal path (plain torch).

Counterpart of the reference package's `ops/pallas_traversal.py`:
`depth_reached_soa` and the path-code resolve (`resolve_codes_soa`,
`resolve_codes`), all plain ops in the reference too. The per-tile
traversal kernel itself is not ported yet (ROADMAP.md queue 2, K4).
"""

from __future__ import annotations

import torch

from sphereflake_tpu_torch.config import FractalParams, RenderConfig
from sphereflake_tpu_torch.ops.intersect import safe_sqrt

_BIG = 3.0e38

TILE_RAYS = 1024  # rays per kernel bundle (one block)


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
