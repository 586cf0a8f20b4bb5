"""Ray-sphere intersection primitives (torch, differentiable).

Counterpart of the reference package's `ops/intersect.py`. Semantics
match the C++ app's `SIMD_AVX.h:236-270`, with the ray origin at 0
(folded into the root transform, `Sphereflake.cpp:83`):

    tca = dot(center, dir)            reject tca < 0 (center behind)
    d²  = dot(center, center) - tca²  reject d² > radius²
    thc = sqrt(radius² - d²)
    t   = tca - thc                   (negative t for origin-inside
                                       rays is kept, as in the C++ app)

Gradient-safe: sqrt is guarded so tangent hits don't produce NaN grads.
"""

from __future__ import annotations

import torch


def safe_sqrt(x):
    """sqrt(max(x, 0)) with zero gradient at/below 0 (no NaNs)."""
    positive = x > 0
    return torch.where(
        positive,
        torch.sqrt(torch.where(positive, x, torch.ones_like(x))),
        torch.zeros_like(x),
    )


def ray_sphere(tca, d2, radius_sq):
    """Shared-precompute intersection: given tca = dirs·c and
    d² = |c|² − tca², return (hit, t) for a sphere of squared radius
    radius_sq. Broadcasts over any shape."""
    hit = (tca >= 0.0) & (d2 <= radius_sq)
    t = tca - safe_sqrt(radius_sq - d2)
    return hit, t


def ray_sphere_full(dirs, center, radius_sq):
    """Standalone form: dirs [..., 3] (unit), center [3] (origin at 0)."""
    tca = dirs[..., 0] * center[0] + dirs[..., 1] * center[1] + (
        dirs[..., 2] * center[2]
    )
    d2 = (center[0] * center[0] + center[1] * center[1]
          + center[2] * center[2]) - tca * tca
    return ray_sphere(tca, d2, radius_sq)
