"""Per-ray trace results and their shading (plain torch).

Counterpart of the reference package's `ops/traversal.py`, as far as
the frameless sample path needs it: `TraceResult` and `shade_gbuffer`.
The reference's plain-op tracers (`tile_tracer` and the `fast` /
`strict` / `loose` traversals) are not ported yet (ROADMAP.md M10).
"""

from __future__ import annotations

import dataclasses

import torch

from sphereflake_tpu_torch.ops.intersect import safe_sqrt

_BIG = 3.0e38  # ~FLT_MAX: the C++ app's miss sentinel


@dataclasses.dataclass
class TraceResult:
    """Per-ray hit state — the G-buffer precursor plus live metrics
    (the C++ app's counters, `Sphereflake.h:30-58`)."""

    min_t: torch.Tensor  # [...]: hit distance, _BIG where sky
    center: torch.Tensor  # [..., 3] center of the winning sphere
    hit: torch.Tensor  # [...] bool
    max_depth_reached: torch.Tensor  # [] int32 (`Sphereflake.h:157-160`)
    nodes_visited: torch.Tensor  # [] int32: pair slots tested
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
