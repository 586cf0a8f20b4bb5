"""Helpers shared with the per-tile traversal path (plain torch).

Counterpart of the reference package's `ops/pallas_traversal.py`. This
slice needs only `depth_reached_soa`; the per-tile traversal kernel and
`resolve_codes_soa` are not ported yet (ROADMAP.md queue 2, K4; queue
1, M5).
"""

from __future__ import annotations

import torch

from sphereflake_tpu_torch.config import RenderConfig


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
