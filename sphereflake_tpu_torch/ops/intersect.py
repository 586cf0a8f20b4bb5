"""Ray-sphere intersection primitives (torch).

Counterpart of the reference package's `ops/intersect.py`; this slice
needs only the guarded square root (the ray test itself lives in the
fused kernel, `ops/binned.py`).
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
