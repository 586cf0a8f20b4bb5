"""Roofline arithmetic of the pair kernel, frozen.

Copied from the program's `chip_smoke.py` (`bound`, `OPS_PER_TEST`,
`OPS_PER_RAY`, `OPS_PER_TEST_SHADE_ONLY`, the byte counts of the full
grid mode and of the subset mode, `HBM_BYTES_PER_S`, `F32_FLOP_PER_S`)
when the benchmark was written, and frozen here so that a later change
to the program cannot move the yardstick. The work it is applied to is
the benchmark reference's own (distinct candidate (tile, node) pairs),
never the program's pair table.
"""

from __future__ import annotations

# Published peaks of one H100 SXM (NVIDIA data sheet): the bound is
# stated against these, with the card's power limit printed beside it.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# f32 operations of one ray-sphere test in the kernel's loop (5 for the
# dot product, 2 for disc, 5 for the LOD gate, 3 compares + 2 ands,
# 3 for ts, 2 compares + 2 logic for the tie rule, 1 select group).
OPS_PER_TEST = 25
# The subset mode's shade-only walk selects no path code.
OPS_PER_TEST_SHADE_ONLY = OPS_PER_TEST - 1
# Per ray outside the loop: raygen (~30) and the shading epilogue (~30).
OPS_PER_RAY = 60
RAYS_PER_TILE = 1024


def bound(bytes_moved, ops):
    """(bound_s, bound_by) of work that moves `bytes_moved` bytes and does
    `ops` f32 operations: the larger of the two times at the peaks."""
    bytes_s = bytes_moved / HBM_BYTES_PER_S
    ops_s = ops / F32_FLOP_PER_S
    return max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s else "operations")


def full_grid_work(pairs: int, tiles: int, deep: bool, calls: int = 1):
    """(bytes, operations) of the full-grid mode over `tiles` tiles whose
    segments hold `pairs` (tile, node) pairs in all, in `calls` launches
    (one a band): outputs (min_t, code rows, position, normal) and
    metrics written once; the pair columns of every segment read once;
    one start and one length per tile; the 16-scalar camera pack a call."""
    rows_out = 9 if deep else 8
    rows_in = 8 if deep else 7
    bytes_moved = (
        tiles * rows_out * RAYS_PER_TILE * 4 + tiles * 16
        + pairs * rows_in * 4 + tiles * 8 + calls * 64
    )
    ops = pairs * RAYS_PER_TILE * OPS_PER_TEST + tiles * RAYS_PER_TILE * OPS_PER_RAY
    return bytes_moved, ops


def subset_work(pairs: int, ids: int, deep: bool, calls: int = 1):
    """(bytes, operations) of the subset mode, shade only, over `ids`
    tile ids whose segments hold `pairs` pairs: 7 output rows and the
    metrics written once; of the pair columns only the rows the walk
    reads (no code row); each id, its start and its length read once;
    the camera pack a call."""
    rows_in = (8 if deep else 7) - 1
    bytes_moved = (
        ids * 7 * RAYS_PER_TILE * 4 + ids * 16
        + pairs * rows_in * 4 + 3 * ids * 4 + calls * 64
    )
    ops = (pairs * RAYS_PER_TILE * OPS_PER_TEST_SHADE_ONLY
           + ids * RAYS_PER_TILE * OPS_PER_RAY)
    return bytes_moved, ops
