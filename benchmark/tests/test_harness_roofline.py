"""The roofline arithmetic against counts worked out by hand."""

import pytest

from benchmark import spec
from benchmark.frozen import roofline


def test_bound_takes_the_larger_time():
    assert roofline.bound(3.35e12, 0) == (1.0, "bytes")
    assert roofline.bound(0, 67e12) == (1.0, "operations")
    assert roofline.bound(3.35e9, 134e9) == (pytest.approx(2e-3), "operations")


def test_full_grid_work_by_hand():
    # 2 tiles, 10 pairs, depth 6 (8 output rows, 7 pair rows), one call.
    b, o = roofline.full_grid_work(10, 2, deep=False)
    assert b == 2 * 8 * 1024 * 4 + 2 * 16 + 10 * 7 * 4 + 2 * 8 + 64
    assert o == 10 * 1024 * 25 + 2 * 1024 * 60
    b, o = roofline.full_grid_work(10, 2, deep=True, calls=4)
    assert b == 2 * 9 * 1024 * 4 + 2 * 16 + 10 * 8 * 4 + 2 * 8 + 4 * 64


def test_subset_work_by_hand():
    b, o = roofline.subset_work(100, 4, deep=False, calls=1)
    assert b == 4 * 7 * 1024 * 4 + 4 * 16 + 100 * 6 * 4 + 3 * 4 * 4 + 64
    assert o == 100 * 1024 * 24 + 4 * 1024 * 60


def test_roofline_readers_by_hand():
    prof = dict(window_s=0.1, busy_s=0.05, ops=10, units=1,
                by_name={"walk_items_kernel": 1e-4, "item_prologue_kernel": 0.0,
                         "other": 0.05}, idle_gaps={})
    work = dict(pairs=[50_000], tiles=2040, deep=False, calls=1)
    b, o = roofline.full_grid_work(50_000, 2040, False)
    want = 100 * max(b / 3.35e12, o / 67e12) / 1e-4
    ctx = dict(kind="orbit", units=1, spans_ms={}, profile=prof, work=work, notes={})
    assert spec.reader("k1_roofline")(ctx) == pytest.approx(want)
    assert ctx["notes"]["k1_bound"]["by"] == "operations"
    sub = dict(pairs=[30_000, 30_000], ids=[1024, 1024], deep=False)
    b, o = roofline.subset_work(60_000, 2048, False, calls=2)
    rctx = dict(ctx, kind="refresh", work=sub)
    assert spec.reader("k2_roofline")(rctx) == pytest.approx(
        100 * max(b / 3.35e12, o / 67e12) / 1e-4)
    assert spec.reader("k2_roofline")(ctx) is None


def test_candidate_pairs_by_hand():
    """One root sphere straight ahead fills the single tile's middle:
    exactly one candidate (tile, node) pair; a sphere behind the camera
    gives none."""
    import numpy as np
    import torch

    from benchmark.reference import sphereflake as ref

    cfg = dict(width=32, height=32, max_depth=0, lod_factor=70.0, tile_h=32, tile_w=32)
    scene = {"camera": {"position": np.array([0.0, 0.0, 10.0]), "yaw": 0.0,
                        "pitch": 0.0, "roll": 0.0, "fov": 60.0},
             "fractal": {"radius_ratio": 1 / 3, "root_radius": 1.0,
                         "child_rotations_deg": np.zeros((9, 3)),
                         "child_longlat_deg": np.zeros((9, 2))}}
    s = {g: {k: torch.as_tensor(v, dtype=torch.float64) for k, v in grp.items()}
         for g, grp in scene.items()}
    # At z = +10 looking down -z the root (at the origin) is in front.
    g = ref.gbuffer(s, cfg, "cpu", count=True)
    assert g["pairs"].tolist() == [1]
    hit = ref.image(cfg, g["t"]) < ref.BIG
    assert hit[16, 16] and not hit[0, 0]
    assert float(ref.image(cfg, g["t"])[16, 16]) == pytest.approx(9.0, abs=1e-2)
    s["camera"]["position"] = torch.tensor([0.0, 0.0, -10.0], dtype=torch.float64)
    g = ref.gbuffer(s, cfg, "cpu", count=True)
    assert g["pairs"].tolist() == [0]
