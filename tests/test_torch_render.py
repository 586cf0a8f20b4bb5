"""The port's `render_gbuffer` (expansion + binning + fused kernel's
plain version + untile, all on the CPU) vs the reference package's
binned render (Pallas kernel in interpret mode).

Bars: hit masks equal on >= 99.9 % of pixels (the reference's own bar
between two of its traversals, `tests/test_binned.py`); min_t and
position within rtol = atol = 1e-4 on >= 99 % of common hits and off by
more than 1e-2 on <= 0.2 % of them. The two sides differ by ulps in the
camera trig and in multiply-add contraction (XLA's CPU code contracts,
eager torch does not); t = tca - sqrt(tca^2 + r^2 - |c|^2) cancels
catastrophically near silhouettes, so the error has a long thin tail
(measured: ~99.5 % within 1e-4, ~99.9 % within 1e-3) instead of a hard
edge."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphereflake_tpu import render as ref_render
from sphereflake_tpu.config import RenderConfig as RefConfig
from sphereflake_tpu.config import default_scene
from sphereflake_tpu.ops.pallas_traversal import (
    depth_reached_soa as ref_depth_reached,
)
from sphereflake_tpu_torch import render as port_render
from sphereflake_tpu_torch.config import RenderConfig as PortConfig
from sphereflake_tpu_torch.ops.pallas_traversal import depth_reached_soa

from _torch_helpers import off_center, port_scene
from test_binned import dive_scene

_BINNED = dict(tile_h=32, tile_w=32, algorithm="binned")
_BIG = np.float32(3.0e38)


def _both(scene, **kw):
    kw = dict(_BINNED, **kw)
    want = ref_render.render_gbuffer(scene, RefConfig(**kw))
    got = port_render.render_gbuffer(
        port_scene(scene), PortConfig(**kw), device="cpu"
    )
    return got, want


def _check_gbuffer(got, want, shape):
    assert tuple(got.min_t.shape) == shape == tuple(want.min_t.shape)
    assert tuple(got.position.shape) == shape + (3,)
    assert tuple(got.normal.shape) == shape + (3,)
    assert got.hit.dtype == torch.bool
    hit_g, hit_w = got.hit.numpy(), np.asarray(want.hit)
    assert (hit_g == hit_w).mean() >= 0.999
    both = hit_g & hit_w
    assert both.mean() > 0.05
    for g, w in ((got.min_t, want.min_t), (got.position, want.position)):
        g, w = g.numpy()[both], np.asarray(w)[both]
        assert np.isclose(g, w, rtol=1e-4, atol=1e-4).mean() >= 0.99
        # A wrong offset or layout breaks whole tiles, not O(10) pixels.
        assert (np.abs(g - w) > 1e-2).mean() <= 2e-3
    # Sky: min_t = BIG, zero position and normal. Hits: unit normals.
    assert (got.min_t.numpy()[~hit_g] == _BIG).all()
    assert (got.position.numpy()[~hit_g] == 0).all()
    assert (got.normal.numpy()[~hit_g] == 0).all()
    nlen = np.linalg.norm(got.normal.numpy()[hit_g], axis=-1)
    assert np.abs(nlen - 1.0).max() < 1e-4


def _check_metrics(got, want, exact_nodes=False):
    gm, wm = got.metrics, want.metrics
    for m in (gm.max_depth_reached, gm.nodes_visited, gm.overflow,
              gm.rays_traced):
        assert m.dtype == torch.int32 and m.dim() == 0
    assert gm.closest_distance.dtype == torch.float32
    assert int(gm.max_depth_reached) == int(wm.max_depth_reached)
    assert int(gm.overflow) == int(wm.overflow)
    assert int(gm.rays_traced) == int(wm.rays_traced)
    # ulp-level camera differences may move a node across a tile edge.
    assert abs(int(gm.nodes_visited) - int(wm.nodes_visited)) <= (
        0 if exact_nodes else 0.005 * int(wm.nodes_visited)
    )
    np.testing.assert_allclose(
        float(gm.closest_distance), float(wm.closest_distance),
        rtol=1e-4, atol=1e-4,
    )


def test_render_gbuffer_reference_pose():
    got, want = _both(default_scene(), width=128, height=96, max_depth=3)
    _check_gbuffer(got, want, (96, 128))
    _check_metrics(got, want)
    assert int(got.metrics.max_depth_reached) == 3
    assert int(got.metrics.overflow) == 0


def test_render_gbuffer_off_center_camera():
    got, want = _both(
        off_center(default_scene(), 0.1, 0.08), width=128, height=96,
        max_depth=2,
    )
    _check_gbuffer(got, want, (96, 128))
    _check_metrics(got, want)


def test_render_gbuffer_non_tile_multiple_pads_and_crops():
    got, want = _both(default_scene(), width=100, height=60, max_depth=2)
    _check_gbuffer(got, want, (60, 100))
    _check_metrics(got, want)


def test_render_gbuffer_depth7_two_lane_codes():
    """max_depth == 7 at a dive pose: the kernel's deep variant (9 rows
    out) feeds the G-buffer and level 7 is reached through the hi lane."""
    got, want = _both(
        dive_scene(), width=64, height=32, max_depth=7, global_cap=1 << 15
    )
    _check_gbuffer(got, want, (32, 64))
    assert int(got.metrics.max_depth_reached) == 7
    assert int(got.metrics.max_depth_reached) == int(
        want.metrics.max_depth_reached
    )
    assert int(got.metrics.overflow) == int(want.metrics.overflow)


def test_render_gbuffer_depth13_boundary_well_formed():
    """Level 13 is the deepest renderable level (two-lane f32 code
    exactness, `DEEP_MAX_DEPTH`): a dive close enough for the LOD cut to
    admit it produces well-formed geometry there — finite hit distances
    and unit normals at every hit — and reaches the depth the reference
    reaches; max_depth = 14 is rejected with the precision explanation.
    (The per-level compaction cap overflows this deep inside, on both
    sides; the drop policy is farthest-first, so near geometry — what is
    checked here — survives.)"""
    kw = dict(width=64, height=32, max_depth=13, global_cap=1 << 15)
    got, want = _both(dive_scene(hover=1.25e-5), **kw)
    hit = got.hit.numpy()
    assert hit.mean() > 0.5
    assert (hit == np.asarray(want.hit)).mean() >= 0.99
    depth = int(got.metrics.max_depth_reached)
    assert depth >= 12 and depth == int(want.metrics.max_depth_reached)
    mt = got.min_t.numpy()[hit]
    assert np.isfinite(mt).all() and (mt > 0).all() and (mt < 1.0).all()
    nlen = np.linalg.norm(got.normal.numpy()[hit], axis=-1)
    assert np.abs(nlen - 1.0).max() < 1e-3
    assert (got.min_t.numpy()[~hit] == _BIG).all()
    with pytest.raises(ValueError, match="f32"):
        PortConfig(width=64, height=32, max_depth=14, **_BINNED)


def test_interior_pose_pair_count_bounded():
    """Behind-camera nodes must not bin to the ENTIRE tile grid: the
    corner-ray cull keeps an inside-the-geometry pose (camera just above
    a level-1 child, looking outward) within a small multiple of the
    frontal pose's pair count — and at the reference's own count (ulp
    differences in the camera trig may move a node across a tile edge:
    0.5 %)."""
    from sphereflake_tpu.models import sphereflake as ref_model
    from sphereflake_tpu.ops import binned as ref_binned
    from sphereflake_tpu_torch.models import sphereflake as port_model
    from sphereflake_tpu_torch.ops import binned as port_binned

    kw = dict(width=256, height=128, max_depth=4, **_BINNED)

    def counts(scene):
        ps = port_scene(scene)
        _, _, lens, (n_port, ovf) = port_binned.binned_pairs(
            ps, PortConfig(**kw), port_model.root_frame(ps.camera.position),
            port_model.child_templates(ps.fractal),
        )
        assert int(ovf) == 0 and int(lens.sum()) == int(n_port)
        _, _, _, (n_ref, _) = ref_binned.binned_pairs(
            scene, RefConfig(**kw), ref_model.root_frame(scene.camera.position),
            ref_model.child_templates(scene.fractal),
        )
        return int(n_port), int(n_ref)

    scene = default_scene()
    cam = dataclasses.replace(
        scene.camera, position=jnp.asarray([0.0, 0.2, 1.1], jnp.float32)
    )
    n_front, n_front_ref = counts(scene)
    n_inside, n_inside_ref = counts(dataclasses.replace(scene, camera=cam))
    assert n_inside < 4 * n_front, (n_inside, n_front)
    assert abs(n_front - n_front_ref) <= 0.005 * n_front_ref
    assert abs(n_inside - n_inside_ref) <= 0.005 * n_inside_ref


@pytest.mark.parametrize("rows", [2, 1])
def test_banded_matches_whole_frame(rows):
    """Banded rendering (one bin + one kernel launch per band, a Python
    loop) equals the whole-frame render. In eager torch both run the
    same unfused arithmetic on the same rays, so the match is exact."""
    scene = port_scene(default_scene())
    cfg = PortConfig(width=256, height=128, max_depth=3, **_BINNED)
    whole = port_render.render_gbuffer(scene, cfg, device="cpu")
    banded = port_render.render_gbuffer(
        scene, dataclasses.replace(cfg, band_tile_rows=rows), device="cpu"
    )
    assert torch.equal(whole.hit, banded.hit)
    assert torch.equal(whole.min_t, banded.min_t)
    assert torch.equal(whole.position, banded.position)
    assert torch.equal(whole.normal, banded.normal)
    assert int(banded.metrics.overflow) == 0
    assert int(banded.metrics.max_depth_reached) == int(
        whole.metrics.max_depth_reached
    )
    assert float(banded.metrics.closest_distance) == float(
        whole.metrics.closest_distance
    )


def test_banded_matches_reference_banded_metrics():
    """Band offsets reach the camera pack and the binning the same way
    in both packages: equal depth, overflow and (to 0.5 %) pair counts."""
    kw = dict(width=256, height=128, max_depth=3, band_tile_rows=2)
    got, want = _both(default_scene(), **kw)
    _check_gbuffer(got, want, (128, 256))
    _check_metrics(got, want)


def test_tile_untile_match_reference_layout():
    cfg_kw = dict(width=100, height=60, **_BINNED)
    ref_cfg, cfg = RefConfig(**cfg_kw), PortConfig(**cfg_kw)
    img = np.random.default_rng(0).normal(
        size=(cfg.padded_height, cfg.padded_width, 3)
    ).astype(np.float32)
    tiles = port_render._tile(torch.from_numpy(img), cfg)
    np.testing.assert_array_equal(
        tiles.numpy(), np.asarray(ref_render._tile(jnp.asarray(img), ref_cfg))
    )
    back = port_render._untile(tiles, cfg)
    np.testing.assert_array_equal(back.numpy(), img[:60, :100])
    rows = np.random.default_rng(1).normal(
        size=(cfg.tiles_x * cfg.tiles_y, 7, 8, 128)
    ).astype(np.float32)
    got = port_render._untile_rows(torch.from_numpy(rows), cfg)
    want = ref_render._untile_rows(jnp.asarray(rows), ref_cfg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("depth", [2, 6, 7, 10, 13])
def test_depth_reached_matches_reference(depth):
    rng = np.random.default_rng(depth)
    cfg_kw = dict(width=64, height=32, max_depth=depth, **_BINNED)
    for level in range(depth + 1):
        code = 9**level + int(rng.integers(0, 9**level))  # sentinel + path
        lo = np.zeros(64, np.float32)
        hi = np.zeros(64, np.float32)
        lo[5], hi[5] = code % 9**7, code // 9**7
        want = ref_depth_reached(
            jnp.asarray(lo), RefConfig(**cfg_kw), jnp.asarray(hi)
        )
        got = depth_reached_soa(
            torch.from_numpy(lo), PortConfig(**cfg_kw), torch.from_numpy(hi)
        )
        assert int(got) == int(want) == level


def test_grow_capacity_ladder_matches_reference():
    kw = dict(width=256, height=128, max_depth=3, **_BINNED)
    ref_cfg, cfg = RefConfig(**kw), PortConfig(**kw)
    steps = 0
    while True:
        try:
            ref_cfg = ref_render.grow_capacity(ref_cfg)
        except RuntimeError:
            break
        cfg = port_render.grow_capacity(cfg)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
        steps += 1
    assert steps >= 4 and cfg.band_tile_rows == 1
    with pytest.raises(RuntimeError, match="ladder exhausted"):
        port_render.grow_capacity(cfg)


@pytest.mark.parametrize("algorithm", ["strict", "loose"])
def test_unported_algorithms_raise(algorithm):
    """The parity traversals are ported: they render, and their capacity
    ladder is the reference's (max_frontier doubles); only an algorithm
    that does not exist raises."""
    kw = dict(width=128, height=64, tile_h=32, tile_w=32, max_depth=2,
              algorithm=algorithm)
    cfg = PortConfig(**kw)
    scene = port_scene(default_scene())
    gb = port_render.render_gbuffer(scene, cfg, device="cpu")
    assert int(gb.metrics.max_depth_reached) == 2
    assert int(gb.metrics.overflow) == 0
    assert 0.05 < float(gb.hit.float().mean()) < 0.95
    grown = port_render.grow_capacity(cfg)
    assert grown.max_frontier == 2 * cfg.max_frontier
    assert dataclasses.asdict(grown) == dataclasses.asdict(
        ref_render.grow_capacity(RefConfig(**kw))
    )
    with pytest.raises(ValueError, match="unknown algorithm"):
        port_render.render_gbuffer(
            scene, dataclasses.replace(cfg, algorithm="bogus"), device="cpu"
        )


def test_frame_path_makes_no_host_reads(monkeypatch):
    """Nothing between `render_frame`'s entry and its return reads a
    tensor back to the host (`.item()`, `int()`, `.tolist()`,
    `nonzero`, `unique`): shapes are static, metrics stay tensors. The
    kernel's plain version reads max(lens) and is excused — on the card
    its place is taken by the kernel."""
    from sphereflake_tpu_torch.ops import binned

    def forbidden(name):
        def raiser(*a, **k):
            raise AssertionError(f"host read through {name} on the frame path")
        return raiser

    calls = []
    plain = binned.trace_pairs_fused_plain

    def excused(*a, **k):
        with pytest.MonkeyPatch.context() as inner:
            for name in ("item", "tolist", "__int__", "__float__", "__bool__",
                         "__index__", "nonzero", "unique"):
                inner.setattr(torch.Tensor, name, originals[name])
            calls.append(1)
            return plain(*a, **k)

    originals = {
        name: getattr(torch.Tensor, name)
        for name in ("item", "tolist", "__int__", "__float__", "__bool__",
                     "__index__", "nonzero", "unique")
    }
    scene = port_scene(default_scene())
    cfg = PortConfig(width=128, height=96, max_depth=2, **_BINNED)
    monkeypatch.setattr(binned, "trace_pairs_fused_plain", excused)
    for name in originals:
        monkeypatch.setattr(torch.Tensor, name, forbidden(name))
    image, gb = port_render.render_frame(scene, cfg, device="cpu")
    monkeypatch.undo()
    assert calls == [1]
    assert image.shape == (96, 128, 3) and int(gb.metrics.overflow) == 0
