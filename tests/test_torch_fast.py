"""The port's plain-op `fast` traversal (`ops/traversal.py`:
`trace_tile_fast` batched over tiles, `tile_cone`, `_cone_cull`,
`_compact`, `tile_tracer`, `trace_rays`) and the paths it carries
(`render_gbuffer`, `progressive_step` with `algorithm="fast"`) vs the
reference package's, on the same inputs.

Tolerance: both sides are plain f32 ops, but XLA's CPU code contracts
multiply-adds, so hit masks agree on >= 99.9 % of the rays and `min_t`
within rtol = atol = 1e-4 on >= 99 % of the common hits (tangent grazes
flip; `tests/test_pallas.py`'s figures); integer metrics — nodes
visited, overflow, depth reached — came out exactly equal in every case
here and are held to that."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphereflake_tpu import camera as ref_camera
from sphereflake_tpu import render as ref_render
from sphereflake_tpu.config import RenderConfig as RefConfig
from sphereflake_tpu.config import default_scene
from sphereflake_tpu.models.sphereflake import child_templates, root_frame
from sphereflake_tpu.ops import traversal as ref_trav
from sphereflake_tpu.runtime import progressive as ref_prog
from sphereflake_tpu_torch import render as port_render
from sphereflake_tpu_torch.config import RenderConfig as PortConfig
from sphereflake_tpu_torch.convert import tensor_from_numpy
from sphereflake_tpu_torch.ops import traversal as port_trav
from sphereflake_tpu_torch.runtime import progressive as port_prog

from _torch_helpers import off_center, port_scene

_KW = dict(width=64, height=32, tile_h=32, tile_w=32, tile_batch=4,
           max_frontier=128, algorithm="fast")


def _tensors(*arrays):
    return [tensor_from_numpy(np.asarray(x), "cpu") for x in arrays]


def _frame_tiles(scene, cfg):
    xs, ys = ref_camera.pixel_grid(cfg.width, cfg.height)
    dirs = ref_camera.ray_directions(scene.camera, xs, ys, cfg.width, cfg.height)
    return ref_render._tile(dirs, cfg)


def _check_trace(got, want, hit_min=0.999, close_min=0.99):
    hit_g, hit_w = got.hit.numpy(), np.asarray(want.hit)
    assert hit_g.shape == hit_w.shape
    assert (hit_g == hit_w).mean() >= hit_min
    both = hit_g & hit_w
    assert both.sum() > 50
    close = np.isclose(got.min_t.numpy()[both], np.asarray(want.min_t)[both],
                       rtol=1e-4, atol=1e-4)
    assert close.mean() >= close_min
    same = np.abs(
        got.center.numpy()[both] - np.asarray(want.center)[both]
    ).max(axis=-1) < 1e-4
    assert same.mean() >= close_min
    for name in ("max_depth_reached", "nodes_visited", "overflow"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            err_msg=name,
        )
    assert (got.min_t.numpy()[~hit_g] > 1e38).all()


@pytest.mark.parametrize(
    "depth,frontier", [(0, 128), (2, 128), (3, 1024), (3, 63), (4, 100)],
    ids=["d0", "d2", "d3", "d3-overflow", "d4-overflow"],
)
def test_trace_tile_fast_matches_reference(depth, frontier):
    """Tiles of the reference frame, batched in the port, one by one
    (vmap) in the reference; the overflow cases go through `_compact`."""
    scene = default_scene()
    kw = dict(_KW, max_depth=depth, max_frontier=frontier)
    ref_cfg, cfg = RefConfig(**kw), PortConfig(**kw)
    tiles = _frame_tiles(scene, ref_cfg)
    root, templates = root_frame(scene.camera.position), child_templates(
        scene.fractal
    )
    want = jax.vmap(
        lambda d: ref_trav.trace_tile_fast(d, root, templates, scene.fractal,
                                           ref_cfg)
    )(tiles)
    got = port_trav.trace_tile_fast(
        *_tensors(tiles, root, templates), port_scene(scene).fractal, cfg
    )
    _check_trace(got, want)
    assert got.min_t.shape == (2, 1024) and got.overflow.shape == (2,)
    assert (int(got.overflow.sum()) > 0) == (frontier < 128)


def test_random_bundles_match_reference():
    """Arbitrary bundles (not screen tiles) around the direction of the
    fractal, 300 rays each."""
    scene = default_scene()
    kw = dict(_KW, max_depth=3, max_frontier=256)
    ref_cfg, cfg = RefConfig(**kw), PortConfig(**kw)
    rng = np.random.default_rng(5)
    toward = -np.asarray(scene.camera.position)
    toward = toward / np.linalg.norm(toward)
    d = toward + 0.08 * rng.normal(size=(3, 300, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    root, templates = root_frame(scene.camera.position), child_templates(
        scene.fractal
    )
    want = jax.vmap(
        lambda x: ref_trav.trace_tile_fast(x, root, templates, scene.fractal,
                                           ref_cfg)
    )(jnp.asarray(d))
    got = port_trav.trace_tile_fast(
        *_tensors(d, root, templates), port_scene(scene).fractal, cfg
    )
    _check_trace(got, want)
    assert 0.2 < got.hit.float().mean() < 1.0


def test_one_tile_gives_the_reference_shapes_and_equals_its_batch_row():
    scene = default_scene()
    kw = dict(_KW, max_depth=2)
    tiles, root, templates = _tensors(
        _frame_tiles(scene, RefConfig(**kw)),
        root_frame(scene.camera.position), child_templates(scene.fractal),
    )
    fractal, cfg = port_scene(scene).fractal, PortConfig(**kw)
    batch = port_trav.trace_tile_fast(tiles, root, templates, fractal, cfg)
    one = port_trav.trace_tile_fast(tiles[1], root, templates, fractal, cfg)
    assert one.min_t.shape == (1024,) and one.center.shape == (1024, 3)
    assert one.nodes_visited.shape == () and one.overflow.dtype == torch.int32
    for f in dataclasses.fields(one):
        assert torch.equal(getattr(one, f.name), getattr(batch, f.name)[1])


def test_tile_cone_and_cone_cull_match_reference():
    scene = default_scene()
    cfg = RefConfig(**dict(_KW, max_depth=2))
    tiles = _frame_tiles(scene, cfg)
    axis_w, cos_w = jax.vmap(ref_trav.tile_cone)(tiles)
    axis_g, cos_g = port_trav.tile_cone(*_tensors(tiles))
    np.testing.assert_allclose(axis_g.numpy(), np.asarray(axis_w), atol=1e-6)
    np.testing.assert_allclose(cos_g.numpy(), np.asarray(cos_w), atol=1e-6)
    a1, c1 = port_trav.tile_cone(_tensors(tiles)[0][0])
    assert a1.shape == (3,) and c1.shape == ()
    assert torch.equal(a1, axis_g[0]) and torch.equal(c1, cos_g[0])

    rng = np.random.default_rng(3)
    centers = (
        np.asarray(scene.camera.position) * -1.0
        + rng.normal(size=(2, 500, 3)) * 2.0
    ).astype(np.float32)
    lod_sq = np.float32(70.0**2)
    for radius in (np.float32(1.0), np.float32(1.0 / 27.0)):
        want = jax.vmap(
            lambda c, a, ct: ref_trav._cone_cull(c, radius, a, ct, lod_sq)
        )(jnp.asarray(centers), axis_w, cos_w)
        got = port_trav._cone_cull(
            torch.from_numpy(centers), torch.tensor(radius), axis_g, cos_g,
            torch.tensor(lod_sq),
        )
        # a node exactly on the cone's rim may flip
        assert (got.numpy() == np.asarray(want)).mean() >= 0.998
        assert 0 < got.sum() < got.numel()


@pytest.mark.parametrize("cap", [4, 16, 40])
def test_compact_gives_the_reference_indices(cap):
    rng = np.random.default_rng(cap)
    mask = rng.random((3, 40)) < 0.4
    mask[1] = False
    idx_g, valid_g, drop_g = port_trav._compact(torch.from_numpy(mask), cap)
    for b in range(3):
        idx_w, valid_w, drop_w = ref_trav._compact(jnp.asarray(mask[b]), cap)
        valid_w = np.asarray(valid_w)
        np.testing.assert_array_equal(valid_g[b].numpy(), valid_w)
        np.testing.assert_array_equal(
            idx_g[b].numpy()[valid_w], np.asarray(idx_w)[valid_w]
        )
        assert int(drop_g[b]) == int(drop_w) == max(mask[b].sum() - cap, 0)
        # in order: the first `cap` true positions
        np.testing.assert_array_equal(
            idx_g[b].numpy()[valid_w], np.flatnonzero(mask[b])[:cap]
        )


def test_tile_tracer_dispatch():
    cfg = lambda a: PortConfig(**dict(_KW, algorithm=a))
    assert port_trav.tile_tracer(cfg("fast")) is port_trav.trace_tile_fast
    for algorithm in ("pallas", "binned"):
        with pytest.raises(ValueError) as port_err:
            port_trav.tile_tracer(cfg(algorithm))
        with pytest.raises(ValueError) as ref_err:
            ref_trav.tile_tracer(RefConfig(**dict(_KW, algorithm=algorithm)))
        assert str(port_err.value) == str(ref_err.value)
    for algorithm in ("strict", "loose"):
        assert port_trav.tile_tracer(cfg(algorithm)) is port_trav.trace_tile
        assert ref_trav.tile_tracer(
            RefConfig(**dict(_KW, algorithm=algorithm))
        ) is ref_trav.trace_tile
    with pytest.raises(ValueError, match="unknown algorithm"):
        port_trav.tile_tracer(cfg("bogus"))


def test_trace_rays_matches_reference():
    scene = default_scene()
    kw = dict(_KW, max_depth=2)
    ref_cfg = RefConfig(**kw)
    xs, ys = ref_camera.pixel_grid(48, 24)
    dirs = ref_camera.ray_directions(scene.camera, xs, ys, 48, 24)
    want = ref_trav.trace_rays(dirs, scene.camera.position, scene.fractal,
                               ref_cfg)
    ps = port_scene(scene)
    got = port_trav.trace_rays(
        _tensors(dirs)[0], ps.camera.position, ps.fractal, PortConfig(**kw)
    )
    assert got.min_t.shape == (24, 48) and got.center.shape == (24, 48, 3)
    _check_trace(got, want)


@pytest.mark.parametrize(
    "kw",
    [
        dict(_KW, max_depth=1),
        dict(_KW, max_depth=2),
        dict(width=256, height=128, max_depth=2, algorithm="fast",
             tile_batch=16),  # the default 64x128 tile
        dict(_KW, width=96, height=64, max_depth=3, max_frontier=64,
             tile_batch=5),  # overflow; 6 tiles in ragged batches of 5
    ],
    ids=["d1", "d2", "default-tile", "overflow-ragged"],
)
def test_render_gbuffer_fast_matches_reference(kw):
    scene = off_center(default_scene(), 0.05, 0.03)
    want = ref_render.render_gbuffer(scene, RefConfig(**kw))
    got = port_render.render_gbuffer(
        port_scene(scene), PortConfig(**kw), device="cpu"
    )
    hit_g, hit_w = got.hit.numpy(), np.asarray(want.hit)
    assert (hit_g == hit_w).mean() > 0.999
    both = hit_g & hit_w
    tg, tw = got.min_t.numpy()[both], np.asarray(want.min_t)[both]
    agree = np.isclose(tg, tw, rtol=1e-4, atol=1e-4)
    assert agree.mean() > 0.99
    np.testing.assert_allclose(
        got.position.numpy()[both][agree], np.asarray(want.position)[both][agree],
        rtol=1e-4, atol=1e-4,
    )
    # Normals divide a position difference by the winner's radius
    # (3^-level): the tolerance grows with the depth.
    nd = np.abs(got.normal.numpy()[both][agree]
                - np.asarray(want.normal)[both][agree])
    assert (nd.max(axis=-1) < 1e-3 * 3.0 ** kw["max_depth"]).mean() > 0.98
    for name in ("max_depth_reached", "nodes_visited", "overflow",
                 "rays_traced"):
        assert int(getattr(got.metrics, name)) == int(
            getattr(want.metrics, name)
        ), name
    np.testing.assert_allclose(
        float(got.metrics.closest_distance),
        float(want.metrics.closest_distance), rtol=1e-4,
    )
    assert (got.normal.numpy()[~hit_g] == 0).all()
    assert (got.position.numpy()[~hit_g] == 0).all()


def test_fast_frame_needs_a_tile_multiple():
    with pytest.raises(ValueError, match="divisible"):
        PortConfig(width=100, height=60, tile_h=32, tile_w=32,
                   algorithm="fast")


@pytest.mark.parametrize("scramble", ["fixed", "per_sample"])
def test_progressive_step_fast_matches_reference(scramble):
    """Two steps of 1,000 samples (no bundle rule on this branch): the
    pixels chosen are the same bit for bit, planes to tolerance."""
    kw = dict(width=96, height=64, max_depth=2, tile_h=32, tile_w=32,
              algorithm="fast")
    ref_scene, ref_cfg = default_scene(), RefConfig(**kw)
    want = ref_prog.progressive_init(ref_cfg, seed=11)
    for _ in range(2):
        want = ref_prog.progressive_step(
            want, ref_scene, ref_cfg, batch_size=1000, scramble=scramble
        )
    scene, cfg = port_scene(ref_scene), PortConfig(**kw)
    got = port_prog.progressive_init(cfg, seed=11, device="cpu")
    for _ in range(2):
        got = port_prog.progressive_step(
            got, scene, cfg, batch_size=1000, scramble=scramble
        )
    assert got.sample_lo == int(want.sample_lo) == 2000
    assert got.samples_traced == int(want.samples_traced)
    assert int(got.overflow) == int(want.overflow) == 0
    mt_g, mt_w = got.min_t.numpy(), np.asarray(want.min_t)
    touched_g = got.normal.numpy().any(axis=-1)
    touched_w = np.asarray(want.normal).any(axis=-1)
    # The pixels chosen are the cursor's (equal above); a graze may
    # flip a hit on a few of them.
    assert (touched_g == touched_w).mean() >= 0.999
    assert (((mt_g < 1e38) | touched_g) == ((mt_w < 1e38) | touched_w)
            ).mean() >= 0.999
    both = touched_g & touched_w
    assert both.sum() > 200
    for g, w in ((mt_g, mt_w), (got.position.numpy(), np.asarray(want.position))):
        assert np.isclose(g[both], w[both], rtol=1e-4, atol=1e-4).mean() >= 0.99
    np.testing.assert_allclose(
        float(got.closest_distance), float(want.closest_distance), rtol=1e-4
    )
