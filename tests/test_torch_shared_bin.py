"""The port's shared bin (`sphereflake_tpu_torch/parallel/shared_bin.py`,
on meshes of repeated CPU devices: the pair kernel's plain version) vs
the reference package's sharded G-buffer (its shared bin, the Pallas
kernel's subset mode in interpret mode), and vs the port's own
single-device frame.

- Against the reference: one run of the reference's
  `render_gbuffer_sharded` at 128x64, depth 2, 32x32 tiles over a 2x2
  mesh, shared through a module fixture; the bars of the port's
  single-device binned tests at that size (`test_torch_render.py`: hit
  masks equal on >= 99.9 % of pixels, min_t and position within
  rtol = atol = 1e-4 on >= 99 % of common hits; the packages differ by
  XLA's multiply-add contraction).
- Within the port: the shared bin equals `render_gbuffer` bit for bit
  (planes and metrics), also where the decode and gather windows cut a
  node's slot range and a tile's segment, and its gradients (the
  single-device recompute, fed bit-equal codes) equal the single-device
  `BinnedGBuffer`'s bit for bit on the reference's gradient frame
  (64x32, depth 2, `tests/test_grad.py:27-36`).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sphereflake_tpu.config import RenderConfig as RefConfig
from sphereflake_tpu.config import default_scene
from sphereflake_tpu.parallel import make_mesh as ref_make_mesh
from sphereflake_tpu.parallel import render_gbuffer_sharded as ref_sharded
from sphereflake_tpu.parallel import shared_bin_supported as ref_supported
from sphereflake_tpu_torch.config import RenderConfig
from sphereflake_tpu_torch.models.sphereflake import child_templates, root_frame
from sphereflake_tpu_torch.ops import binned as port_binned
from sphereflake_tpu_torch.parallel import (
    make_mesh,
    render_gbuffer_shared,
    render_gbuffer_sharded,
    shared_bin_supported,
)
from sphereflake_tpu_torch.render import render_gbuffer

from _torch_helpers import off_center, port_scene

_BINNED = dict(tile_h=32, tile_w=32, algorithm="binned")
_KW = dict(width=128, height=64, max_depth=2, **_BINNED)
_BIG = np.float32(3.0e38)


def _cpu_mesh(shape):
    return make_mesh(["cpu"] * (shape[0] * shape[1]), shape=shape)


@pytest.fixture(scope="module")
def reference_frame():
    """The reference's shared-bin frame (2x2 of its 8 virtual devices)."""
    scene, cfg = default_scene(), RefConfig(**_KW)
    mesh = ref_make_mesh(jax.devices()[:4], shape=(2, 2))
    assert ref_supported(cfg, mesh)
    gb = ref_sharded(scene, cfg, mesh)
    return scene, {
        k: np.asarray(getattr(gb, k))
        for k in ("position", "normal", "min_t", "hit")
    }, {
        f.name: int(getattr(gb.metrics, f.name))
        for f in dataclasses.fields(gb.metrics)
        if f.name != "closest_distance"
    }


def test_shared_bin_matches_reference(reference_frame):
    scene, want, want_m = reference_frame
    cfg, mesh = RenderConfig(**_KW), _cpu_mesh((2, 2))
    assert shared_bin_supported(cfg, mesh)
    got = render_gbuffer_sharded(port_scene(scene), cfg, mesh)
    assert tuple(got.min_t.shape) == want["min_t"].shape == (64, 128)
    hit_g, hit_w = got.hit.numpy(), want["hit"]
    assert (hit_g == hit_w).mean() >= 0.999
    both = hit_g & hit_w
    assert both.mean() > 0.05
    for k in ("min_t", "position"):
        g, w = getattr(got, k).numpy()[both], want[k][both]
        assert np.isclose(g, w, rtol=1e-4, atol=1e-4).mean() >= 0.99
        assert (np.abs(g - w) > 1e-2).mean() <= 2e-3
    assert (got.min_t.numpy()[~hit_g] == _BIG).all()
    assert (got.normal.numpy()[~hit_g] == 0).all()
    m = got.metrics
    assert int(m.max_depth_reached) == want_m["max_depth_reached"]
    assert int(m.overflow) == want_m["overflow"] == 0
    assert int(m.rays_traced) == want_m["rays_traced"]
    # ulp-level camera differences may move a node across a tile edge.
    assert abs(int(m.nodes_visited) - want_m["nodes_visited"]) <= (
        0.01 * want_m["nodes_visited"]
    )


def _assert_frames_equal(got, want):
    for k in ("position", "normal", "min_t", "hit"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    for f in dataclasses.fields(want.metrics):
        a, b = getattr(got.metrics, f.name), getattr(want.metrics, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name


@pytest.mark.parametrize(
    "kw, shape, pose",
    [
        (_KW, (2, 2), "reference"),
        (_KW, (1, 4), "off_center"),
        # a frame whose width does not divide the tile (padded columns)
        (dict(_KW, width=120, height=60), (2, 2), "reference"),
        # depth 7: the hi code lane rides the pair table and the rows
        # (a coarse LOD keeps the plain expansion small)
        (dict(_KW, width=64, height=64, max_depth=7, lod_factor=20.0),
         (2, 1), "reference"),
    ],
)
def test_shared_bin_equals_single_device(kw, shape, pose):
    scene = port_scene(
        off_center(default_scene()) if pose == "off_center"
        else default_scene()
    )
    cfg, mesh = RenderConfig(**kw), _cpu_mesh(shape)
    assert shared_bin_supported(cfg, mesh)
    _assert_frames_equal(render_gbuffer_shared(scene, cfg, mesh),
                         render_gbuffer(scene, cfg, device="cpu"))


def test_windows_cut_slot_ranges_and_segments():
    """At 256x128 depth 3 over 2x4 cells with a 2,048-slot table, the
    256-slot windows of the decode fall inside nodes' slot ranges and
    the gather windows inside tiles' segments; the frame still equals
    the single-device one bit for bit."""
    scene = port_scene(default_scene())
    cfg = RenderConfig(width=256, height=128, max_depth=3, global_cap=1024,
                       **_BINNED)
    mesh = _cpu_mesh((2, 4))
    assert cfg.pair_cap == 2048 and shared_bin_supported(cfg, mesh)
    cap_d = cfg.pair_cap // 8
    with torch.no_grad():
        root = root_frame(scene.camera.position)
        templates = child_templates(scene.fractal)
        nodes, _ovf, minv, corners = port_binned.frame_nodes(
            scene, cfg, root, templates
        )
        geo = port_binned.bin_geometry(nodes, minv, cfg, corners=corners)
        _p, starts, lens, (n_pairs, pair_ovf) = port_binned.binned_pairs(
            scene, cfg, root, templates
        )
    assert int(pair_ovf) == 0
    bounds = np.arange(1, 8) * cap_d
    bounds = bounds[bounds < int(n_pairs)]
    assert len(bounds) >= 2
    first = geo["first"].numpy()
    last = first + geo["counts"].numpy()
    inside_node = [((first < b) & (b < last)).any() for b in bounds]
    s, e = starts.numpy(), starts.numpy() + lens.numpy()
    inside_tile = [((s < b) & (b < e)).any() for b in bounds]
    assert any(inside_node) and any(inside_tile)
    # The windowed decode composes into the full one.
    full = port_binned._decode_tiles_window(geo, cfg, 0, cfg.pair_cap)
    parts = [port_binned._decode_tiles_window(geo, cfg, d * cap_d, cap_d)
             for d in range(8)]
    for k in range(2):
        assert torch.equal(torch.cat([p[k] for p in parts]), full[k])
    _assert_frames_equal(render_gbuffer_sharded(scene, cfg, mesh),
                         render_gbuffer(scene, cfg, device="cpu"))


def test_supported_configs_agree_with_reference():
    cases = [
        (_KW, (2, 2)),
        (dict(_KW, algorithm="pallas"), (2, 2)),
        (dict(_KW, band_tile_rows=1), (2, 2)),
        (_KW, (4, 1)),  # 2 tile rows over 4 cells
        (_KW, (2, 3)),  # pair_cap % 6
        # 4,096 tiles at depth 13: a 20-bit node and 13-bit tile key
        (dict(width=2048, height=2048, max_depth=13, **_BINNED), (2, 2)),
        (dict(width=2048, height=2048, max_depth=4, **_BINNED), (2, 2)),
    ]
    seen = set()
    for kw, shape in cases:
        n = shape[0] * shape[1]
        got = shared_bin_supported(RenderConfig(**kw), _cpu_mesh(shape))
        want = ref_supported(
            RefConfig(**kw), ref_make_mesh(jax.devices()[:n], shape=shape)
        )
        assert got == want, (kw, shape)
        seen.add(got)
    assert seen == {True, False}


def test_sharded_routes_binned_frames_through_the_shared_bin(monkeypatch):
    from sphereflake_tpu_torch.parallel import shared_bin

    calls = []
    real = shared_bin._shared_primal

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(shared_bin, "_shared_primal", counted)
    scene, cfg = port_scene(default_scene()), RenderConfig(**_KW)
    render_gbuffer_sharded(scene, cfg, _cpu_mesh((2, 2)))
    assert calls == [1]
    render_gbuffer_sharded(scene, dataclasses.replace(cfg, band_tile_rows=1),
                           _cpu_mesh((2, 2)))
    assert calls == [1]  # banded: per-block path
    with pytest.raises(ValueError, match="shared bin"):
        render_gbuffer_shared(scene, dataclasses.replace(
            cfg, band_tile_rows=1), _cpu_mesh((2, 2)))


def _leaf_grads(frame_fn, scene):
    """Gradients of a seeded weighted loss on both planes in every leaf."""
    leaves = [x.detach().clone().requires_grad_(True) for x in scene.leaves()]
    from sphereflake_tpu_torch.config import SceneParams

    gb = frame_fn(SceneParams.from_leaves(leaves))
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.random(gb.position.shape, dtype=np.float32))
    loss = torch.sum(w * gb.position) + torch.sum(w * gb.normal) + \
        torch.sum(torch.where(gb.hit, gb.min_t, torch.zeros_like(gb.min_t)))
    return torch.autograd.grad(loss, leaves, allow_unused=True)


def test_shared_bin_gradients_equal_single_device():
    """On the reference's gradient frame (64x32, depth 2, 32x32 tiles:
    1x2 tiles over a 1x2 mesh) every leaf's gradient through the shared
    bin equals the single-device `BinnedGBuffer`'s bit for bit."""
    scene = port_scene(off_center(default_scene(), 0.05, 0.03))
    cfg = RenderConfig(width=64, height=32, max_depth=2, **_BINNED)
    mesh = _cpu_mesh((1, 2))
    assert shared_bin_supported(cfg, mesh)
    got = _leaf_grads(lambda s: render_gbuffer_shared(s, cfg, mesh), scene)
    want = _leaf_grads(lambda s: render_gbuffer(s, cfg, device="cpu"), scene)
    assert any(g is not None and float(g.abs().sum()) > 0 for g in want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert torch.equal(g, w)
