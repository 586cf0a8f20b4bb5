"""The port's parity traversal (`ops/traversal.py:trace_tile`, algorithms
"strict" and "loose") and its paths (`trace_rays`, `render_gbuffer`,
`progressive_step`, the CLI), and the port's own golden models
(`models/golden.py`, `models/golden_post.py`), against the reference
package's on the same inputs.

Tolerances. Integer metrics (depth reached, nodes visited, overflow)
are equal. Both sides are plain f32 ops, but XLA's CPU code contracts
multiply-adds and eager torch does not, so a grazing ray may flip and
t differs in the last bits everywhere: hit masks agree on >= 99.9 % of
the rays and `min_t` within rtol = atol = 1e-4 on >= 99 % of the common
hits through depth 3, >= 97 % at depth 4 (level-4 spheres have r² =
1.5e-4, a few ulps of |c|² ≈ 80 apart; with XLA's FMA off the depth-0
case is bit for bit). Against the golden tracer (float64) the port is
held to the reference's own bar (`tests/test_traversal.py`), with one
allowance for the same rounding: a hit mask may differ from the golden
one on 0.05 % of the rays where the reference's allows none (in the
far-camera case one grazing ray of 4,096, which the reference also
misses with XLA's FMA off), and in the full frame 0.05 % of the common
hits may pick the other of two near-coincident spheres. The golden
copies equal the reference's array for array."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphereflake_tpu import render as ref_render
from sphereflake_tpu.cli import main as ref_main
from sphereflake_tpu.config import CameraParams
from sphereflake_tpu.config import FractalParams as RefFractal
from sphereflake_tpu.config import RenderConfig as RefConfig
from sphereflake_tpu.config import default_scene
from sphereflake_tpu.models import golden as ref_golden
from sphereflake_tpu.models import golden_post as ref_golden_post
from sphereflake_tpu.ops import traversal as ref_trav
from sphereflake_tpu.runtime import progressive as ref_prog
from sphereflake_tpu_torch import render as port_render
from sphereflake_tpu_torch.cli import main as port_main
from sphereflake_tpu_torch.config import RenderConfig as PortConfig
from sphereflake_tpu_torch.models import golden as port_golden
from sphereflake_tpu_torch.models import golden_post as port_golden_post
from sphereflake_tpu_torch.ops import traversal as port_trav
from sphereflake_tpu_torch.runtime import progressive as port_prog

from _torch_helpers import port_scene
from test_torch_progressive_samples import (
    _check_against_reference,
    _state_to_numpy,
)

_METRICS = ("max_depth_reached", "nodes_visited", "overflow")


def _default_dirs(w, h):
    cam = CameraParams.reference_default()
    pos = np.asarray(cam.position)
    return (
        ref_golden.camera_rays(pos, float(cam.yaw), float(cam.pitch),
                               float(cam.roll), float(cam.fov), w, h),
        pos,
    )


def _far_dirs():
    """The camera 20 units out on +x looking back (the LOD-cut case of
    `tests/test_traversal.py::test_lod_cut_active`)."""
    n = 64
    ys, zs = np.meshgrid(np.linspace(-0.1, 0.1, n), np.linspace(-0.1, 0.1, n))
    dirs = np.stack([-np.ones_like(ys), ys, zs], axis=-1)
    return dirs / np.linalg.norm(dirs, axis=-1, keepdims=True), np.asarray(
        (20.0, 0.0, 0.0)
    )


# name: (rays, depth, max_frontier, lod, algorithm, strict_lod, close_min)
_CASES = {
    "d0": ("default32", 0, 1024, 70.0, "strict", True, 0.99),
    "d2": ("default64", 2, 1024, 70.0, "strict", True, 0.99),
    "d4": ("default48", 4, 9**4, 70.0, "strict", True, 0.97),
    "d4-small-cap": ("default32", 4, 81, 70.0, "strict", True, 0.97),
    "far-lod-cut": ("far", 1, 1024, 6.0, "strict", True, 0.99),
    "far-full": ("far", 1, 1024, 70.0, "strict", True, 0.99),
    "d3-loose-lod": ("default48", 3, 1024, 70.0, "loose", False, 0.99),
    "d3-loose-name": ("default48", 3, 1024, 70.0, "loose", True, 0.99),
}


def _rays(name):
    if name == "far":
        return _far_dirs()
    return _default_dirs(int(name[7:]), int(name[7:]))


def _case_cfg(kw_cls, case):
    _, depth, frontier, lod, algorithm, strict_lod, _ = _CASES[case]
    return kw_cls(width=128, height=64, max_depth=depth,
                  max_frontier=frontier, lod_factor=lod,
                  algorithm=algorithm, strict_lod=strict_lod)


@pytest.fixture(scope="module")
def traced():
    """Every case through both packages' `trace_rays`, once."""
    out = {}
    ps = port_scene(default_scene())
    for case, spec in _CASES.items():
        dirs64, pos = _rays(spec[0])
        want = ref_trav.trace_rays(
            jnp.asarray(dirs64, jnp.float32), jnp.asarray(pos, jnp.float32),
            RefFractal.reference_default(), _case_cfg(RefConfig, case),
        )
        got = port_trav.trace_rays(
            torch.tensor(dirs64, dtype=torch.float32),
            torch.tensor(pos, dtype=torch.float32), ps.fractal,
            _case_cfg(PortConfig, case),
        )
        out[case] = (dirs64, pos, got, want)
    return out


def _check_vs_reference(got, want, close_min, hit_min=0.999):
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
    for name in _METRICS:
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            err_msg=name,
        )
    assert (got.min_t.numpy()[~hit_g] > 1e38).all()


def _check_vs_golden(res, dirs64, cam_pos, cfg, atol=1e-3, miss_frac=5e-4,
                     cos_tight=0.999, frac_tight=0.99):
    """`tests/test_traversal.py::_compare_to_golden`'s bar, on the
    port's result and the port's golden copy."""
    gold = port_golden.golden_trace(
        dirs64, cam_pos, max_depth=cfg.max_depth, lod_factor=cfg.lod_factor
    )
    hit = res.hit.numpy()
    ghit = np.isfinite(gold.min_t)
    assert (hit != ghit).mean() <= miss_frac
    both = hit & ghit
    t_err = np.abs(res.min_t.numpy()[both] - gold.min_t[both])
    tol = atol + 1e-3 * np.abs(gold.min_t[both])
    assert (t_err <= tol).mean() > 0.99
    assert np.median(t_err) < atol
    inlier = t_err <= tol
    pos, nrm = port_trav.shade_gbuffer(
        torch.tensor(dirs64, dtype=torch.float32), res
    )
    np.testing.assert_allclose(
        pos.numpy()[both][inlier], gold.position[both][inlier],
        atol=5 * atol, rtol=1e-3,
    )
    cos = np.sum(nrm.numpy()[both][inlier] * gold.normal[both][inlier], -1)
    assert (cos > cos_tight).mean() > frac_tight
    assert (cos > 0.9).mean() > 0.999
    return gold


@pytest.mark.parametrize("case", list(_CASES))
def test_trace_rays_matches_reference(traced, case):
    _, _, got, want = traced[case]
    _check_vs_reference(got, want, _CASES[case][-1])
    if case == "d4-small-cap":
        assert int(got.overflow) > 0


@pytest.mark.parametrize("case", ["d0", "d2", "d4", "far-lod-cut",
                                  "far-full"])
def test_trace_rays_matches_golden(traced, case):
    """The reference's golden bar (`tests/test_traversal.py:64-120`): the
    depth-4 case allows 0.2 % boundary flips and a looser normal."""
    dirs64, pos, got, _ = traced[case]
    cfg = _case_cfg(PortConfig, case)
    loose = dict(miss_frac=0.002, cos_tight=0.99, frac_tight=0.97)
    gold = _check_vs_golden(got, dirs64, pos, cfg,
                            **(loose if case == "d4" else {}))
    if case in ("d2", "far-lod-cut"):
        assert int(got.max_depth_reached) == gold.max_depth_reached
    if case == "far-lod-cut":
        # the cut version sees only the root sphere, the full one more
        assert int(got.max_depth_reached) == 0
        assert int(got.hit.sum()) < int(traced["far-full"][2].hit.sum())


def test_loose_strict_fast_equal_at_close_range():
    """At close range with no LOD activity the three gatings agree bit
    for bit (`tests/test_traversal.py::test_loose_mode_close_to_strict`),
    in the port."""
    dirs64, pos = _default_dirs(48, 48)
    ps = port_scene(default_scene())
    kw = dict(width=128, height=64, max_depth=3)
    dirs = torch.tensor(dirs64, dtype=torch.float32)
    cam = torch.tensor(pos, dtype=torch.float32)
    rs, rl, rf = (
        port_trav.trace_rays(dirs, cam, ps.fractal, PortConfig(**kw, **extra))
        for extra in (dict(algorithm="strict", strict_lod=True),
                      dict(algorithm="loose", strict_lod=False),
                      dict(algorithm="fast"))
    )
    for other in (rl, rf):
        assert torch.equal(rs.hit, other.hit)
        assert torch.equal(rs.min_t, other.min_t)
        assert torch.equal(rs.center, other.center)
    assert rs.hit.float().mean() > 0.2


def test_batched_trace_tile_equals_its_tiles_one_by_one():
    """`trace_tile` on [B, R, 3] gives each tile's one-tile result; the
    float temporaries' node chunks do not change the winner."""
    dirs64, pos = _default_dirs(32, 32)
    ps = port_scene(default_scene())
    from sphereflake_tpu_torch.models.sphereflake import (
        child_templates,
        root_frame,
    )

    root = root_frame(torch.tensor(pos, dtype=torch.float32))
    templates = child_templates(ps.fractal)
    tiles = torch.tensor(dirs64, dtype=torch.float32).reshape(4, 256, 3)
    cfg = PortConfig(width=128, height=64, max_depth=3, max_frontier=81)
    batch = port_trav.trace_tile(tiles, root, templates, ps.fractal, cfg)
    assert batch.min_t.shape == (4, 256) and batch.overflow.shape == (4,)
    assert int(batch.overflow.sum()) > 0
    saved = port_trav._STRICT_CHUNK_ELEMS
    try:
        port_trav._STRICT_CHUNK_ELEMS = 1  # node chunks of 64
        chunked = port_trav.trace_tile(tiles, root, templates, ps.fractal, cfg)
    finally:
        port_trav._STRICT_CHUNK_ELEMS = saved
    for t in range(4):
        one = port_trav.trace_tile(tiles[t], root, templates, ps.fractal, cfg)
        assert one.min_t.shape == (256,) and one.overflow.shape == ()
        for f in dataclasses.fields(one):
            assert torch.equal(getattr(one, f.name), getattr(batch, f.name)[t])
            assert torch.equal(getattr(one, f.name),
                               getattr(chunked, f.name)[t])


@pytest.fixture(scope="module")
def frames():
    """`render_gbuffer` with "strict" at 256x128 depth 2 in both packages
    and the golden G-buffer of the same frame."""
    kw = dict(width=256, height=128, max_depth=2, tile_h=64, tile_w=128,
              algorithm="strict")
    want = ref_render.render_gbuffer(default_scene(), RefConfig(**kw))
    got = port_render.render_gbuffer(
        port_scene(default_scene()), PortConfig(**kw), device="cpu"
    )
    gold = port_golden.golden_render_gbuffer(256, 128, max_depth=2)
    return kw, got, want, gold


def test_render_gbuffer_strict_matches_reference(frames):
    _, got, want, _ = frames
    hit_g, hit_w = got.hit.numpy(), np.asarray(want.hit)
    assert (hit_g == hit_w).mean() >= 0.999
    both = hit_g & hit_w
    close = np.isclose(got.min_t.numpy()[both], np.asarray(want.min_t)[both],
                       rtol=1e-4, atol=1e-4)
    assert close.mean() >= 0.99
    # A normal is (p - c) / r: at level 2 (r = 1/9) it carries 9x the
    # position's rounding.
    for plane, tol in (("position", 1e-3), ("normal", 1e-2)):
        near = np.abs(
            getattr(got, plane).numpy()[both]
            - np.asarray(getattr(want, plane))[both]
        ).max(axis=-1) < tol
        assert near.mean() >= 0.999, plane
    for name in ("max_depth_reached", "nodes_visited", "overflow",
                 "rays_traced"):
        assert int(getattr(got.metrics, name)) == int(
            getattr(want.metrics, name)), name
    np.testing.assert_allclose(float(got.metrics.closest_distance),
                               float(want.metrics.closest_distance),
                               rtol=1e-5)


def test_render_gbuffer_strict_matches_golden(frames):
    """`tests/test_traversal.py::test_full_frame_render_matches_golden`'s
    bar, on the port, but for 0.05 % of the common hits (module
    docstring)."""
    kw, got, _, gold = frames
    ghit = np.isfinite(gold.min_t)
    hit = got.hit.numpy()
    assert (hit == ghit).mean() > 0.999
    both = hit & ghit
    t_err = np.abs(got.min_t.numpy()[both] - gold.min_t[both])
    assert (t_err <= 1e-3 + 1e-3 * gold.min_t[both]).mean() >= 0.9995
    assert np.median(t_err) < 1e-4
    cos = np.sum(got.normal.numpy()[both] * gold.normal[both], axis=-1)
    assert (cos > 0.999).mean() > 0.99
    assert int(got.metrics.max_depth_reached) == 2
    assert float(got.metrics.closest_distance) < 10.0
    assert int(got.metrics.rays_traced) == kw["width"] * kw["height"]


def test_tile_batching_invariance():
    """`tests/test_traversal.py::test_tile_batching_invariance` on the
    port: tile_batch changes nothing; another tile shape only rounding."""
    scene = port_scene(default_scene())
    kw = dict(width=256, height=128, max_depth=2, algorithm="strict")
    ga, gb, gc = (
        port_render.render_gbuffer(scene, PortConfig(**kw, **extra), "cpu")
        for extra in (dict(tile_h=64, tile_w=128, tile_batch=1),
                      dict(tile_h=64, tile_w=128, tile_batch=8),
                      dict(tile_h=128, tile_w=256, tile_batch=1))
    )
    assert torch.equal(ga.hit, gb.hit) and torch.equal(ga.min_t, gb.min_t)
    assert (ga.hit == gc.hit).float().mean() > 0.9999
    both = ga.hit & gc.hit
    np.testing.assert_allclose(ga.min_t[both].numpy(), gc.min_t[both].numpy(),
                               atol=1e-5, rtol=1e-5)


def test_golden_copies_equal_the_reference():
    """The port's golden tracer and post chain are the reference's,
    array for array, on a 64x48 frame and on that frame's planes."""
    want = ref_golden.golden_render_gbuffer(64, 48, max_depth=3)
    got = port_golden.golden_render_gbuffer(64, 48, max_depth=3)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name), err_msg=f.name)
    far, pos = _far_dirs()
    for kw in (dict(max_depth=1, lod_factor=6.0), dict(max_depth=2)):
        a = ref_golden.golden_trace(far, pos, **kw)
        b = port_golden.golden_trace(far, pos, **kw)
        for f in dataclasses.fields(a):
            np.testing.assert_array_equal(getattr(b, f.name),
                                          getattr(a, f.name))
    for name in ("reference_child_templates",):
        for x, y in zip(getattr(port_golden, name)(),
                        getattr(ref_golden, name)()):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        port_golden.camera_rays((1.0, 2.0, 3.0), 0.3, -0.2, 0.1, 50.0, 20, 10),
        ref_golden.camera_rays((1.0, 2.0, 3.0), 0.3, -0.2, 0.1, 50.0, 20, 10),
    )

    noise = np.random.default_rng(1).random((8, 8, 3))
    cam = np.asarray(CameraParams.reference_default().position, np.float64)
    args = (want.position, want.normal, noise, 1.0, 1.0, 0.1, 0.04, 24, 32)
    ao_w = ref_golden_post.ssao_golden(*args)
    ao_g = port_golden_post.ssao_golden(*args)
    np.testing.assert_array_equal(ao_g, ao_w)
    assert 0.0 < ao_w.mean() < 1.0
    for direction in ((1.0, 0.0), (0.0, 1.0)):
        bargs = (ao_w, want.position, want.normal, 0.9, 0.0001, direction,
                 24, 32)
        np.testing.assert_array_equal(port_golden_post.blur_golden(*bargs),
                                      ref_golden_post.blur_golden(*bargs))
    cargs = (want.position, ao_w, cam, 48, 64)
    np.testing.assert_array_equal(port_golden_post.composite_golden(*cargs),
                                  ref_golden_post.composite_golden(*cargs))


def _cli(extra, tmp_path, tag):
    return ["--width", "96", "--height", "64", "--depth", "2",
            "--tile", "32x32", *extra,
            "--output", str(tmp_path / f"{tag}.png"),
            "--gbuffer", str(tmp_path / f"{tag}.npz")]


@pytest.mark.parametrize("extra", [
    ["--algorithm", "strict"],
    ["--algorithm", "loose", "--loose-lod"],
], ids=["strict", "loose-lod"])
def test_cli_renders_like_the_reference(tmp_path, capsys, extra):
    assert port_main(["--device", "cpu"] + _cli(extra, tmp_path, "p")) == 0
    out = capsys.readouterr().out
    assert "Depth: 2" in out and "tiles=2x3" in out
    assert ref_main(["--devices", "1"] + _cli(extra, tmp_path, "r")) == 0
    got, want = np.load(tmp_path / "p.npz"), np.load(tmp_path / "r.npz")
    hit_g, hit_w = got["min_t"] < 1e38, want["min_t"] < 1e38
    assert (hit_g == hit_w).mean() >= 0.999
    both = hit_g & hit_w
    assert np.isclose(got["min_t"][both], want["min_t"][both],
                      rtol=1e-4, atol=1e-4).mean() >= 0.99


def test_cli_full_hd_with_the_default_tile_exits_2(tmp_path, capsys):
    """The per-tile XLA paths' default tile, 64x128, does not divide
    1080: both CLIs refuse with the same message."""
    argv = ["--width", "1920", "--height", "1080", "--depth", "6",
            "--algorithm", "strict", "-o", str(tmp_path / "x.png")]
    assert port_main(["--device", "cpu"] + argv) == 2
    port_err = capsys.readouterr().err
    assert ref_main(["--devices", "1"] + argv) == 2
    ref_err = capsys.readouterr().err
    assert "must be divisible by tile 128x64" in port_err
    assert port_err.strip().splitlines()[-1] == ref_err.strip().splitlines()[-1]
    assert not (tmp_path / "x.png").exists()


@pytest.mark.parametrize("algorithm", ["strict", "loose"])
def test_sample_step_matches_reference(algorithm):
    """Two steps of 1,024 Sobol samples, each batch traced as one tile
    (`progressive_step`), in both packages."""
    kw = dict(width=96, height=64, max_depth=2, tile_h=32, tile_w=32,
              algorithm=algorithm, strict_lod=algorithm == "strict")
    ref_scene, ref_cfg = default_scene(), RefConfig(**kw)
    want = ref_prog.progressive_init(ref_cfg, seed=5)
    for _ in range(2):
        want = ref_prog.progressive_step(want, ref_scene, ref_cfg,
                                         batch_size=1024)
    scene, cfg = port_scene(ref_scene), PortConfig(**kw)
    got = port_prog.progressive_init(cfg, seed=5, device="cpu")
    for _ in range(2):
        got = port_prog.progressive_step(got, scene, cfg, batch_size=1024)
    _check_against_reference(got, _state_to_numpy(want))


def test_full_hd_strided_pixels():
    """The pixels `chip_smoke.py`'s strict_path holds against the golden
    tracer: every 17th row and column of the 1080p depth-6 frame at the
    reference pose (7,232 rays). Strict's semantics are per ray, so each
    ray traced as a tile of its own gives the full frame's values there
    (the card renders the full frame in 24x32 tiles). Against the golden
    tracer, the port meets the chip's limits and does as well as the
    reference's strict path on the same rays, to 0.002; against the
    port's binned frame, the chip's strict-vs-binned limits. Prints the
    numbers (`pytest -s`); about a minute on one core, most of it the
    binned frame's plain kernel."""
    import json

    import jax

    import chip_smoke
    from sphereflake_tpu.camera import pixel_grid as ref_pixel_grid
    from sphereflake_tpu.camera import ray_directions as ref_rays
    from sphereflake_tpu.models.sphereflake import child_templates, root_frame
    from sphereflake_tpu_torch.camera import pixel_grid, ray_directions
    from sphereflake_tpu_torch.models import sphereflake as port_model

    W, H, D, S = 1920, 1080, 6, chip_smoke.GOLDEN_STRIDE
    # One ray's frontier is small: 243 slots a level drop nothing here
    # (asserted), so the result is the uncapped per-ray one.
    kw = dict(width=W, height=H, max_depth=D, tile_h=24, tile_w=32,
              max_frontier=243, algorithm="strict")
    ps = port_scene(default_scene())
    xs, ys = pixel_grid(W, H, device="cpu")
    dirs = ray_directions(ps.camera, xs, ys, W, H)[::S, ::S]
    shape = dirs.shape[:2]
    got = port_trav.trace_tile(
        dirs.reshape(-1, 1, 3), port_model.root_frame(ps.camera.position),
        port_model.child_templates(ps.fractal), ps.fractal, PortConfig(**kw),
    )
    assert int(got.overflow.sum()) == 0 and int(got.max_depth_reached.max()) == 5
    hit, min_t = got.hit.reshape(shape).numpy(), got.min_t.reshape(shape).numpy()

    scene = default_scene()
    rx, ry = ref_pixel_grid(W, H)
    rdirs = ref_rays(scene.camera, rx, ry, W, H)[::S, ::S]
    root, templates = root_frame(scene.camera.position), child_templates(
        scene.fractal)
    want = jax.lax.map(
        lambda d: ref_trav.trace_tile(d, root, templates, scene.fractal,
                                      RefConfig(**kw)),
        rdirs.reshape(-1, 1, 3), batch_size=512,
    )
    ref_hit = np.asarray(want.hit).reshape(shape)
    ref_min_t = np.asarray(want.min_t).reshape(shape)

    cam = ps.camera
    cam_pos = cam.position.double().numpy()
    gold = port_golden.golden_trace(
        port_golden.camera_rays(cam_pos, float(cam.yaw), float(cam.pitch),
                                float(cam.roll), float(cam.fov), W, H)[::S, ::S],
        cam_pos, max_depth=D, lod_factor=70.0,
    )
    ghit = np.isfinite(gold.min_t)

    def vs_golden(h, t):
        both = h & ghit
        err = np.abs(t[both] - gold.min_t[both])
        tol = (chip_smoke.GOLDEN_T_ATOL
               + chip_smoke.GOLDEN_T_RTOL * np.abs(gold.min_t[both]))
        return dict(hit_agree=float((h == ghit).mean()),
                    t_close=float((err <= tol).mean()),
                    t_median_err=float(np.median(err)))

    port_g, ref_g = vs_golden(hit, min_t), vs_golden(ref_hit, ref_min_t)
    binned = port_render.render_gbuffer(
        ps, PortConfig(width=W, height=H, max_depth=D, tile_h=32, tile_w=32,
                       algorithm="binned"), device="cpu",
    )
    b_hit = binned.hit[::S, ::S].numpy()
    b_min_t = binned.min_t[::S, ::S].numpy()
    both = hit & b_hit
    vs_binned = dict(
        hit_agree=float((hit == b_hit).mean()), common_hits=int(both.sum()),
        min_t_close=float(np.isclose(min_t[both], b_min_t[both], rtol=1e-4,
                                     atol=1e-4).mean()),
        min_t_within_leaf_radius=float(
            (np.abs(min_t[both] - b_min_t[both]) <= 3.0**-5).mean()),
    )
    print(json.dumps(dict(rays=int(hit.size), port_vs_golden=port_g,
                          reference_vs_golden=ref_g, port_vs_binned=vs_binned,
                          port_vs_reference_hit=float((hit == ref_hit).mean()),
                          golden_hit_fraction=float(ghit.mean()))))

    assert hit.size == 7232 and int(np.asarray(want.overflow).sum()) == 0
    # Level-5 silhouettes are rounding-decided in f32 (r^2 = 1.7e-5 is
    # about two ulps of |c|^2 ~ 64): the two packages' hit masks differ
    # on 0.30 % of these rays, each package's from the golden on 0.26-0.29 %.
    assert (hit == ref_hit).mean() >= 0.995
    assert port_g["hit_agree"] >= chip_smoke.GOLDEN_HIT_MIN
    assert port_g["t_close"] >= chip_smoke.GOLDEN_T_CLOSE_MIN
    assert port_g["t_median_err"] < chip_smoke.GOLDEN_T_MEDIAN_MAX
    for key in ("hit_agree", "t_close"):
        assert port_g[key] >= ref_g[key] - 0.002, key
    assert vs_binned["hit_agree"] >= chip_smoke.STRICT_BINNED_HIT_MIN
    assert vs_binned["min_t_close"] >= chip_smoke.STRICT_BINNED_T_CLOSE_MIN
    assert (vs_binned["min_t_within_leaf_radius"]
            >= chip_smoke.STRICT_BINNED_T_LEAF_MIN)


def test_ray_sphere_matches_reference():
    """`ops/intersect.py`'s `ray_sphere` (the shared-precompute form the
    traversal calls) and `ray_sphere_full`, on rays around a sphere's
    silhouette, bit for bit: a handful of plain f32 ops."""
    from sphereflake_tpu.ops import intersect as ref_isect
    from sphereflake_tpu_torch.ops import intersect as port_isect

    rng = np.random.default_rng(4)
    center = np.array([0.3, -0.2, 5.0], np.float32)
    d = center / np.linalg.norm(center) + 0.1 * rng.normal(size=(500, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    r_sq = np.float32(0.5)
    hit_w, t_w = ref_isect.ray_sphere_full(jnp.asarray(d), jnp.asarray(center),
                                           r_sq)
    hit_g, t_g = port_isect.ray_sphere_full(torch.from_numpy(d),
                                            torch.from_numpy(center),
                                            torch.tensor(r_sq))
    assert 0.2 < hit_g.float().mean() < 0.8
    np.testing.assert_array_equal(hit_g.numpy(), np.asarray(hit_w))
    np.testing.assert_allclose(t_g.numpy(), np.asarray(t_w), rtol=1e-5,
                               atol=1e-5)
    tca = (d @ center).astype(np.float32)
    d2 = (np.float32(center @ center) - tca * tca).astype(np.float32)
    for radius_sq in (r_sq, np.float32(4.0) * r_sq):
        h_w, tt_w = ref_isect.ray_sphere(jnp.asarray(tca), jnp.asarray(d2),
                                         radius_sq)
        h_g, tt_g = port_isect.ray_sphere(torch.from_numpy(tca),
                                          torch.from_numpy(d2),
                                          torch.tensor(radius_sq))
        np.testing.assert_array_equal(h_g.numpy(), np.asarray(h_w))
        np.testing.assert_array_equal(tt_g.numpy(), np.asarray(tt_w))
