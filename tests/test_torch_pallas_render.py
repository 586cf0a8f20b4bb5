"""The per-tile traversal path of the port — `render_gbuffer` /
`render_frame` / `trace_tiles` / `progressive_step` with
`algorithm="pallas"` (on the CPU: the traversal kernel's plain version)
and the CLI's `--algorithm pallas|fast` — vs the reference package (its
Pallas kernel in interpret mode), at the sizes and to the tolerances of
`tests/test_pallas.py`: hit masks equal on > 99.9 % of the pixels,
`min_t` within rtol = atol = 1e-4 on > 99 % of the common hits, the rest
near-ties (XLA's CPU code contracts multiply-adds); integer metrics
equal."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from sphereflake_tpu import render as ref_render
from sphereflake_tpu.config import RenderConfig as RefConfig
from sphereflake_tpu.config import default_scene
from sphereflake_tpu.runtime import progressive as ref_prog
from sphereflake_tpu_torch import render as port_render
from sphereflake_tpu_torch.cli import main
from sphereflake_tpu_torch.config import RenderConfig as PortConfig
from sphereflake_tpu_torch.ops import pallas_traversal as port_pt
from sphereflake_tpu_torch.runtime import progressive as port_prog

from _torch_helpers import port_scene


def _kw(**kw):
    base = dict(width=64, height=32, max_depth=2, tile_h=32, tile_w=32,
                max_frontier=128, tile_batch=4, algorithm="pallas")
    base.update(kw)
    return base


_FRAMES = {
    "depth0": _kw(max_depth=0),
    "depth1": _kw(max_depth=1),
    "depth2": _kw(),
    "padded": _kw(width=100, height=60, max_depth=3, max_frontier=1024),
}


@pytest.fixture(scope="module")
def frames():
    """One reference G-buffer (interpret mode) and one port G-buffer
    per configuration, shared by the tests of this file."""
    cache = {}

    def get(case):
        if case not in cache:
            kw, scene = _FRAMES[case], default_scene()
            want = ref_render.render_gbuffer(scene, RefConfig(**kw))
            got = port_render.render_gbuffer(
                port_scene(scene), PortConfig(**kw), device="cpu"
            )
            cache[case] = (got, want)
        return cache[case]

    return get


def _check_gbuffer(got, want, depth):
    """`tests/test_pallas.py::test_pallas_matches_fast_path`'s checks
    (`want` may be either package's G-buffer)."""
    hit_g, hit_w = np.asarray(got.hit), np.asarray(want.hit)
    assert hit_g.shape == hit_w.shape
    assert (hit_g == hit_w).mean() > 0.999
    both = hit_g & hit_w
    tg, tw = np.asarray(got.min_t)[both], np.asarray(want.min_t)[both]
    agree = np.isclose(tg, tw, rtol=1e-4, atol=1e-4)
    assert agree.mean() > 0.99
    if not agree.all() and depth <= 2:
        # Disagreements must be near-ties, not wrong hits.
        assert np.abs(tg[~agree] - tw[~agree]).max() < 1e-2
    np.testing.assert_allclose(
        np.asarray(got.position)[both][agree],
        np.asarray(want.position)[both][agree], rtol=1e-4, atol=1e-4,
    )
    nd = np.abs(np.asarray(got.normal)[both][agree]
                - np.asarray(want.normal)[both][agree])
    # Normals divide a position difference by the winner's radius
    # (3^-level): the tolerance grows with the depth, as in the port's
    # other kernel tests.
    assert (nd.max(axis=-1) < 1e-3 * 3.0 ** depth).mean() > 0.98


@pytest.mark.parametrize("case", list(_FRAMES))
def test_render_gbuffer_pallas_matches_reference(frames, case):
    got, want = frames(case)
    kw = _FRAMES[case]
    assert got.min_t.shape == (kw["height"], kw["width"])
    assert got.position.shape == (kw["height"], kw["width"], 3)
    _check_gbuffer(got, want, kw["max_depth"])
    sky = ~got.hit.numpy()
    assert (got.position.numpy()[sky] == 0).all()
    assert (got.normal.numpy()[sky] == 0).all()
    assert (got.min_t.numpy()[sky] > 1e38).all()


@pytest.mark.parametrize("case", list(_FRAMES))
def test_pallas_metrics_match_reference(frames, case):
    got, want = frames(case)
    for name in ("max_depth_reached", "nodes_visited", "overflow",
                 "rays_traced"):
        assert int(getattr(got.metrics, name)) == int(
            getattr(want.metrics, name)
        ), name
    np.testing.assert_allclose(
        float(got.metrics.closest_distance),
        float(want.metrics.closest_distance), rtol=1e-4,
    )
    kw = _FRAMES[case]
    assert int(got.metrics.rays_traced) == kw["width"] * kw["height"]
    assert int(got.metrics.max_depth_reached) == kw["max_depth"]
    assert int(got.metrics.overflow) == 0
    assert got.metrics.nodes_visited.dtype == torch.int32


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_port_pallas_matches_port_fast(frames, depth):
    """The kernel's semantics are `trace_tile_fast`'s: within the port,
    to the tolerances the reference holds its own two paths to."""
    got, _ = frames(f"depth{depth}")
    fast = port_render.render_gbuffer(
        port_scene(default_scene()),
        PortConfig(**_kw(max_depth=depth, algorithm="fast")), device="cpu",
    )
    _check_gbuffer(got, fast, depth)
    assert int(got.metrics.max_depth_reached) == int(
        fast.metrics.max_depth_reached
    )


def test_trace_tiles_generic_dispatch_equals_the_soa_pipeline():
    """`trace_tiles` (AoS, the unified dispatch) and
    `_render_gbuffer_soa` run the same kernel; their directions differ
    in the last ulp ((tl + ex*u) + ey*v against tl + (ex*u + ey*v))."""
    from sphereflake_tpu_torch.camera import (
        pixel_grid,
        ray_directions,
        tile_frustum_planes,
    )

    scene, cfg = port_scene(default_scene()), PortConfig(**_kw())
    xs, ys = pixel_grid(cfg.padded_width, cfg.padded_height, device="cpu")
    tiles = port_render._tile(
        ray_directions(scene.camera, xs, ys, cfg.width, cfg.height), cfg
    )
    planes = tile_frustum_planes(
        scene.camera, cfg.width, cfg.height, cfg.tile_h, cfg.tile_w
    )
    res = port_render.trace_tiles(tiles, planes, scene, cfg)
    gb = port_render.render_gbuffer(scene, cfg, device="cpu")
    hit = port_render._untile(res.hit, cfg)
    assert (hit == gb.hit).float().mean() >= 0.999
    both = (hit & gb.hit).numpy()
    close = np.isclose(
        port_render._untile(res.min_t, cfg).numpy()[both],
        gb.min_t.numpy()[both], rtol=1e-4, atol=1e-4,
    )
    assert close.mean() >= 0.99
    assert int(res.nodes_visited) == int(gb.metrics.nodes_visited)
    with pytest.raises(AssertionError, match="binned path renders whole"):
        port_render.trace_tiles(
            tiles, planes, scene, dataclasses.replace(cfg, algorithm="binned")
        )


def test_render_frame_pallas_matches_reference():
    kw = _kw(width=64, height=64, max_depth=2)
    scene = default_scene()
    want_img, _ = ref_render.render_frame(scene, RefConfig(**kw))
    got_img, gb = port_render.render_frame(
        port_scene(scene), PortConfig(**kw), device="cpu"
    )
    assert got_img.shape == (64, 64, 3) and bool(torch.isfinite(got_img).all())
    diff = np.abs(got_img.numpy() - np.asarray(want_img))
    # SSAO taps next to a silhouette move with a flipped graze.
    assert (diff.max(axis=-1) < 1e-3).mean() > 0.99
    assert float(got_img.max()) > float(got_img.min())
    assert int(gb.metrics.overflow) == 0


def test_pallas_camera_move_changes_image():
    scene, cfg = port_scene(default_scene()), PortConfig(**_kw())
    g1 = port_render.render_gbuffer(scene, cfg, device="cpu")
    cam = dataclasses.replace(scene.camera, yaw=scene.camera.yaw + 0.05)
    g2 = port_render.render_gbuffer(
        dataclasses.replace(scene, camera=cam), cfg, device="cpu"
    )
    assert not torch.allclose(g1.min_t, g2.min_t)


@pytest.mark.parametrize("algorithm", ["pallas", "fast"])
def test_grow_capacity_doubles_max_frontier_on_the_per_tile_paths(algorithm):
    kw = _kw(algorithm=algorithm)
    cfg, ref_cfg = PortConfig(**kw), RefConfig(**kw)
    for _ in range(3):
        cfg = port_render.grow_capacity(cfg)
        ref_cfg = ref_render.grow_capacity(ref_cfg)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert cfg.max_frontier == 1024 and cfg.global_cap == 9 << 13


def test_overflow_is_counted_and_more_capacity_clears_it():
    scene = port_scene(default_scene())
    kw = _kw(width=128, height=96, max_depth=4)
    small = port_render.render_gbuffer(scene, PortConfig(**kw), device="cpu")
    want = ref_render.render_gbuffer(default_scene(), RefConfig(**kw))
    assert int(small.metrics.overflow) == int(want.metrics.overflow) > 0
    cfg = PortConfig(**kw)
    for _ in range(5):
        cfg = port_render.grow_capacity(cfg)
    assert cfg.max_frontier == 4096
    big = port_render.render_gbuffer(scene, cfg, device="cpu")
    assert int(big.metrics.overflow) == 0
    assert int(big.metrics.nodes_visited) > int(small.metrics.nodes_visited)


def _state_to_numpy(state):
    return {
        f.name: np.asarray(getattr(state, f.name))
        for f in dataclasses.fields(state)
    }


@pytest.mark.parametrize("scramble", ["fixed", "per_sample"])
def test_sample_step_pallas_matches_reference(scramble):
    """Two steps of 2,048 samples: the cursor is equal bit for bit (the
    same pixels are chosen), planes to tolerance; `code_hi` is None on
    this branch and depth / overflow come from the kernel's metrics."""
    kw = _kw(width=96, height=64)
    ref_scene, ref_cfg = default_scene(), RefConfig(**kw)
    want = ref_prog.progressive_init(ref_cfg, seed=2**31 + 3)
    for _ in range(2):
        want = ref_prog.progressive_step(
            want, ref_scene, ref_cfg, batch_size=2048, scramble=scramble
        )
    want = _state_to_numpy(want)
    scene, cfg = port_scene(ref_scene), PortConfig(**kw)
    got = port_prog.progressive_init(cfg, seed=2**31 + 3, device="cpu")
    for _ in range(2):
        got = port_prog.progressive_step(
            got, scene, cfg, batch_size=2048, scramble=scramble
        )
    assert got.sample_lo == int(want["sample_lo"]) == 4096
    assert got.sample_hi == int(want["sample_hi"]) == 0
    assert got.samples_traced == int(want["samples_traced"])
    assert int(got.overflow) == int(want["overflow"]) == 0
    touched_g = got.normal.numpy().any(axis=-1)
    touched_w = want["normal"].any(axis=-1)
    assert touched_w.sum() > 300
    assert (touched_g == touched_w).mean() >= 0.999
    both = touched_g & touched_w
    for g, w in ((got.min_t.numpy(), want["min_t"]),
                 (got.position.numpy(), want["position"])):
        assert np.isclose(g[both], w[both], rtol=1e-4, atol=1e-4).mean() >= 0.995
    np.testing.assert_allclose(
        float(got.closest_distance), float(want["closest_distance"]), rtol=1e-4
    )


def test_sample_step_pallas_agrees_with_the_full_frame():
    scene, cfg = port_scene(default_scene()), PortConfig(**_kw(width=96, height=64))
    state = port_prog.progressive_init(cfg, seed=7, device="cpu")
    for _ in range(3):
        state = port_prog.progressive_step(state, scene, cfg, batch_size=2048)
    gb = port_render.render_gbuffer(scene, cfg, device="cpu")
    touched = state.normal.any(dim=-1)
    assert int(touched.sum()) > 500
    close = np.isclose(
        state.position[touched].numpy(), gb.position[touched].numpy(),
        rtol=1e-4, atol=1e-4,
    )
    assert close.mean() >= 0.995
    assert torch.equal(touched, gb.hit & touched)
    with pytest.raises(AssertionError, match="1024"):
        port_prog.progressive_step(state, scene, cfg, batch_size=1000)


@pytest.mark.parametrize("algorithm", ["pallas", "fast"])
def test_sample_step_makes_no_host_reads(monkeypatch, algorithm):
    """Nothing between a sample step's entry and its return reads a
    tensor back to the host. The traversal kernel's plain version reads
    live counts and is excused — on the card the kernel takes its
    place."""
    names = ("item", "tolist", "__int__", "__float__", "__bool__",
             "__index__", "nonzero", "unique")
    originals = {name: getattr(torch.Tensor, name) for name in names}
    kw = _kw(width=96, height=64, algorithm=algorithm)
    scene, cfg = port_scene(default_scene()), PortConfig(**kw)
    st = port_prog.progressive_init(cfg, seed=1, device="cpu")
    plain = port_pt.trace_tiles_pallas_soa_plain
    calls = []

    def excused(*a, **k):
        with pytest.MonkeyPatch.context() as inner:
            for name in names:
                inner.setattr(torch.Tensor, name, originals[name])
            calls.append(1)
            return plain(*a, **k)

    def forbidden(name):
        def raiser(*a, **k):
            raise AssertionError(f"host read through {name} in a sample step")
        return raiser

    monkeypatch.setattr(port_pt, "trace_tiles_pallas_soa_plain", excused)
    for name in names:
        monkeypatch.setattr(torch.Tensor, name, forbidden(name))
    for scramble in ("fixed", "per_sample"):
        st = port_prog.progressive_step(
            st, scene, cfg, batch_size=1024, scramble=scramble
        )
    monkeypatch.undo()
    assert calls == ([1, 1] if algorithm == "pallas" else [])
    assert st.sample_lo == 2048


def _cli(tmp_path, *extra, size=("--width", "64", "--height", "32")):
    out = tmp_path / "frame.png"
    rc = main(["--device", "cpu", *size, "--depth", "2", "-o", str(out),
               *extra])
    return rc, out


@pytest.mark.parametrize("algorithm", ["pallas", "fast"])
def test_cli_renders_the_per_tile_algorithms(tmp_path, capsys, algorithm):
    npz = tmp_path / "g.npz"
    rc, out = _cli(tmp_path, "--algorithm", algorithm, "--tile", "32x32",
                   "--gbuffer", str(npz))
    assert rc == 0 and out.stat().st_size > 500
    text = capsys.readouterr().out
    assert "tiles=1x2" in text and "Depth: 2" in text
    want = port_render.render_gbuffer(
        port_scene(default_scene()),
        PortConfig(**_kw(algorithm=algorithm, max_frontier=1024, tile_batch=16)),
        device="cpu",
    )
    with np.load(npz) as data:
        # (the CLI's timed frame turns the camera by 1e-7 rad)
        hit = data["min_t"] < 1e38
        assert (hit == want.hit.numpy()).mean() >= 0.999
        both = hit & want.hit.numpy()
        assert np.isclose(data["min_t"][both], want.min_t.numpy()[both],
                          rtol=1e-3).mean() >= 0.99
        assert "image" in data.files


def test_cli_default_tile_follows_the_algorithm(tmp_path, capsys):
    size = ("--width", "256", "--height", "128")
    assert _cli(tmp_path, "--algorithm", "fast", size=size)[0] == 0
    assert "tiles=2x2" in capsys.readouterr().out  # 64x128 tiles
    assert _cli(tmp_path, "--algorithm", "pallas", size=size)[0] == 0
    assert "tiles=4x8" in capsys.readouterr().out  # 32x32 tiles
    assert _cli(tmp_path, size=size)[0] == 0  # auto = binned
    assert "tiles=4x8" in capsys.readouterr().out


def test_cli_overflow_ladder_prints_max_frontier(tmp_path, capsys):
    rc = main(["--device", "cpu", "--width", "128", "--height", "96",
               "--depth", "4", "--algorithm", "pallas", "--max-frontier",
               "512", "--mode", "normals", "-o", str(tmp_path / "o.png")])
    assert rc == 0
    err = capsys.readouterr().err
    assert "capacity overflow (2084 nodes dropped)" in err
    assert "max_frontier=1024" in err and "max_frontier=2048" in err
    assert "warning" not in err  # the ladder ended clean


def test_cli_tile_batch_and_max_frontier_reach_the_config(tmp_path, capsys):
    rc, _ = _cli(tmp_path, "--algorithm", "fast", "--tile", "32x32",
                 "--max-frontier", "9", "--tile-batch", "1", "--depth", "2")
    assert rc == 0
    assert "max_frontier=18" in capsys.readouterr().err  # 9 overflowed


def test_cli_depth_8_with_pallas_is_the_reference_error(tmp_path, capsys):
    out = tmp_path / "never.png"
    rc = main(["--device", "cpu", "--algorithm", "pallas", "--depth", "8",
               "-o", str(out)])
    assert rc == 2 and not out.exists()
    assert ("pallas path supports max_depth <= 7 (f32 path-code exactness)"
            in capsys.readouterr().err)


@pytest.mark.parametrize("algorithm", ["pallas", "fast"])
def test_cli_progressive_sample_unit(tmp_path, capsys, algorithm):
    rc, out = _cli(tmp_path, "--algorithm", algorithm, "--tile", "32x32",
                   "--progressive", "2", "--progressive-unit", "sample",
                   "--batch", "2048")
    assert rc == 0 and out.stat().st_size > 300
    text = capsys.readouterr()
    assert "progressive: 4096 samples" in text.out and "note" not in text.err


def test_cli_tile_unit_and_frameless_need_binned(tmp_path, capsys):
    # The tile unit accumulates by pixels on a per-tile algorithm, and
    # says so; the moving camera refuses, as in the reference.
    rc, out = _cli(tmp_path, "--algorithm", "pallas", "--progressive", "1",
                   "--batch", "1024")
    text = capsys.readouterr()
    assert rc == 0 and "progressive: 1024 samples" in text.out
    assert "needs the binned algorithm" in text.err
    rc, _ = _cli(tmp_path, "--algorithm", "pallas", "--animate", "2",
                 "--frameless")
    assert rc == 2
    assert "--frameless needs the binned path" in capsys.readouterr().err
    rc, _ = _cli(tmp_path, "--algorithm", "pallas", "--progressive", "1",
                 "--progressive-unit", "sample", "--batch", "1000")
    assert rc == 2 and "multiple of 1024" in capsys.readouterr().err


def test_per_tile_paths_import_neither_jax_nor_the_jax_package():
    """In a fresh interpreter, the per-tile modules and the CLI's
    `--algorithm pallas|fast` branches (full frame and sample unit)
    leave neither `jax` nor `sphereflake_tpu` in sys.modules."""
    code = (
        "import sys, os, tempfile\n"
        "import sphereflake_tpu_torch.ops.pallas_traversal as pt\n"
        "import sphereflake_tpu_torch.ops.traversal, sphereflake_tpu_torch.kernels\n"
        "from sphereflake_tpu_torch.cli import main\n"
        "d = tempfile.mkdtemp()\n"
        "base = ['--device', 'cpu', '--width', '64', '--height', '32',"
        " '--depth', '1', '--tile', '32x32', '-o', os.path.join(d, 'f.png')]\n"
        "for a in ('pallas', 'fast'):\n"
        "    assert main(base + ['--algorithm', a]) == 0\n"
        "    assert main(base + ['--algorithm', a, '--progressive', '1',"
        " '--progressive-unit', 'sample', '--batch', '1024']) == 0\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m == 'sphereflake_tpu' or "
        "m.startswith('sphereflake_tpu.'))\n"
        "assert not bad, bad\n"
        "assert pt.trace_tiles_pallas_soa.launches == 0\n"
        "print('clean')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "clean" in res.stdout
