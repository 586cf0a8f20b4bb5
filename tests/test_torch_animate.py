"""The port's full-frame camera path (`runtime/animate.py:animate`) and
the CLI's `--animate N` and `--profile DIR`, against the reference
package's on the same inputs.

Tolerances: the scene at every frame (camera position, yaw, pitch)
within rtol 1e-5 of the reference's (f32 trigonometry on both sides);
the composite images through the plain-op `fast` traversal and the post
chain within 1e-3 on >= 99 % of the pixel channels (a grazing ray may
flip, and SSAO taps follow it). Within the port, the binned path's
frames equal `render_frame` at the yielded scenes bit for bit.

The one intended difference from the reference: on an all-sky frame
the approach holds the camera, where the reference steps it by
speed_factor * 3e38 (`sphereflake_tpu/runtime/animate.py:280-289`); a
test pins both behaviours."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphereflake_tpu import render as ref_render
from sphereflake_tpu.config import RenderConfig as RefConfig
from sphereflake_tpu.config import default_scene
from sphereflake_tpu.runtime import animate as ref_animate
from sphereflake_tpu_torch import render as port_render
from sphereflake_tpu_torch.cli import main
from sphereflake_tpu_torch.config import RenderConfig as PortConfig
from sphereflake_tpu_torch.runtime import animate as port_animate

from _torch_helpers import port_scene

_FAST = dict(width=96, height=64, max_depth=2, tile_h=32, tile_w=32,
             algorithm="fast")


def _sky_scene(scene):
    """The camera 20 units up the z axis, looking away from the fractal
    (forward = +z): every ray misses."""
    cam = dataclasses.replace(
        scene.camera, position=jnp.asarray([0.0, 0.0, 20.0], jnp.float32),
        yaw=jnp.float32(0.0), pitch=jnp.float32(np.pi),
    )
    return dataclasses.replace(scene, camera=cam)


@pytest.fixture(scope="module")
def reference_paths():
    """Three frames of each mode through the reference's `animate`."""
    cfg = RefConfig(**_FAST)
    return {
        mode: [
            (np.asarray(img), sc) for img, sc in ref_animate.animate(
                default_scene(), cfg, 3, mode=mode, speed_factor=0.2
            )
        ]
        for mode in ("orbit", "approach")
    }


@pytest.mark.parametrize("mode", ["orbit", "approach"])
def test_animate_matches_reference(reference_paths, mode):
    got = list(port_animate.animate(
        port_scene(default_scene()), PortConfig(**_FAST), 3, mode=mode,
        speed_factor=0.2, device="cpu",
    ))
    want = reference_paths[mode]
    assert len(got) == len(want) == 3
    for (img_g, sc_g), (img_w, sc_w) in zip(got, want):
        for name in ("position", "yaw", "pitch"):
            np.testing.assert_allclose(
                getattr(sc_g.camera, name).numpy(),
                np.asarray(getattr(sc_w.camera, name)), rtol=1e-5, atol=1e-6,
                err_msg=name,
            )
        assert img_g.shape == img_w.shape == (64, 96, 3)
        assert (np.abs(img_g - img_w) <= 1e-3).mean() >= 0.99
    positions = [sc.camera.position.numpy() for _, sc in got]
    assert not np.allclose(positions[0], positions[1])
    if mode == "approach":
        # toward the fractal: the distance to the origin falls
        dist = [np.linalg.norm(p) for p in positions]
        assert dist[0] > dist[1] > dist[2]


@pytest.mark.parametrize("mode", ["orbit", "approach"])
def test_binned_animate_equals_render_frame(mode):
    cfg = PortConfig(width=96, height=64, max_depth=2, tile_h=32, tile_w=32,
                     algorithm="binned")
    frames = list(port_animate.animate(
        port_scene(default_scene()), cfg, 2, mode=mode, device="cpu"
    ))
    for img, sc in frames:
        want, _ = port_render.render_frame(sc, cfg, device="cpu")
        np.testing.assert_array_equal(img, want.numpy())
    normals = list(port_animate.animate(
        port_scene(default_scene()), cfg, 1, mode=mode, composite=False,
        device="cpu",
    ))
    gb = port_render.render_gbuffer(normals[0][1], cfg, device="cpu")
    from sphereflake_tpu_torch.utils.image import shade_normals

    np.testing.assert_array_equal(normals[0][0],
                                  shade_normals(gb.normal, gb.hit))


def test_all_sky_approach_holds_the_camera():
    """The port holds an all-sky camera; the reference (same setup)
    flings it to about 1e37 — the intended difference, pinned."""
    ref_scene = _sky_scene(default_scene())
    cfg = dict(_FAST, max_depth=1)
    want = [sc for _, sc in ref_animate.animate(
        ref_scene, RefConfig(**cfg), 2, mode="approach"
    )]
    start = np.asarray(ref_scene.camera.position)
    assert np.asarray(want[1].camera.position)[2] > 1e36

    got = list(port_animate.animate(
        port_scene(ref_scene), PortConfig(**cfg), 3, mode="approach",
        device="cpu",
    ))
    for img, sc in got:
        assert not img.any()  # all sky: a black composite
        pos = sc.camera.position.numpy()
        assert np.isfinite(pos).all()
        np.testing.assert_array_equal(pos, start)


def test_all_sky_composite_matches_the_reference():
    """An all-sky frame: the SSAO radius law gives the multiplier times
    the 3e38 miss sentinel. The post chain writes the reference's black
    image (its taps must stay inside the G-buffer, on the card too)."""
    from sphereflake_tpu.ops.noise import ssao_noise_texture
    from sphereflake_tpu.ops.post import postprocess as ref_post
    from sphereflake_tpu_torch.ops.post import postprocess as port_post

    scene = _sky_scene(default_scene())
    cfg = dict(_FAST, max_depth=1)
    zeros = np.zeros((64, 96, 3), np.float32)
    noise = ssao_noise_texture(RefConfig(**cfg).noise_size)
    want = ref_post(jnp.asarray(zeros), jnp.asarray(zeros),
                    jnp.float32(3e38), scene, RefConfig(**cfg),
                    jnp.asarray(noise))
    got = port_post(torch.from_numpy(zeros), torch.from_numpy(zeros),
                    torch.tensor(3e38), port_scene(scene), PortConfig(**cfg),
                    torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got.numpy().any()


def test_overflowing_frame_is_rerendered_one_rung_up(monkeypatch):
    """A frame that overflows is rendered again at the next rung of the
    capacity ladder, and the larger config stays for the later frames:
    the same sequence of renders as the reference's."""
    kw = dict(_FAST, max_depth=3, max_frontier=9)

    def recording(module, log):
        real = module.render_frame

        def render_frame(scene, cfg, *args, **kwargs):
            out = real(scene, cfg, *args, **kwargs)
            log.append((cfg.max_frontier, int(out[1].metrics.overflow) > 0))
            return out

        monkeypatch.setattr(module, "render_frame", render_frame)

    got, want = [], []
    recording(port_render, got)
    recording(ref_render, want)
    list(port_animate.animate(port_scene(default_scene()), PortConfig(**kw),
                              3, device="cpu"))
    list(ref_animate.animate(default_scene(), RefConfig(**kw), 3))
    assert got == want
    assert got[0] == (9, True) and len(got) > 3
    first_clean = next(i for i, (_, ovf) in enumerate(got) if not ovf)
    assert [f for f, _ in got[first_clean:]] == [got[first_clean][0]] * 3


def _cli(*extra):
    # tests/test_cli.py's `_common`, without the multi-device pin
    return ["--device", "cpu", "--width", "96", "--height", "64",
            "--depth", "2", "--algorithm", "fast", "--tile", "32x32", *extra]


def test_cli_animate_orbit_and_approach(tmp_path, capsys):
    """`tests/test_cli.py::test_animate_orbit_and_approach` on the port."""
    out = tmp_path / "anim.png"
    rc = main(_cli("--animate", "3", "--animate-mode", "orbit",
                   "--mode", "normals", "--output", str(out)))
    assert rc == 0
    frames = sorted(tmp_path.glob("anim_*.png"))
    assert len(frames) == 3
    # Orbit frames must actually differ (the camera moved).
    assert frames[0].read_bytes() != frames[1].read_bytes()
    assert "animate: 3 frames (orbit) in" in capsys.readouterr().out

    rc = main(_cli("--animate", "2", "--animate-mode", "approach",
                   "--mode", "normals", "--output", str(tmp_path / "dive.png")))
    assert rc == 0
    assert len(sorted(tmp_path.glob("dive_*.png"))) == 2
    text = capsys.readouterr().out
    assert "animate: 2 frames (approach)" in text
    assert "dive_0000.png.." in text and text.rstrip().endswith("dive_0001.png")


def test_cli_profile_writes_a_trace(tmp_path, capsys):
    """`tests/test_cli.py::test_profile_writes_a_trace` on the port: a
    torch.profiler trace of the timed frames, CPU activity only here."""
    prof = tmp_path / "trace"
    out = tmp_path / "prof.png"
    rc = main(_cli("--output", str(out), "--frames", "2",
                   "--profile", str(prof)))
    assert rc == 0
    assert out.stat().st_size > 0
    found = []
    for root, _dirs, files in os.walk(prof):
        found += [os.path.join(root, f) for f in files]
    assert found, "profiler trace directory is empty"
    with open(prof / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert "wrote profiler trace" in capsys.readouterr().out
