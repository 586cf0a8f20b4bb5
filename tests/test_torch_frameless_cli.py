"""The port's frameless CLI branches (`--progressive`, both units;
`--animate --frameless`), the camera-path generator behind them
(`runtime/animate.py`), and the import hygiene of the new modules. All
on the CPU, at small sizes."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from sphereflake_tpu.config import default_scene
from sphereflake_tpu.runtime import animate as ref_animate
from sphereflake_tpu_torch.cli import main
from sphereflake_tpu_torch.config import RenderConfig as PortConfig
from sphereflake_tpu_torch.runtime import animate as port_animate
from sphereflake_tpu_torch.runtime import progressive as port_prog

from _torch_helpers import port_scene

_CFG = PortConfig(width=128, height=96, max_depth=2, tile_h=32, tile_w=32,
                  algorithm="binned")


def _common(*extra):
    return ["--device", "cpu", "--width", "128", "--height", "96",
            "--depth", "2", *extra]


def _png_size(path):
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    return int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")


def _summary(text, prefix):
    lines = [l for l in text.splitlines() if l.startswith(prefix)]
    assert len(lines) == 1, text
    return lines[0]


def test_progressive_tile_unit(tmp_path, capsys):
    """The default frameless unit: whole-tile refresh through the fused
    kernel; 8 steps of 8 tiles cover the 12-tile frame."""
    out = tmp_path / "p.png"
    rc = main(_common("--progressive", "8", "--batch", "8192", "--seed", "3",
                      "-o", str(out)))
    assert rc == 0 and _png_size(out) == (128, 96)
    line = _summary(capsys.readouterr().out, "progressive[tile]:")
    assert "65536 samples (12/12 tiles covered)" in line
    assert "M rays/s, closest sphere: 7." in line


def test_progressive_tile_unit_equals_full_frame_when_covered(tmp_path):
    """At full coverage the progressive output IS `render_frame` of the
    same pose, on the trimmed table (default) and on the untrimmed one."""
    from sphereflake_tpu_torch.config import default_scene as port_default
    from sphereflake_tpu_torch.render import render_frame

    image, gb = render_frame(port_default("cpu"), _CFG, device="cpu")
    want = dict(position=gb.position, normal=gb.normal, min_t=gb.min_t,
                image=image)
    args = ["--progressive", "8", "--batch", "8192"]
    for name, extra in (("t", []), ("p", ["--no-trim-prepared"])):
        npz = tmp_path / f"{name}.npz"
        assert main(_common(*args, *extra, "-o", str(tmp_path / f"{name}.png"),
                            "--gbuffer", str(npz))) == 0
        got = np.load(npz)
        for key, plane in want.items():
            np.testing.assert_array_equal(got[key], plane.numpy())


def test_progressive_sample_unit_and_gbuffer_image_plane(tmp_path, capsys):
    """`--progressive-unit sample`: Sobol pixels through the ray-bundle
    kernel. In composite mode the NPZ carries the image plane; a
    `--snapshot-every` there only prints a note."""
    out, gbuf = tmp_path / "s.png", tmp_path / "s.npz"
    rc = main(_common("--progressive", "3", "--batch", "2048",
                      "--progressive-unit", "sample", "--snapshot-every", "2",
                      "-o", str(out), "--gbuffer", str(gbuf)))
    assert rc == 0 and _png_size(out) == (128, 96)
    cap = capsys.readouterr()
    line = _summary(cap.out, "progressive:")
    assert "6144 samples" in line and "closest sphere: 7." in line
    assert "--snapshot-every only runs in the tile-granular" in cap.err
    assert not list(tmp_path.glob("s_s*.png"))
    data = np.load(gbuf)
    assert data["image"].shape == (96, 128, 3)
    assert data["position"].shape == (96, 128, 3)
    assert data["min_t"].shape == (96, 128)
    touched = np.abs(data["normal"]).sum(-1) > 0
    assert 500 < touched.sum() < 6144


def test_progressive_sample_unit_rejects_ragged_batches(tmp_path, capsys):
    rc = main(_common("--progressive", "2", "--batch", "1000",
                      "--progressive-unit", "sample",
                      "-o", str(tmp_path / "x.png")))
    assert rc == 2 and "multiple of 1024" in capsys.readouterr().err


@pytest.mark.parametrize("mode", ["composite", "normals"])
def test_progressive_snapshots(tmp_path, capsys, mode):
    """`--snapshot-every K`: the in-flight buffer every K steps (never
    after the last step: that is the output itself)."""
    out = tmp_path / "snap.png"
    rc = main(_common("--progressive", "5", "--batch", "3072", "--mode", mode,
                      "--snapshot-every", "2", "-o", str(out)))
    assert rc == 0 and _png_size(out) == (128, 96)
    snaps = sorted(p.name for p in tmp_path.glob("snap_s*.png"))
    assert snaps == ["snap_s00002.png", "snap_s00004.png"]
    assert _png_size(tmp_path / snaps[0]) == (128, 96)
    assert "wrote 2 in-flight snapshots" in capsys.readouterr().out
    # in flight the buffer differs from the finished one
    assert (tmp_path / snaps[0]).read_bytes() != out.read_bytes()


@pytest.mark.parametrize("mode", ["orbit", "approach"])
def test_frameless_animate_cli(tmp_path, capsys, mode):
    """--animate --frameless: the camera moves while the buffer keeps
    accumulating; one PNG per camera step."""
    out = tmp_path / "a.png"
    rc = main(_common("--animate", "2", "--frameless", "--animate-mode", mode,
                      "--batch", "16384", "--speed-factor", "0.1",
                      "-o", str(out)))
    assert rc == 0
    frames = sorted(p.name for p in tmp_path.glob("a_*.png"))
    assert frames == ["a_0000.png", "a_0001.png"]
    assert _png_size(tmp_path / frames[1]) == (128, 96)
    text = capsys.readouterr().out
    assert "frameless frame 1: closest" in text and "refresh/frame 100%" in text
    assert "frameless animate: steady-state" in text
    assert (tmp_path / frames[0]).read_bytes() != (tmp_path / frames[1]).read_bytes()


def test_full_frame_animate_is_not_ported(tmp_path, capsys):
    """The full-frame camera path is ported (one PNG per frame), and so
    is its multi-device form: `animate(mesh=...)` over two CPU cells
    gives the single-device frame."""
    rc = main(_common("--animate", "2", "-o", str(tmp_path / "n.png")))
    assert rc == 0
    assert "animate: 2 frames (orbit)" in capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.glob("*.png")) == [
        "n_0000.png", "n_0001.png"
    ]
    cfg = PortConfig(width=64, height=32, max_depth=1, tile_h=32, tile_w=32,
                     algorithm="binned")
    from sphereflake_tpu_torch.parallel import make_mesh

    mesh = make_mesh(["cpu", "cpu"], shape=(1, 2))
    (sharded, _), = port_animate.animate(
        port_scene(default_scene()), cfg, 1, mesh=mesh
    )
    (single, _), = port_animate.animate(
        port_scene(default_scene()), cfg, 1, device="cpu"
    )
    np.testing.assert_array_equal(sharded, single)


def _always_overflowing(monkeypatch):
    """Make every frameless prepare report dropped pairs."""
    real = port_prog.progressive_prepare

    def crowded(scene, cfg, device="cuda"):
        pairs, starts, lens, _ = real(scene, cfg, device=device)
        return pairs, starts, lens, torch.tensor(7, dtype=torch.int32)

    monkeypatch.setattr(port_prog, "progressive_prepare", crowded)


@pytest.mark.parametrize(
    "branch",
    [
        ["--progressive", "2", "--batch", "2048"],
        ["--progressive", "2", "--batch", "2048", "--no-trim-prepared"],
        ["--progressive", "2", "--batch", "2048", "--progressive-unit", "sample"],
        ["--animate", "2", "--frameless", "--batch", "16384"],
    ],
    ids=["tile-trimmed", "tile-untrimmed", "sample", "animate-frameless"],
)
def test_capacity_ladder_ceiling_is_a_clean_exit_on_every_branch(
    tmp_path, capsys, monkeypatch, branch
):
    """A pair table that still overflows at the global_cap ceiling ends
    in `error:` and exit code 1 — on the camera-path branch too."""
    _always_overflowing(monkeypatch)
    rc = main(_common(*branch, "--global-cap", str(9 << 15),
                      "-o", str(tmp_path / "c.png")))
    assert rc == 1
    err = capsys.readouterr().err
    assert "error: frameless pair table overflows at the capacity ceiling" in err
    if "--progressive" in branch:
        assert f"retrying with global_cap={9 << 16}" in err
    assert not list(tmp_path.glob("*.png"))


def test_frameless_animate_overwrites_stale_tiles():
    """SetView mid-flight (`main.cpp:304`): the camera moves WHILE the
    same buffer keeps accumulating — tiles refreshed under the new view
    change, coverage and the sample count never reset."""
    frames = list(port_animate.frameless_animate(
        port_scene(default_scene()), _CFG, 3, steps_per_frame=2,
        tiles_per_step=3, mode="orbit", composite=False, seed=4, device="cpu",
    ))
    assert len(frames) == 3
    img0, _s0, st0 = frames[0]
    img1, s1, st1 = frames[1]
    assert isinstance(img0, np.ndarray) and img0.shape == (96, 128, 3)
    assert st0["samples_traced"] == 2 * 3 * 1024
    assert st1["samples_traced"] == 2 * st0["samples_traced"]
    assert st1["covered"] >= st0["covered"] > 0
    assert st0["refresh_fraction"] == 0.5
    diff = np.abs(img0 - img1).max(axis=-1)
    assert (diff > 1e-6).any() and (diff == 0).any()
    # the orbit keeps its radius and looks at the origin
    r0 = float(torch.linalg.vector_norm(_s0.camera.position))
    r1 = float(torch.linalg.vector_norm(s1.camera.position))
    assert abs(r0 - r1) < 1e-4
    fwd = port_animate.camera_forward(s1.camera)
    to_origin = -s1.camera.position / torch.linalg.vector_norm(s1.camera.position)
    assert float((fwd * to_origin).sum()) > 0.9999


def test_frameless_animate_composite_frames_are_images():
    frames = list(port_animate.frameless_animate(
        port_scene(default_scene()), _CFG, 1, steps_per_frame=1,
        tiles_per_step=12, mode="approach", device="cpu",
    ))
    image, _scene, stats = frames[0]
    assert image.shape == (96, 128, 3) and np.isfinite(image).all()
    assert 7.0 < stats["closest"] < 7.5 and stats["covered"] > 0.5


def test_frameless_approach_holds_position_on_all_sky_frames():
    """An all-sky frame leaves the closest-distance metric at BIG and
    must NOT fling the camera (3e38 * 0.05 is f32 overflow): the camera
    holds still until something was hit."""
    scene = port_scene(default_scene())
    cam = dataclasses.replace(scene.camera, yaw=scene.camera.yaw + float(np.pi))
    scene = dataclasses.replace(scene, camera=cam)  # looks away: all sky
    cfg = dataclasses.replace(_CFG, width=128, height=64)
    frames = list(port_animate.frameless_animate(
        scene, cfg, n_frames=2, steps_per_frame=1, tiles_per_step=2,
        mode="approach", composite=False, device="cpu",
    ))
    assert len(frames) == 2 and frames[0][2]["closest"] > 1e37
    p0, p1 = frames[0][1].camera.position, frames[1][1].camera.position
    assert bool(torch.isfinite(p1).all()) and torch.equal(p0, p1)


def test_frameless_approach_advances_by_the_speed_law():
    scene = port_scene(default_scene())
    frames = list(port_animate.frameless_animate(
        scene, _CFG, n_frames=2, steps_per_frame=1, tiles_per_step=12,
        mode="approach", speed_factor=0.1, composite=False, device="cpu",
    ))
    p0, p1 = frames[0][1].camera.position, frames[1][1].camera.position
    moved = float(torch.linalg.vector_norm(p1 - p0))
    np.testing.assert_allclose(moved, 0.1 * frames[0][2]["closest"], rtol=1e-4)
    assert frames[1][2]["closest"] < frames[0][2]["closest"]


def test_frameless_animate_rejects_unknown_modes_and_algorithms():
    scene = port_scene(default_scene())
    with pytest.raises(ValueError, match="unknown animation mode"):
        next(port_animate.frameless_animate(
            scene, _CFG, 1, mode="zoom", device="cpu"
        ))
    for algorithm, tile in (("pallas", (32, 32)), ("fast", (32, 32))):
        cfg = dataclasses.replace(
            _CFG, algorithm=algorithm, tile_h=tile[0], tile_w=tile[1]
        )
        with pytest.raises(AssertionError, match="binned"):
            next(port_animate.frameless_animate(scene, cfg, 1, device="cpu"))


def test_camera_helpers_match_reference():
    """`_look_at_origin`, `camera_forward` and the orbit step against the
    reference's (trig differs by ulps between the packages: atol 1e-6)."""
    import jax.numpy as jnp

    ref_scene = default_scene()
    scene = port_scene(ref_scene)
    pos = np.asarray([1.5, -2.0, 0.7], np.float32)
    want = ref_animate._look_at_origin(jnp.asarray(pos))
    got = port_animate._look_at_origin(torch.from_numpy(pos))
    np.testing.assert_allclose([float(x) for x in got],
                               [float(x) for x in want], atol=1e-6)
    np.testing.assert_allclose(
        port_animate.camera_forward(scene.camera).numpy(),
        np.asarray(ref_animate.camera_forward(ref_scene.camera)), atol=1e-6,
    )
    radius = float(np.linalg.norm(np.asarray(ref_scene.camera.position)))
    want_s = ref_animate._orbit_scene(ref_scene, ref_scene.camera, radius, 2, 7)
    got_s = port_animate._orbit_scene(scene, scene.camera, radius, 2, 7)
    for name in ("position", "yaw", "pitch", "roll", "fov"):
        np.testing.assert_allclose(
            getattr(got_s.camera, name).numpy(),
            np.asarray(getattr(want_s.camera, name)), atol=2e-6,
        )


def test_frameless_modules_import_neither_jax_nor_the_jax_package():
    """In a fresh interpreter, the frameless modules and CLI branches
    (tile unit, sample unit, camera path) leave neither `jax` nor
    `sphereflake_tpu` in sys.modules."""
    code = (
        "import sys, os, tempfile\n"
        "import sphereflake_tpu_torch.runtime as rt\n"
        "import sphereflake_tpu_torch.runtime.animate\n"
        "import sphereflake_tpu_torch.runtime.progressive\n"
        "import sphereflake_tpu_torch.ops.sobol, sphereflake_tpu_torch.ops._joekuo\n"
        "import sphereflake_tpu_torch.ops.traversal\n"
        "import sphereflake_tpu_torch.ops.pallas_traversal\n"
        "from sphereflake_tpu_torch.cli import main\n"
        "d = tempfile.mkdtemp()\n"
        "base = ['--device', 'cpu', '--width', '64', '--height', '32',"
        " '--depth', '1', '-o', os.path.join(d, 'f.png')]\n"
        "assert main(base + ['--progressive', '2', '--batch', '2048']) == 0\n"
        "assert main(base + ['--progressive', '2', '--batch', '1024',"
        " '--progressive-unit', 'sample']) == 0\n"
        "assert main(base + ['--animate', '1', '--frameless', '--batch',"
        " '8192']) == 0\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m == 'sphereflake_tpu' or "
        "m.startswith('sphereflake_tpu.'))\n"
        "assert not bad, bad\n"
        "assert hasattr(rt, 'progressive_tiles_step')\n"
        "print('clean')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "clean" in res.stdout
