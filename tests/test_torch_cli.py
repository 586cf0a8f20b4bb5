"""The port's CLI (full-frame branch) and its import hygiene."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from sphereflake_tpu_torch.cli import build_parser, main

import _torch_helpers  # noqa: F401  (one torch thread per test worker)


def _common(*extra):
    return ["--device", "cpu", "--width", "96", "--height", "64",
            "--depth", "2", *extra]


def _read_png_size(path):
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    return int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")


def test_render_writes_png_and_gbuffer_with_image_plane(tmp_path, capsys):
    out, gbuf = tmp_path / "a.png", tmp_path / "g.npz"
    assert main(_common("--output", str(out), "--gbuffer", str(gbuf))) == 0
    assert _read_png_size(out) == (96, 64)
    data = np.load(gbuf)
    assert data["position"].shape == (64, 96, 3)
    assert data["normal"].shape == (64, 96, 3)
    assert data["min_t"].shape == (64, 96)
    # composite mode: the NPZ carries the image plane (the fitting target)
    assert data["image"].shape == (64, 96, 3)
    text = capsys.readouterr().out
    assert "tiles=2x3" in text and "device=cpu" in text
    assert "FPS:" in text and "Depth: 2" in text and "Closest sphere: 7." in text


@pytest.mark.parametrize("mode", ["normals", "ao"])
def test_debug_modes_write_png_without_image_plane(tmp_path, mode):
    out, gbuf = tmp_path / "m.png", tmp_path / "g.npz"
    rc = main(_common("--mode", mode, "--algorithm", "binned", "--frames", "2",
                      "-o", str(out), "--gbuffer", str(gbuf)))
    assert rc == 0 and _read_png_size(out) == (96, 64)
    assert "image" not in np.load(gbuf)


def test_camera_flags_move_the_image(tmp_path):
    a, b = tmp_path / "a.npz", tmp_path / "b.npz"
    assert main(_common("-o", str(tmp_path / "a.png"), "--gbuffer", str(a))) == 0
    assert main(_common(
        "-o", str(tmp_path / "b.png"), "--gbuffer", str(b), "--yaw", "0.95",
        "--pitch", "-1.3", "--roll", "0.1", "--fov", "50", "--lod", "60",
        "--camera-pos=-5.0,-7.0,1.0", "--global-cap", str(9 << 12),
    )) == 0
    assert not np.array_equal(np.load(a)["min_t"], np.load(b)["min_t"])


def test_bad_tile_is_an_error(tmp_path, capsys):
    rc = main(_common("--tile", "64x128", "-o", str(tmp_path / "x.png")))
    assert rc == 2
    assert "tile_h * tile_w == 1024" in capsys.readouterr().err


def test_capacity_retry_loop_recovers_from_overflow(tmp_path, capsys):
    """A global_cap far too small overflows; the CLI climbs the capacity
    ladder until the frame is clean and says so on stderr."""
    rc = main(["--device", "cpu", "--width", "128", "--height", "64",
               "--depth", "4", "--global-cap", "1024",
               "-o", str(tmp_path / "o.png")])
    assert rc == 0
    err = capsys.readouterr().err
    assert "capacity overflow" in err and "global_cap=2048" in err
    assert "warning" not in err  # the final frame dropped nothing


def test_unported_flags_are_not_declared():
    """Every flag of the reference's CLI is declared: since the
    multi-device layer is ported, `--mesh`, `--devices`, `--platform`
    and `--frame-parallel` are too (`tests/test_torch_sharded.py` drives
    them)."""
    flags = {s for a in build_parser()._actions for s in a.option_strings}
    for flag in ("--mesh", "--devices", "--platform", "--frame-parallel"):
        assert flag in flags
    platform = next(a for a in build_parser()._actions
                    if a.dest == "platform")
    assert tuple(platform.choices) == ("auto", "cpu")
    assert "--device" in flags and "--frames" in flags
    # fitting and checkpoints are ported
    for flag in ("--fit", "--fit-steps", "--fit-lr", "--fit-params",
                 "--fit-loss", "--checkpoint", "--resume"):
        assert flag in flags
    # the frameless branches are ported
    for flag in ("--progressive", "--batch", "--progressive-unit",
                 "--snapshot-every", "--no-trim-prepared", "--seed",
                 "--animate", "--animate-mode", "--speed-factor",
                 "--frameless"):
        assert flag in flags
    # so are the per-tile paths, the parity traversals and the profiler
    for flag in ("--max-frontier", "--tile-batch", "--loose-lod",
                 "--profile"):
        assert flag in flags
    algorithm = next(a for a in build_parser()._actions
                     if a.dest == "algorithm")
    assert tuple(algorithm.choices) == (
        "auto", "binned", "pallas", "fast", "strict", "loose"
    )


def test_cuda_without_a_card_is_an_error_not_a_cpu_run(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = tmp_path / "never.png"
    assert main(["--width", "64", "--height", "32", "-o", str(out)]) == 2
    assert "cuda" in capsys.readouterr().err and not out.exists()

    from sphereflake_tpu_torch.config import RenderConfig, default_scene
    from sphereflake_tpu_torch.render import render_frame, render_gbuffer

    cfg = RenderConfig(width=64, height=32, tile_h=32, tile_w=32,
                       algorithm="binned", max_depth=1)
    scene = default_scene(device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        render_frame(scene, cfg)  # default device: "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        render_gbuffer(scene, cfg)


def test_port_imports_neither_jax_nor_the_jax_package():
    """In a fresh interpreter, importing every module of the port (and
    running a CPU frame through the CLI) leaves neither `jax` nor
    `sphereflake_tpu` in sys.modules."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import sphereflake_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    if not n.endswith('__main__'):\n"
        "        importlib.import_module(n)\n"
        "from sphereflake_tpu_torch.cli import main\n"
        "import tempfile, os\n"
        "d = tempfile.mkdtemp()\n"
        "assert main(['--device', 'cpu', '--width', '64', '--height', '32',"
        " '--depth', '1', '-o', os.path.join(d, 'f.png')]) == 0\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m == 'sphereflake_tpu' or "
        "m.startswith('sphereflake_tpu.'))\n"
        "assert not bad, bad\n"
        "assert 'sphereflake_tpu_torch.render' in sys.modules\n"
        "assert 'sphereflake_tpu_torch.cli' in sys.modules\n"
        "assert 'sphereflake_tpu_torch.ops.binned' in sys.modules\n"
        "print('modules', len(names))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "modules" in res.stdout


def test_chip_smoke_imports_nothing_of_jax_and_fails_without_a_card():
    """`chip_smoke.py` exits non-zero and prints no result where there
    is no CUDA device, and its source names neither JAX nor the JAX
    package as an import."""
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    src = path.read_text()
    for line in src.splitlines():
        stripped = line.strip()
        if stripped.startswith(("import ", "from ")):
            assert "jax" not in stripped
            assert "sphereflake_tpu." not in stripped
            assert not stripped.endswith("sphereflake_tpu")
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    res = subprocess.run(
        [sys.executable, str(path)], capture_output=True, text=True,
        timeout=300, cwd=str(path.parent),
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout
