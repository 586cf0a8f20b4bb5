"""The port's multi-device layer (`sphereflake_tpu_torch/parallel/`) on
meshes of repeated CPU devices — the port's counterpart of the 8
virtual devices `tests/conftest.py` gives the reference — held against
the port's own single-device paths, which the port's other tests hold
against the reference package (`tests/test_sharded.py` holds the
reference's sharded paths against its single-device ones the same way).

- Mesh shapes and the collectives (`parallel.mesh`).
- The per-block path (binned blocks cut into bands, pallas, fast) at
  the reference's own tolerances (`tests/test_sharded.py:117-124`, :149):
  hit masks differ on < 0.1 % of pixels and min_t agrees within 1e-4 on
  > 99.5 % of common hits (binned), > 99.9 % of pixels (pallas); the
  pallas and fast blocks, which make their rays AoS at global pixel
  coordinates, equal the full frame traced that way
  (`render._render_gbuffer_tiles`) bit for bit.
- `render_frame_sharded` (the post sharded by blocks, and its
  replicated branch) equals `render_frame` bit for bit: every block
  evaluates the same per-pixel shader on the same gathered planes.
- `fit_step_sharded`: the loss and the 15 leaf gradients against the
  single-device `fit_step` (rtol 1e-5: the blocks' gradients are summed
  in another order), padded pixels masked out.
- `render_frames_dp` == sequential `render_frame` bit for bit;
  `animate(mesh=...)`, `animate_frames_dp`, `fit(mesh=...)` and the
  CLI's `--mesh`, `--devices`, `--frame-parallel`, `--platform`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sphereflake_tpu_torch.cli import _auto_mesh_shape, main
from sphereflake_tpu_torch.config import RenderConfig, default_scene
from sphereflake_tpu_torch.fit import fit, fit_step
from sphereflake_tpu_torch.parallel import (
    fit_step_sharded,
    make_frame_mesh,
    make_mesh,
    render_frame_sharded,
    render_frames_dp,
    render_gbuffer_sharded,
    shared_bin_supported,
)
from sphereflake_tpu_torch.parallel import mesh as mesh_ops
from sphereflake_tpu_torch.render import (
    _render_gbuffer_tiles,
    render_frame,
    render_gbuffer,
)
from sphereflake_tpu_torch.runtime import animate as port_animate

import _torch_helpers  # noqa: F401  (one intra-op thread per worker)

_BINNED = dict(tile_h=32, tile_w=32, algorithm="binned")


def _cpu_mesh(shape):
    return make_mesh(["cpu"] * (shape[0] * shape[1]), shape=shape)


def _scene(dyaw=0.0):
    scene = default_scene("cpu")
    cam = dataclasses.replace(scene.camera, yaw=scene.camera.yaw + dyaw)
    return dataclasses.replace(scene, camera=cam)


def test_mesh_shapes_and_cells():
    # The reference's most-square factorization, more row-bands first.
    for n, shape in ((1, (1, 1)), (2, (2, 1)), (4, (2, 2)), (6, (3, 2)),
                     (8, (4, 2))):
        assert make_mesh(["cpu"] * n).shape == shape
    m = make_mesh(["cpu"] * 8, shape=(2, 4))
    assert m.shape == (2, 4) and m.size == 8 and m.axis_names == ("ty", "tx")
    assert [idx for idx, _ in m.local_cells()][:3] == [(0, 0), (0, 1), (0, 2)]
    assert m.home == torch.device("cpu") and not m.multi_process
    with pytest.raises(ValueError, match="mesh shape"):
        make_mesh(["cpu"] * 4, shape=(3, 1))
    dp = make_frame_mesh(["cpu"] * 3)
    assert dp.shape == (3,) and dp.axis_names == ("dp",)
    assert _auto_mesh_shape(4, RenderConfig(width=1920, height=1080,
                                            **_BINNED)) == (2, 2)


def test_collectives_on_one_process():
    m = _cpu_mesh((2, 2))
    vals = [torch.tensor(float(i)) for i in range(4)]
    assert float(mesh_ops.psum(m, vals)) == 6.0
    assert float(mesh_ops.pmax(m, vals)) == 3.0
    assert float(mesh_ops.pmin(m, vals)) == 0.0
    blocks = [torch.full((2, 3), float(i)) for i in range(4)]
    full = mesh_ops.tile_blocks(m, mesh_ops.all_gather(m, blocks))
    assert full.shape == (4, 6)
    assert full[0, 0] == 0 and full[0, 3] == 1 and full[2, 0] == 2
    assert full[3, 5] == 3


@pytest.mark.parametrize(
    "kw, shape, hit_max, t_min",
    [
        # binned blocks of 2 tile rows, each cut into 1-row bands (the
        # banded frame: not the shared bin), K1 per block and band
        (dict(width=256, height=128, max_depth=3, band_tile_rows=1,
              **_BINNED), (2, 2), 1e-3, 0.995),
        (dict(width=256, height=128, max_depth=2, max_frontier=128,
              tile_h=32, tile_w=32, algorithm="pallas"), (2, 2), 0.0, 0.999),
        (dict(width=256, height=128, max_depth=2, max_frontier=128,
              tile_h=64, tile_w=128, algorithm="fast"), (2, 2), 0.0, 0.999),
    ],
    ids=["binned_bands", "pallas", "fast"],
)
def test_per_block_matches_single_device(kw, shape, hit_max, t_min):
    cfg, mesh = RenderConfig(**kw), _cpu_mesh(shape)
    assert not shared_bin_supported(cfg, mesh)
    scene = _scene()
    got = render_gbuffer_sharded(scene, cfg, mesh)
    want = render_gbuffer(scene, cfg, device="cpu")
    assert got.min_t.shape == want.min_t.shape == (128, 256)
    hs, h1 = got.hit.numpy(), want.hit.numpy()
    assert (hs != h1).mean() <= hit_max
    both = hs & h1
    close = np.isclose(got.min_t.numpy(), want.min_t.numpy(), rtol=1e-4,
                       atol=1e-4)
    assert (close[both] if hit_max else close).mean() > t_min
    assert int(got.metrics.overflow) == 0
    assert int(got.metrics.max_depth_reached) == int(
        want.metrics.max_depth_reached)
    np.testing.assert_allclose(float(got.metrics.closest_distance),
                               float(want.metrics.closest_distance),
                               rtol=1e-6)
    if cfg.algorithm != "binned":
        with torch.no_grad():
            aos = _render_gbuffer_tiles(scene, cfg)
        for k in ("min_t", "position", "normal", "hit"):
            assert torch.equal(getattr(got, k), getattr(aos, k)), k


@pytest.mark.parametrize(
    "kw, shape",
    [
        (dict(width=128, height=64, max_depth=2), (2, 2)),
        # downscaled SSAO that tiles evenly: the sharded post
        (dict(width=128, height=64, max_depth=2, ssao_downscale=2), (2, 2)),
        # 160x128 / 4 over 2x4 does not: the replicated post
        (dict(width=160, height=128, max_depth=2, ssao_downscale=4), (2, 4)),
        # row blocks: the second cell's passes start at row 64
        (dict(width=64, height=128, max_depth=2), (2, 1)),
    ],
)
def test_render_frame_sharded_equals_render_frame(kw, shape):
    cfg = RenderConfig(**kw, **_BINNED)
    scene = _scene()
    img_s, gb_s = render_frame_sharded(scene, cfg, _cpu_mesh(shape))
    img_1, gb_1 = render_frame(scene, cfg, device="cpu")
    assert img_s.shape == (cfg.height, cfg.width, 3)
    assert torch.equal(img_s, img_1)
    assert torch.equal(gb_s.min_t, gb_1.min_t)


@pytest.mark.parametrize(
    "kw, shape",
    [
        # the reference's gradient frame (64x32, depth 2) over 1x2
        (dict(width=64, height=32, max_depth=2, **_BINNED), (1, 2)),
        # blocks with padded columns (96 px over 2 blocks of 64)
        (dict(width=96, height=64, max_depth=2, **_BINNED), (1, 2)),
        (dict(width=64, height=32, max_depth=2, max_frontier=128,
              tile_h=16, tile_w=64, algorithm="fast"), (2, 1)),
    ],
    ids=["binned", "binned_padded", "fast"],
)
def test_fit_step_sharded_matches_single_device(kw, shape):
    cfg = RenderConfig(**kw)
    target = render_gbuffer(_scene(), cfg, device="cpu")
    scene = _scene(0.02)
    loss_s, g_s = fit_step_sharded(scene, target.position, target.normal,
                                   cfg, _cpu_mesh(shape))
    loss_1, g_1 = fit_step(scene, target.position, target.normal, cfg,
                           device="cpu")
    assert float(loss_1) > 1e-4
    np.testing.assert_allclose(float(loss_s), float(loss_1), rtol=1e-5)
    assert abs(float(g_1.camera.yaw)) > 1e-6
    for a, b in zip(g_s.leaves(), g_1.leaves()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)
    # At the optimum the loss is 0.
    loss0, _ = fit_step_sharded(_scene(), target.position, target.normal,
                                cfg, _cpu_mesh(shape))
    assert float(loss0) < 1e-10


def test_render_frames_dp_equals_sequential():
    cfg = RenderConfig(width=64, height=32, max_depth=2, **_BINNED)
    scenes = [_scene(0.02 * i) for i in range(4)]
    imgs, ovf = render_frames_dp(scenes, cfg, make_frame_mesh(["cpu"] * 4))
    assert imgs.shape == (4, 32, 64, 3) and ovf.tolist() == [0, 0, 0, 0]
    for i, s in enumerate(scenes):
        assert torch.equal(imgs[i], render_frame(s, cfg, device="cpu")[0])
    assert float((imgs[0] - imgs[3]).abs().max()) > 0.01
    with pytest.raises(ValueError, match="one scene per cell"):
        render_frames_dp(scenes[:3], cfg, make_frame_mesh(["cpu"] * 4))


def test_animate_on_a_mesh_and_frame_parallel():
    cfg = RenderConfig(width=64, height=32, max_depth=2, **_BINNED)
    scene = default_scene("cpu")
    seq = list(port_animate.animate(scene, cfg, 3, device="cpu"))
    sharded = list(port_animate.animate(scene, cfg, 3,
                                        mesh=_cpu_mesh((1, 2))))
    dp = list(port_animate.animate_frames_dp(scene, cfg, 3, ["cpu"] * 2))
    assert len(seq) == len(sharded) == len(dp) == 3
    for (a, sa), (b, _), (c, sc) in zip(seq, sharded, dp):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        assert torch.equal(sa.camera.position, sc.camera.position)
    approach = list(port_animate.animate(scene, cfg, 2, mode="approach",
                                         mesh=_cpu_mesh((1, 2))))
    assert not torch.equal(approach[0][1].camera.position,
                           approach[1][1].camera.position)


def test_fit_on_a_mesh_follows_the_single_device_fit():
    cfg = RenderConfig(width=64, height=32, max_depth=2, **_BINNED)
    target = render_gbuffer(_scene(), cfg, device="cpu")
    one = fit(_scene(0.03), target.position, target.normal, cfg, steps=2,
              device="cpu")
    two = fit(_scene(0.03), target.position, target.normal, cfg, steps=2,
              mesh=_cpu_mesh((1, 2)))
    np.testing.assert_allclose(two.losses, one.losses, rtol=1e-5)
    assert two.losses[1] < two.losses[0]
    image, _ = render_frame(_scene(), cfg, device="cpu")
    res = fit(_scene(0.03), None, None, cfg, steps=1, loss="image",
              target_image=image, mesh=_cpu_mesh((1, 2)))
    want = fit(_scene(0.03), None, None, cfg, steps=1, loss="image",
               target_image=image, device="cpu")
    np.testing.assert_allclose(res.losses, want.losses, rtol=1e-6)


def _args(*extra):
    return ["--device", "cpu", "--width", "128", "--height", "64",
            "--depth", "2", "--algorithm", "binned", *extra]


def test_cli_mesh_renders_the_single_device_picture(tmp_path, capsys):
    assert main(_args("--mesh", "2x2", "-o", str(tmp_path / "m.png"))) == 0
    assert "mesh=2x2" in capsys.readouterr().out
    assert main(_args("-o", str(tmp_path / "s.png"))) == 0
    assert "mesh=" not in capsys.readouterr().out  # the CPU: one device
    assert (tmp_path / "m.png").read_bytes() == (tmp_path / "s.png").read_bytes()
    assert main(["--platform", "cpu", "--width", "128", "--height", "64",
                 "--depth", "2", "--algorithm", "binned", "--devices", "2",
                 "-o", str(tmp_path / "d.png")]) == 0
    assert "mesh=1x2" in capsys.readouterr().out  # least padding
    assert (tmp_path / "d.png").read_bytes() == (tmp_path / "s.png").read_bytes()


def test_cli_refuses_what_it_cannot_do(tmp_path, capsys):
    for mesh, msg in (("64x64", "needs 4096 devices"),
                      ("2by2", "not of the form RxC"),
                      ("0x2", "positive dims")):
        assert main(_args("--mesh", mesh, "-o", str(tmp_path / "x.png"))) == 2
        assert msg in capsys.readouterr().err
    assert main(_args("--animate", "2", "--animate-mode", "approach",
                      "--frame-parallel", "-o", str(tmp_path / "a.png"))) == 2
    assert "--frame-parallel needs --animate-mode orbit" in (
        capsys.readouterr().err)
    assert not list(tmp_path.glob("*.png"))


def test_cli_frame_parallel_and_sharded_frameless(tmp_path, capsys):
    assert main(_args("--animate", "2", "--frame-parallel", "--devices", "2",
                      "-o", str(tmp_path / "dp.png"))) == 0
    assert main(_args("--animate", "2", "-o", str(tmp_path / "seq.png"))) == 0
    for i in range(2):
        assert (tmp_path / f"dp_{i:04d}.png").read_bytes() == (
            tmp_path / f"seq_{i:04d}.png").read_bytes()
    capsys.readouterr()
    ck = tmp_path / "ck.npz"
    assert main(_args("--progressive", "4", "--batch", "8192", "--mesh",
                      "2x2", "--checkpoint", str(ck),
                      "-o", str(tmp_path / "p.png"))) == 0
    assert "(8/8 tiles covered)" in capsys.readouterr().out
    with np.load(ck) as data:
        keys = sorted(data.files)
        assert keys[0].startswith("progressive_tiles_sharded/")
        assert data["progressive_tiles_sharded/2"].dtype == np.uint32
        assert data["progressive_tiles_sharded/2"].shape == (2, 2)
    # Both buffers fully covered: the single-device state's picture.
    assert main(_args("--progressive", "8", "--batch", "8192",
                      "-o", str(tmp_path / "one.png"))) == 0
    assert "(8/8 tiles covered)" in capsys.readouterr().out
    assert (tmp_path / "p.png").read_bytes() == (
        tmp_path / "one.png").read_bytes()
    assert main(_args("--progressive", "1", "--batch", "8192", "--mesh",
                      "2x2", "--resume", str(ck),
                      "-o", str(tmp_path / "r.png"))) == 0
