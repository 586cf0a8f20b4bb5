"""The port's large-frame and scaling-projection programs
(`sphereflake_tpu_torch/bigframe.py`, `scaling_project.py`) on the CPU,
where the kernels run their plain versions.

Both rest on one premise, which the reference's tools state
(`tools/bigframe.py:1-9`, `tools/scaling_project.py:6-14`): a frame
rendered band by band is the frame. In eager torch the bands and the
whole frame run the same unfused arithmetic on the same rays, so the
comparisons here are bit for bit. No JAX program runs in this file."""

import pytest
import torch

from sphereflake_tpu_torch import bigframe, host_pace, render, scaling_project
from sphereflake_tpu_torch.config import RenderConfig, default_scene
from sphereflake_tpu_torch.render import render_gbuffer

import _torch_helpers  # noqa: F401  (one torch thread per worker)

_BINNED = dict(tile_h=32, tile_w=32, algorithm="binned")


@pytest.fixture(scope="module")
def scene():
    return default_scene("cpu")


def test_lean_bands_equal_render_gbuffer(scene):
    """256x256 depth 3 in 4 bands of 2 tile rows: `min_t` and the hit
    mask equal the banded `render_gbuffer`'s bit for bit, the preview is
    its normal plane at every 8th pixel, nodes and overflow its metrics."""
    cfg = RenderConfig(width=256, height=256, max_depth=3, band_tile_rows=2,
                       **_BINNED)
    lean = bigframe.lean_bands(scene, cfg)
    gb = render_gbuffer(scene, cfg, device="cpu")
    assert lean["bands"] == bigframe.n_bands(cfg) == 4
    assert lean["min_t"].shape == (256, 256) and lean["hit"].dtype == torch.uint8
    assert torch.equal(lean["min_t"], gb.min_t)
    assert torch.equal(lean["hit"].bool(), gb.hit)
    assert 0.05 < float(gb.hit.float().mean()) < 0.95
    step = bigframe.DS
    hit = gb.hit[::step, ::step]
    assert lean["preview"].shape == gb.normal[::step, ::step].shape
    assert torch.equal(lean["preview"][hit], gb.normal[::step, ::step][hit])
    assert lean["nodes"] == int(gb.metrics.nodes_visited)
    assert lean["overflow"] == int(gb.metrics.overflow) == 0


def test_lean_bands_pad_and_crop(scene):
    """A frame that is not a tile multiple: the bands cover the padded
    rows, and the outputs are cropped like `render_gbuffer`'s."""
    cfg = RenderConfig(width=200, height=120, max_depth=2, band_tile_rows=2,
                       **_BINNED)
    lean = bigframe.lean_bands(scene, cfg)
    gb = render_gbuffer(scene, cfg, device="cpu")
    assert torch.equal(lean["min_t"], gb.min_t)
    assert lean["preview"].shape == gb.normal[::8, ::8].shape == (15, 25, 3)
    hit = gb.hit[::8, ::8]
    assert torch.equal(lean["preview"][hit], gb.normal[::8, ::8][hit])


def test_lean_bands_of_an_unbanded_frame(scene):
    """No bands set: `lean_bands` renders the one block `render_gbuffer`
    renders (cfg itself, padded rows cropped) and equals it bit for
    bit."""
    cfg = RenderConfig(width=200, height=120, max_depth=2, **_BINNED)
    assert cfg.effective_band_rows is None
    lean = bigframe.lean_bands(scene, cfg)
    gb = render_gbuffer(scene, cfg, device="cpu")
    assert lean["bands"] == 1
    assert torch.equal(lean["min_t"], gb.min_t)
    assert torch.equal(lean["hit"].bool(), gb.hit)
    assert lean["nodes"] == int(gb.metrics.nodes_visited)


@pytest.mark.parametrize("path", ["render_gbuffer", "lean_bands", "runs"])
def test_fronts_come_from_band_fronts(scene, monkeypatch, path):
    """A banded frame on one card makes all its bands' fronts in one
    `band_fronts` call; `lean_bands` makes them one band at a time, each
    call with that band's offset alone. Where the bands' pair tables
    together exceed `FRONT_SLOTS`, the frame makes its fronts a run of
    bands a call (`front_groups`), and is the same frame bit for bit."""
    from sphereflake_tpu_torch.ops import binned

    calls = []
    real = binned.band_fronts

    def counted(scene, cfg, frame_w, frame_h, x_off, y_offs):
        calls.append(list(y_offs))
        return real(scene, cfg, frame_w, frame_h, x_off, y_offs)

    monkeypatch.setattr(binned, "band_fronts", counted)
    size = 256 if path == "runs" else 128
    cfg = RenderConfig(width=256, height=size, max_depth=3, band_tile_rows=2,
                       **_BINNED)
    bcfg, offsets = render.band_layout(cfg, (256, size, 0.0, 0.0))
    assert offsets == [64.0 * b for b in range(size // 64)]
    if path == "lean_bands":
        bigframe.lean_bands(scene, cfg)
        assert calls == [[y] for y in offsets]
        return
    gb = render_gbuffer(scene, cfg, device="cpu")
    assert calls == [offsets]
    if path == "runs":
        calls.clear()
        monkeypatch.setattr(binned, "FRONT_SLOTS", 2 * bcfg.pair_cap)
        runs = render_gbuffer(scene, cfg, device="cpu")
        assert calls == [offsets[:2], offsets[2:]]
        for name in ("position", "normal", "min_t", "hit"):
            assert torch.equal(getattr(runs, name), getattr(gb, name)), name
        for name in ("max_depth_reached", "nodes_visited", "overflow"):
            assert torch.equal(getattr(runs.metrics, name),
                               getattr(gb.metrics, name)), name


def test_front_groups():
    """Runs of nearly equal length, in order, each within `FRONT_SLOTS`
    pair slots, one band a run at the least."""
    from sphereflake_tpu_torch.ops import binned

    cfg = RenderConfig(width=256, height=256, max_depth=3, **_BINNED)
    per_call = binned.FRONT_SLOTS // cfg.pair_cap
    ys = [float(b) for b in range(2 * per_call + 1)]
    runs = binned.front_groups(cfg, ys)
    assert [y for r in runs for y in r] == ys
    assert len(runs) == 3 and max(map(len, runs)) - min(map(len, runs)) <= 1
    assert all(len(r) * cfg.pair_cap <= binned.FRONT_SLOTS for r in runs)
    assert binned.front_groups(cfg, ys[:per_call]) == [ys[:per_call]]
    top = RenderConfig(width=256, height=256, max_depth=8, global_cap=9 << 16,
                       **_BINNED)
    assert top.pair_cap == binned.PAIR_CAP
    assert binned.front_groups(top, ys[:40]) == [ys[0:13], ys[13:26],
                                                 ys[26:40]]


def test_band_layout():
    """The bands `render_gbuffer` and `lean_bands` share: y offsets one
    band height apart from the block's own, each band the padded width;
    an unbanded grid is one band, cfg itself."""
    cfg = RenderConfig(width=200, height=256, max_depth=3, band_tile_rows=2,
                       **_BINNED)
    bcfg, offsets = render.band_layout(cfg, (200, 512, 0.0, 256.0))
    assert offsets == [256.0, 320.0, 384.0, 448.0]
    assert (bcfg.height, bcfg.width, bcfg.band_tile_rows) == (
        64, cfg.padded_width, None)
    assert bcfg.tiles_x == cfg.tiles_x and bcfg.tiles_y == 2
    whole = RenderConfig(width=200, height=256, max_depth=3, **_BINNED)
    assert render.band_layout(whole, (200, 256, 0.0, 0.0)) == (whole, [0.0])


def test_lean_bands_refuse_a_preview_step_that_splits_a_band(scene):
    cfg = RenderConfig(width=64, height=64, max_depth=1, band_tile_rows=1,
                       **_BINNED)
    with pytest.raises(ValueError, match="does not divide"):
        bigframe.lean_bands(scene, cfg, ds=3)


@pytest.mark.parametrize("n", [2, 4])
def test_scaling_bands_equal_the_whole_frame(scene, n):
    """The 1080p mode's frames, shrunk to 256x128: N bands of 4 / N tile
    rows give the whole frame's `min_t` bit for bit — the premise of the
    projection, held in the port."""
    whole, blocks = scaling_project.configs("1080p", 3, size=(256, 128),
                                            counts=(n,))
    assert blocks[n].effective_band_rows == 4 // n
    a = render_gbuffer(scene, whole, device="cpu")
    b = render_gbuffer(scene, blocks[n], device="cpu")
    assert torch.equal(a.min_t, b.min_t)
    assert int(b.metrics.overflow) == 0


def test_the_reference_operating_points():
    """Sizes, bands and blocks of the reference's tools, from the config
    alone (no frame runs)."""
    assert [bigframe.n_bands(bigframe.big_config(s))
            for s in bigframe.SIZES] == [8, 32, 128]
    whole, blocks = scaling_project.configs("config5", 6)
    assert (whole.width, whole.height, bigframe.n_bands(whole)) == (
        16384, 16384, 128)
    assert {n: (c.width, c.height, bigframe.n_bands(c))
            for n, c in blocks.items()} == {
        2: (16384, 8192, 64), 4: (16384, 4096, 32), 8: (16384, 2048, 16)}
    whole, blocks = scaling_project.configs("1080p", 6)
    assert (whole.width, whole.height, whole.effective_band_rows) == (
        1920, 1024, None)
    assert {n: c.effective_band_rows for n, c in blocks.items()} == {
        2: 16, 4: 8, 8: 4}


@pytest.mark.parametrize("argv,want", [
    (["d8", "4096"], ([4096], 8)),
    (["4096", "8192"], ([4096, 8192], 6)),
    ([], ([4096, 8192, 16384], 6)),
])
def test_bigframe_argv(argv, want):
    assert bigframe.parse_args(argv) == want


@pytest.mark.parametrize("argv,want", [
    (["6", "config5"], (6, "config5")),
    (["8"], (8, "1080p")),
    ([], (6, "1080p")),
])
def test_scaling_project_argv(argv, want):
    assert scaling_project.parse_args(argv) == want


def test_scaling_project_refuses_an_unknown_mode():
    with pytest.raises(SystemExit):
        scaling_project.parse_args(["6", "4k"])
    with pytest.raises(ValueError, match="mode"):
        scaling_project.configs("4k")


def test_mains_without_a_card_fail_naming_cuda():
    """Parsed, then refused before any frame runs."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        bigframe.main(["d8", "4096"])
    with pytest.raises(RuntimeError, match="cuda"):
        scaling_project.main(["6", "config5"])
    with pytest.raises(RuntimeError, match="cuda"):
        host_pace.main()
