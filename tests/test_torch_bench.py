"""The port's headline bench (`sphereflake_tpu_torch/bench.py`) against the
reference's (`bench.py`), on the CPU at 128x64 depth 2 (8 tiles, a
quarter of them a step), where the kernels run their plain versions.

The reference side is `bench.py:83-103` and `:162-209` composed from the
reference package's functions at the same size, seed (1) and steps (24);
its Pallas kernels run in interpret mode. Tolerances: the first frame's
integers (depth reached, overflow, nodes) and the gate's tiles covered
are exact; the closest distance within rtol = atol = 1e-4 (XLA's CPU
code contracts multiply-adds, eager torch does not); the gate's share of
agreeing pixels equal to its printed digit (4 decimals)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from sphereflake_tpu.config import RenderConfig as RefConfig
from sphereflake_tpu.config import default_scene as ref_default_scene
from sphereflake_tpu.render import render_gbuffer as ref_render_gbuffer
from sphereflake_tpu.runtime import progressive as ref_prog
from sphereflake_tpu_torch import bench
from sphereflake_tpu_torch.config import RenderConfig, default_scene

import _torch_helpers  # noqa: F401  (one torch thread per worker)

_KW = dict(width=128, height=64, max_depth=2, tile_h=32, tile_w=32,
           max_frontier=1024, algorithm="binned", strict_lod=True)
_TILES_PER_STEP = 2  # a quarter of the 8 tiles
_SMALL = dict(n_small=1, n_big=2, frame_trials=1, refresh_trials=1,
              tiles_per_step=_TILES_PER_STEP)
_KEYS = {
    "metric", "value", "unit", "mode", "full_frame_rays_per_second",
    "tiles_per_step", "sustained_trials_rays_per_second",
    "full_frame_trials_rays_per_second", "device", "power_limit",
}


@pytest.fixture(scope="module")
def reference_gate():
    """The reference bench's first frame and frameless gate at 128x64
    depth 2, composed as `bench.py:83-103, 181-201` composes them."""
    cfg, scene0 = RefConfig(**_KW), ref_default_scene()
    gb = ref_render_gbuffer(scene0, cfg)
    m = gb.metrics
    st = ref_prog.progressive_tiles_init(cfg, seed=1)
    prepared0 = ref_prog.progressive_prepare_trimmed(scene0, cfg)
    for _ in range(24):
        st = ref_prog.progressive_tiles_step(
            st, scene0, cfg, tiles_per_step=_TILES_PER_STEP,
            prepared=prepared0,
        )
    covered = int(np.asarray(st.covered).sum())
    _pos, _nrm, mt_t, _hit = ref_prog.tile_progressive_gbuffer(st, cfg)
    cov_mask = np.kron(
        np.asarray(st.covered).reshape(cfg.tiles_y, cfg.tiles_x),
        np.ones((cfg.tile_h, cfg.tile_w), bool),
    )[: cfg.height, : cfg.width]
    agree = (
        np.isclose(np.asarray(mt_t), np.asarray(gb.min_t), rtol=1e-4,
                   atol=1e-4) | ~cov_mask
    ).mean()
    return dict(
        depth_reached=int(m.max_depth_reached), overflow=int(m.overflow),
        nodes=int(m.nodes_visited), closest=float(m.closest_distance),
        prepare_overflow=int(np.asarray(prepared0[3])), covered=covered,
        tiles=cfg.tiles_y * cfg.tiles_x, agree=float(agree),
    )


def test_first_frame_and_gate_match_the_reference(reference_gate):
    cfg, scene = RenderConfig(**_KW), default_scene("cpu")
    with torch.no_grad():
        gb, stats = bench.first_frame(scene, cfg, "cpu")
        gate = bench.frameless_gate(scene, cfg, gb.min_t, "cpu",
                                    tiles_per_step=_TILES_PER_STEP)
    want = reference_gate
    for key in ("depth_reached", "overflow", "nodes"):
        assert stats[key] == want[key], key
    np.testing.assert_allclose(stats["closest"], want["closest"],
                               rtol=1e-4, atol=1e-4)
    assert gate["prepare_overflow"] == want["prepare_overflow"] == 0
    assert gate["covered"] == want["covered"] == gate["tiles"] == 8
    assert round(gate["agree"], 4) == round(want["agree"], 4)
    assert gate["agree"] >= bench.GATE_AGREE_MIN


def _run_main(capsys, cfg=None):
    rc = bench.main([], device="cpu", cfg=cfg or RenderConfig(**_KW),
                    **_SMALL)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_main_prints_the_reference_keys_without_vs_baseline(capsys):
    rc, out, err = _run_main(capsys)
    assert rc == 0, err
    record = json.loads(out.strip().splitlines()[-1])
    assert set(record) == _KEYS
    assert record["metric"] == bench.METRIC and record["unit"] == "rays/s"
    assert record["tiles_per_step"] == _TILES_PER_STEP
    assert record["device"] == "cpu" and record["power_limit"] is None
    for key in ("sustained_trials_rays_per_second",
                "full_frame_trials_rays_per_second"):
        assert set(record[key]) == {"min", "median", "max"}
    assert "frameless gate: 8/8 tiles covered" in err


def _overflowing_prepare(real):
    def prepare(*args, **kw):
        pairs, starts, lens, _ovf = real(*args, **kw)
        return pairs, starts, lens, torch.ones((), dtype=torch.int32)
    return prepare


@pytest.mark.parametrize("fault,message", [
    ("prepare overflow", "FAIL: pair overflow in frameless prepare"),
    ("zero steps", "FAIL: frameless accumulation diverges"),
])
def test_a_failed_gate_returns_1(monkeypatch, capsys, fault, message):
    if fault == "prepare overflow":
        monkeypatch.setattr(bench, "progressive_prepare_trimmed",
                            _overflowing_prepare(
                                bench.progressive_prepare_trimmed))
    else:  # every step leaves the state as it was: nothing covered
        monkeypatch.setattr(bench, "progressive_tiles_step",
                            lambda st, *args, **kw: st)
    rc, out, err = _run_main(capsys)
    assert rc == 1
    assert message in err
    assert out == ""  # no result line


def test_first_frame_overflow_returns_1(capsys):
    """A live-node cap below the frame's nodes drops geometry: the first
    frame's gate fails before anything is timed."""
    rc, out, err = _run_main(
        capsys, cfg=dataclasses.replace(RenderConfig(**_KW), global_cap=9)
    )
    assert rc == 1 and "FAIL: pair-table overflow" in err
    assert out == ""


def test_marginal_and_spread():
    calls = []

    def run(n):
        calls.append(n)
        return 0.5 + 0.25 * n  # 0.25 s a unit

    dt, dts, timed = bench.marginal(run, 2, 22, 3)
    assert calls == [2, 22] * 4 and dts == [0.25] * 3 and dt == 0.25
    assert timed == [(1.0, 6.0)] * 3
    assert bench.median([3.0, 1.0, 2.0, 5.0, 4.0]) == 3.0
    assert bench.spread([1.0, 2.0, 4.0], 8.0) == {
        "min": 2.0, "median": 4.0, "max": 8.0
    }


def test_main_without_a_card_fails_naming_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main([])
