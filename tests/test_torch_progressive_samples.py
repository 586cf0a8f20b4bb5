"""The port's sample-granular frameless step (`progressive_step`, binned
branch, on the CPU: the ray-bundle kernel's plain version) vs the
reference package's (Pallas kernel in interpret mode), in both scramble
modes, and the reference's own sample cases (`tests/test_progressive.py`)
held on the port.

The pixels a batch chooses are integers and must be identical: the
set of written pixels is compared exactly through the normal plane
(non-zero exactly where a sample hit) and the cursor bit for bit.
G-buffer floats: min_t / position within rtol = atol = 1e-4 on >= 99.5 %
of the written pixels (XLA's CPU code contracts multiply-adds; see
`test_torch_render.py`)."""

import dataclasses

import numpy as np
import pytest
import torch

from sphereflake_tpu.config import RenderConfig as RefConfig
from sphereflake_tpu.config import default_scene
from sphereflake_tpu.runtime import progressive as ref_prog
from sphereflake_tpu_torch import render as port_render
from sphereflake_tpu_torch.config import RenderConfig as PortConfig
from sphereflake_tpu_torch.convert import (
    progressive_state_from_numpy,
    tensor_from_numpy,
)
from sphereflake_tpu_torch.ops import binned as port_binned
from sphereflake_tpu_torch.runtime import progressive as port_prog

from _torch_helpers import port_scene

_BINNED = dict(tile_h=32, tile_w=32, algorithm="binned")
_KW = dict(width=96, height=64, max_depth=2, **_BINNED)
_SEED = 2**31 + 3


def _state_to_numpy(state):
    return {
        f.name: np.asarray(getattr(state, f.name))
        for f in dataclasses.fields(state)
    }


def _check_against_reference(got, want):
    assert got.sample_lo == int(want["sample_lo"])
    assert got.sample_hi == int(want["sample_hi"])
    assert got.samples_traced == int(want["samples_traced"])
    assert int(got.overflow) == int(want["overflow"])
    touched_g = got.normal.numpy().any(axis=-1)
    touched_w = want["normal"].any(axis=-1)
    assert touched_w.sum() > 100
    # Pixels chosen identical; a graze may flip a hit on a few of them.
    assert (touched_g == touched_w).mean() >= 0.999
    both = touched_g & touched_w
    for g, w in ((got.min_t.numpy(), want["min_t"]),
                 (got.position.numpy(), want["position"])):
        close = np.isclose(g[both], w[both], rtol=1e-4, atol=1e-4)
        assert close.mean() >= 0.995
    # Sky samples write BIG into min_t: the written set is the same.
    np.testing.assert_array_equal(
        (got.min_t.numpy() < 1e38) | touched_g, (want["min_t"] < 1e38) | touched_w
    )
    np.testing.assert_allclose(
        float(got.closest_distance), float(want["closest_distance"]), rtol=1e-4
    )


@pytest.mark.parametrize("scramble", ["fixed", "per_sample"])
def test_sample_step_matches_reference(scramble):
    """Two steps of 1024 samples through both packages; then the
    reference's first state, carried across as NumPy arrays with the
    reference's table, takes the same second step in the port."""
    ref_scene, ref_cfg = default_scene(), RefConfig(**_KW)
    prepared = ref_prog.progressive_prepare(ref_scene, ref_cfg)
    step = lambda st: ref_prog.progressive_step(
        st, ref_scene, ref_cfg, batch_size=1024, scramble=scramble,
        prepared=prepared,
    )
    want1 = step(ref_prog.progressive_init(ref_cfg, seed=_SEED))
    want2 = _state_to_numpy(step(want1))
    want1 = _state_to_numpy(want1)

    scene, cfg = port_scene(ref_scene), PortConfig(**_KW)
    own = port_prog.progressive_prepare(scene, cfg, device="cpu")
    got = port_prog.progressive_init(cfg, seed=_SEED, device="cpu")
    for _ in range(2):
        got = port_prog.progressive_step(
            got, scene, cfg, batch_size=1024, scramble=scramble, prepared=own
        )
    _check_against_reference(got, want2)
    assert got.position.shape == (64, 96, 3) and got.min_t.shape == (64, 96)

    carried = progressive_state_from_numpy(want1, device="cpu")
    assert carried.sample_lo == 1024 and carried.seed == _SEED
    table = tuple(tensor_from_numpy(np.asarray(x), "cpu") for x in prepared)
    nxt = port_prog.progressive_step(
        carried, scene, cfg, batch_size=1024, scramble=scramble, prepared=table
    )
    _check_against_reference(nxt, want2)


def _step(state, scene, cfg, **kw):
    return port_prog.progressive_step(state, scene, cfg, **kw)


def test_coverage_grows_and_converges_to_full_frame():
    scene, cfg = port_scene(default_scene()), PortConfig(
        width=128, height=64, max_depth=2, **_BINNED
    )
    prepared = port_prog.progressive_prepare(scene, cfg, device="cpu")
    state = port_prog.progressive_init(cfg, seed=7, device="cpu")
    covered_prev = 0
    for _ in range(6):
        state = _step(state, scene, cfg, batch_size=4096, prepared=prepared)
        covered = int(state.normal.any(dim=-1).sum())
        assert covered >= covered_prev
        covered_prev = covered
    assert covered_prev > 500
    # Progressive samples agree with the full-frame render at their pixels.
    gb = port_render.render_gbuffer(scene, cfg, device="cpu")
    touched = state.normal.any(dim=-1)
    # (The step re-derives t from the winner's path code, the full
    # render takes it from the kernel: the two differ near silhouettes,
    # where t = tca - sqrt(r^2 - d^2) cancels.)
    close = np.isclose(
        state.position[touched].numpy(), gb.position[touched].numpy(),
        rtol=1e-4, atol=1e-4,
    )
    assert close.mean() >= 0.995
    assert torch.equal(touched, gb.hit & touched)
    # Pixel selection law: x = 1 + floor(s * (W - 2)) never writes the
    # first or the last column / row.
    written = (state.min_t < 1e38) | touched
    assert not written[0].any() and not written[:, 0].any()
    assert not written[-1].any() and not written[:, -1].any()


def test_deterministic_given_seed_and_cursor_advances():
    scene, cfg = port_scene(default_scene()), PortConfig(**_KW)
    init = lambda seed: port_prog.progressive_init(cfg, seed=seed, device="cpu")
    a = _step(init(3), scene, cfg, batch_size=2048)
    b = _step(init(3), scene, cfg, batch_size=2048)
    assert torch.equal(a.position, b.position) and torch.equal(a.min_t, b.min_t)
    c = _step(init(4), scene, cfg, batch_size=2048)
    assert not torch.equal(a.position, c.position)
    a2 = _step(a, scene, cfg, batch_size=1024)
    assert (a.sample_lo, a2.sample_lo, a2.samples_traced) == (2048, 3072, 3072)
    assert a.seed == 3 and a2.seed == 3


def test_scramble_modes_differ():
    scene, cfg = port_scene(default_scene()), PortConfig(**_KW)
    init = port_prog.progressive_init(cfg, 5, device="cpu")
    a = _step(init, scene, cfg, batch_size=2048, scramble="fixed")
    b = _step(init, scene, cfg, batch_size=2048, scramble="per_sample")
    assert not torch.equal(a.normal, b.normal)


def test_view_change_mid_stream_overwrites():
    """The frameless property: changing the camera between steps just
    makes new samples overwrite stale texels (`main.cpp:304`)."""
    scene, cfg = port_scene(default_scene()), PortConfig(**_KW)
    state = port_prog.progressive_init(cfg, seed=1, device="cpu")
    for _ in range(2):
        state = _step(state, scene, cfg, batch_size=2048)
    cam2 = dataclasses.replace(
        scene.camera, position=scene.camera.position + 2.0
    )
    scene2 = dataclasses.replace(scene, camera=cam2)
    state2 = _step(state, scene2, cfg, batch_size=2048)
    assert not torch.equal(state2.position, state.position)
    untouched = state2.min_t == state.min_t
    assert bool(untouched.any())  # pixels not resampled keep the old view


def test_duplicate_pixels_resolve_deterministically():
    """Tiny image + large batch: many duplicate pixels per batch. They
    resolve deterministically — run twice, compare."""
    cfg = PortConfig(width=16, height=16, max_depth=1, **_BINNED)
    scene = port_scene(default_scene())
    init = port_prog.progressive_init(cfg, seed=1, device="cpu")
    a = _step(init, scene, cfg, batch_size=4096, scramble="per_sample")
    b = _step(init, scene, cfg, batch_size=4096, scramble="per_sample")
    assert torch.equal(a.position, b.position)
    assert torch.equal(a.min_t, b.min_t) and torch.equal(a.normal, b.normal)
    # 4096 samples over 14 x 14 writable pixels: every one that sees
    # the fractal holds a hit.
    assert int(a.normal.any(dim=-1)[1:-1, 1:-1].sum()) >= 100


def test_prepared_pairs_match_unprepared():
    """With a static camera the cached pair table gives BIT-IDENTICAL
    steps."""
    scene, cfg = port_scene(default_scene()), PortConfig(**_KW)
    prepared = port_prog.progressive_prepare(scene, cfg, device="cpu")
    s_a = port_prog.progressive_init(cfg, seed=7, device="cpu")
    s_b = port_prog.progressive_init(cfg, seed=7, device="cpu")
    for _ in range(3):
        s_a = _step(s_a, scene, cfg, batch_size=1024)
        s_b = _step(s_b, scene, cfg, batch_size=1024, prepared=prepared)
    assert torch.equal(s_a.min_t, s_b.min_t)
    assert torch.equal(s_a.normal, s_b.normal)
    assert s_a.samples_traced == s_b.samples_traced == 3072


def test_closest_distance_metric_and_reset():
    scene, cfg = port_scene(default_scene()), PortConfig(**_KW)
    state = _step(port_prog.progressive_init(cfg, device="cpu"), scene, cfg,
                  batch_size=4096)
    gb = port_render.render_gbuffer(scene, cfg, device="cpu")
    assert float(state.closest_distance) >= float(
        gb.metrics.closest_distance
    ) - 1e-5
    assert float(state.closest_distance) < 20.0
    state = port_prog.reset_closest_distance(state)
    assert float(state.closest_distance) > 1e30
    assert state.closest_distance.dtype == torch.float32
    assert state.sample_lo == 4096  # everything else is kept


def test_overflow_accumulates_and_cursor_carries_on_the_sample_path():
    scene, cfg = port_scene(default_scene()), PortConfig(**_KW)
    pairs, starts, lens, _ = port_prog.progressive_prepare(
        scene, cfg, device="cpu"
    )
    crowded = (pairs, starts, lens, torch.tensor(7, dtype=torch.int32))
    st = port_prog.progressive_init(cfg, seed=2, device="cpu")
    st = dataclasses.replace(st, sample_lo=2**32 - 1024)
    st = _step(st, scene, cfg, batch_size=1024, prepared=crowded)
    assert (st.sample_lo, st.sample_hi) == (0, 1)
    st = _step(st, scene, cfg, batch_size=1024, prepared=crowded)
    assert int(st.overflow) == 2 * 7 and st.sample_lo == 1024


@pytest.mark.parametrize("algorithm", ["strict", "loose"])
def test_unported_algorithms_raise(algorithm):
    """The parity traversals are ported: the step traces the whole batch
    as one tile through `trace_tile`, with no kernel launch; only an
    algorithm that does not exist raises."""
    cfg = PortConfig(width=96, height=64, tile_h=32, tile_w=32, max_depth=2,
                     algorithm=algorithm)
    scene = port_scene(default_scene())
    state = port_prog.progressive_init(cfg, device="cpu")
    st = port_prog.progressive_step(state, scene, cfg, batch_size=1024)
    assert st.samples_traced == 1024 and int(st.overflow) == 0
    assert 0 < int((st.min_t < 1e38).sum()) <= 1024
    bogus = dataclasses.replace(cfg, algorithm="bogus")
    with pytest.raises(ValueError, match="unknown algorithm"):
        port_prog.progressive_step(state, scene, bogus, batch_size=1024)


def test_batch_must_be_whole_bundles():
    scene, cfg = port_scene(default_scene()), PortConfig(**_KW)
    state = port_prog.progressive_init(cfg, device="cpu")
    with pytest.raises(AssertionError, match="1024"):
        port_prog.progressive_step(state, scene, cfg, batch_size=1000)


def test_sample_step_makes_no_host_reads(monkeypatch):
    """Nothing between a sample step's entry and its return reads a
    tensor back to the host. The ray-bundle kernel's plain version reads
    max(lens) and is excused — on the card the kernel takes its place."""
    names = ("item", "tolist", "__int__", "__float__", "__bool__",
             "__index__", "nonzero", "unique")
    originals = {name: getattr(torch.Tensor, name) for name in names}
    scene, cfg = port_scene(default_scene()), PortConfig(**_KW)
    prepared = port_prog.progressive_prepare(scene, cfg, device="cpu")
    st = port_prog.progressive_init(cfg, seed=1, device="cpu")
    plain = port_binned.trace_pairs_pallas_soa_plain
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

    monkeypatch.setattr(port_binned, "trace_pairs_pallas_soa_plain", excused)
    for name in names:
        monkeypatch.setattr(torch.Tensor, name, forbidden(name))
    for scramble in ("fixed", "per_sample"):
        st = port_prog.progressive_step(
            st, scene, cfg, batch_size=1024, scramble=scramble,
            prepared=prepared,
        )
    monkeypatch.undo()
    assert calls == [1, 1] and st.sample_lo == 2048
