"""The port's tile-granular frameless path
(`sphereflake_tpu_torch/runtime/progressive.py`, on the CPU: the subset
kernel's plain version) vs the reference package's (Pallas kernel in
interpret mode), and the reference's own tile cases
(`tests/test_progressive.py`) held on the port.

Integers — tile ids (through `covered`), cursor, samples_traced,
overflow, segment tables fed the same pairs — are compared bit for bit.
Float rows: min_t / position within rtol = atol = 1e-4 on >= 99 % of
the values of the refreshed tiles (XLA's CPU code contracts
multiply-adds, eager torch does not; see `test_torch_render.py`).
Within the port the accumulated buffer equals its own full render
exactly: both run the same unfused arithmetic on the same rays."""

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
    tensor_from_numpy,
    tile_state_from_numpy,
    to_numpy,
)
from sphereflake_tpu_torch.ops import binned as port_binned
from sphereflake_tpu_torch.runtime import progressive as port_prog

from _torch_helpers import port_scene

_BINNED = dict(tile_h=32, tile_w=32, algorithm="binned")
_KW = dict(width=128, height=64, max_depth=2, **_BINNED)  # 8 tiles
_SEED = 2**31 + 5


def _state_to_numpy(state):
    return {
        f.name: np.asarray(getattr(state, f.name))
        for f in dataclasses.fields(state)
    }


def _steps(state, scene, cfg, prepared, n, tiles_per_step):
    for _ in range(n):
        state = port_prog.progressive_tiles_step(
            state, scene, cfg, tiles_per_step=tiles_per_step, prepared=prepared
        )
    return state


@pytest.fixture(scope="module")
def reference_run():
    """One reference run shared by the comparisons: prepare, one step
    of 3 tiles, then a second step (states as NumPy dicts)."""
    scene, cfg = default_scene(), RefConfig(**_KW)
    prepared = ref_prog.progressive_prepare(scene, cfg)
    st1 = ref_prog.progressive_tiles_step(
        ref_prog.progressive_tiles_init(cfg, seed=_SEED), scene, cfg,
        tiles_per_step=3, prepared=prepared,
    )
    st2 = ref_prog.progressive_tiles_step(
        st1, scene, cfg, tiles_per_step=3, prepared=prepared
    )
    return dict(
        scene=scene,
        prepared=tuple(np.asarray(x) for x in prepared),
        st1=_state_to_numpy(st1), st2=_state_to_numpy(st2),
    )


def _check_state_against_reference(got, want):
    assert got.sample_lo == int(want["sample_lo"])
    assert got.sample_hi == int(want["sample_hi"])
    assert got.seed == int(want["seed"])
    assert got.samples_traced == int(want["samples_traced"])
    assert int(got.overflow) == int(want["overflow"])
    np.testing.assert_array_equal(got.covered.numpy(), want["covered"])
    cov = want["covered"]
    assert 0 < cov.sum() < cov.size  # partially covered: ids matter
    rows_g, rows_w = got.rows.numpy(), want["rows"]
    assert rows_g.shape == rows_w.shape and rows_g.dtype == np.float32
    # Never-refreshed tiles hold the init rows on both sides.
    np.testing.assert_array_equal(rows_g[~cov], rows_w[~cov])
    hit_g, hit_w = rows_g[cov][:, 0] < 1e38, rows_w[cov][:, 0] < 1e38
    assert (hit_g == hit_w).mean() >= 0.999
    both = hit_g & hit_w
    for row in range(4):  # min_t, position
        close = np.isclose(rows_g[cov][:, row][both], rows_w[cov][:, row][both],
                           rtol=1e-4, atol=1e-4)
        assert close.mean() >= 0.99
    np.testing.assert_allclose(
        float(got.closest_distance), float(want["closest_distance"]),
        rtol=1e-4,
    )


def test_tile_step_matches_reference(reference_run):
    """The port's own prepare + step against the reference's: same
    Sobol tiles (covered equal), same cursor, rows within tolerance."""
    scene, cfg = port_scene(reference_run["scene"]), PortConfig(**_KW)
    prepared = port_prog.progressive_prepare(scene, cfg, device="cpu")
    st = port_prog.progressive_tiles_init(cfg, seed=_SEED, device="cpu")
    st = _steps(st, scene, cfg, prepared, 1, 3)
    _check_state_against_reference(st, reference_run["st1"])
    assert st.rows.shape == (8, 7, 8, 128) and st.covered.dtype == torch.bool


def test_reference_state_carried_across_takes_the_same_next_step(reference_run):
    """A reference state and its prepared table, carried over as NumPy
    arrays, continue in the port: the next step equals the reference's
    next step."""
    scene, cfg = port_scene(reference_run["scene"]), PortConfig(**_KW)
    prepared = tuple(
        tensor_from_numpy(x, "cpu") for x in reference_run["prepared"]
    )
    st1 = tile_state_from_numpy(reference_run["st1"], device="cpu")
    assert st1.sample_lo == 3 and st1.seed == _SEED
    assert isinstance(st1.samples_traced, int)
    st2 = _steps(st1, scene, cfg, prepared, 1, 3)
    _check_state_against_reference(st2, reference_run["st2"])
    # and back: a dict of NumPy arrays and ints under the same names
    back = to_numpy(st2)
    assert set(back) == set(reference_run["st2"])
    assert back["rows"].dtype == np.float32 and back["sample_lo"] == 6


def test_tile_progressive_matches_full_render():
    """Covered tiles equal the port's full render EXACTLY, uncovered
    tiles stay sky, and coverage accumulates across steps."""
    scene = port_scene(default_scene())
    cfg = PortConfig(width=256, height=128, max_depth=3, **_BINNED)
    T = cfg.tiles_y * cfg.tiles_x
    prepared = port_prog.progressive_prepare(scene, cfg, device="cpu")
    st = port_prog.progressive_tiles_init(cfg, seed=1, device="cpu")
    st = _steps(st, scene, cfg, prepared, 1, 8)
    assert 0 < int(st.covered.sum()) <= 8
    gb = port_render.render_gbuffer(scene, cfg, device="cpu")
    pos, nrm, mt, hit = port_prog.tile_progressive_gbuffer(st, cfg)
    cov_px = torch.kron(
        st.covered.reshape(cfg.tiles_y, cfg.tiles_x).to(torch.int32),
        torch.ones((32, 32), dtype=torch.int32),
    ).bool()
    assert torch.equal(mt[cov_px], gb.min_t[cov_px])
    assert (mt[~cov_px] == 3.0e38).all() and not hit[~cov_px].any()
    st = _steps(st, scene, cfg, prepared, 9, 8)
    assert int(st.covered.sum()) == T  # 80 Sobol draws cover all 32 tiles
    pos, nrm, mt, hit = port_prog.tile_progressive_gbuffer(st, cfg)
    assert torch.equal(mt, gb.min_t) and torch.equal(hit, gb.hit)
    assert torch.equal(pos, gb.position) and torch.equal(nrm, gb.normal)
    assert st.samples_traced == 80 * 1024
    assert int(st.overflow) == 0


def test_tile_progressive_composite_matches_render_frame():
    """The full post chain over the fully covered in-flight buffer
    equals `render_frame` of the same scene (exactly, in the port)."""
    scene = port_scene(default_scene())
    cfg = PortConfig(width=128, height=96, max_depth=2, **_BINNED)
    T = cfg.tiles_y * cfg.tiles_x
    prepared = port_prog.progressive_prepare(scene, cfg, device="cpu")
    st = port_prog.progressive_tiles_init(cfg, seed=2, device="cpu")
    st = _steps(st, scene, cfg, prepared, 6, T)
    assert int(st.covered.sum()) == T
    img = port_prog.tile_progressive_composite(st, scene, cfg)
    img_full, _gb = port_render.render_frame(scene, cfg, device="cpu")
    assert img.shape == (96, 128, 3)
    assert torch.equal(img, img_full)


def test_tile_progressive_mid_flight_composite_runs():
    """The post chain also runs over a PARTIALLY covered buffer (the
    display thread composites whatever is there, unwritten sky texels
    included)."""
    scene = port_scene(default_scene())
    cfg = PortConfig(width=128, height=96, max_depth=2, **_BINNED)
    prepared = port_prog.progressive_prepare(scene, cfg, device="cpu")
    st = port_prog.progressive_tiles_init(cfg, seed=2, device="cpu")
    st = _steps(st, scene, cfg, prepared, 1, 3)
    assert 0 < int(st.covered.sum()) < cfg.tiles_x * cfg.tiles_y
    img = port_prog.tile_progressive_composite(st, scene, cfg)
    assert img.shape == (96, 128, 3) and bool(torch.isfinite(img).all())


@pytest.mark.parametrize("depth", [2, 7])
def test_trimmed_prepare_is_output_invisible(depth):
    """`progressive_prepare_trimmed` drops only candidates that provably
    cannot win; the accumulated buffer is BIT-identical to the untrimmed
    table's — on the shallow (7-row) and the deep (8-row) layouts."""
    scene = port_scene(default_scene())
    cfg = PortConfig(width=128, height=64, max_depth=depth,
                     global_cap=1 << 14, **_BINNED)
    T = cfg.tiles_y * cfg.tiles_x
    plain = port_prog.progressive_prepare(scene, cfg, device="cpu")
    trimmed = port_prog.progressive_prepare_trimmed(scene, cfg, device="cpu")
    n_plain, n_trim = int(plain[2].sum()), int(trimmed[2].sum())
    assert 0 < n_trim < n_plain
    assert trimmed[0].shape == plain[0].shape == (8 if depth >= 7 else 7,
                                                   cfg.pair_cap)
    assert trimmed[1].dtype == trimmed[2].dtype == torch.int32
    # dead columns can never pass a ray test
    assert (trimmed[0][3, n_trim:] == -3.0e38).all()
    st_a = port_prog.progressive_tiles_init(cfg, seed=6, device="cpu")
    st_b = port_prog.progressive_tiles_init(cfg, seed=6, device="cpu")
    st_a = _steps(st_a, scene, cfg, plain, 2, T)
    st_b = _steps(st_b, scene, cfg, trimmed, 2, T)
    assert int(st_a.covered.sum()) > T // 2
    assert torch.equal(st_a.rows, st_b.rows)
    assert torch.equal(st_a.covered, st_b.covered)
    assert float(st_a.closest_distance) == float(st_b.closest_distance)


def test_trimmed_segment_tables_match_reference():
    """`starts2` / `lens2` against the reference's trimmed prepare. The
    keep test compares floats (|c| - 2r against the tile's farthest
    winner, plane distances against -2r) computed from camera trig that
    differs by ulps between the packages, so a pair sitting on a
    threshold may fall either way: per-tile lengths must agree on
    >= 90 % of the tiles and the total within 2 %."""
    ref_scene, kw = default_scene(), _KW
    want = ref_prog.progressive_prepare_trimmed(ref_scene, RefConfig(**kw))
    want_starts, want_lens = np.asarray(want[1]), np.asarray(want[2])
    got = port_prog.progressive_prepare_trimmed(
        port_scene(ref_scene), PortConfig(**kw), device="cpu"
    )
    got_starts, got_lens = got[1].numpy(), got[2].numpy()
    assert got_lens.shape == want_lens.shape
    assert (got_lens == want_lens).mean() >= 0.9
    assert abs(int(got_lens.sum()) - int(want_lens.sum())) <= 0.02 * want_lens.sum()
    np.testing.assert_array_equal(
        got_starts, np.concatenate([[0], np.cumsum(got_lens)[:-1]])
    )
    assert int(got[3]) == int(want[3]) == 0


def test_overflow_is_accumulated_never_silent():
    """Pair-table drops of the prepare are COUNTED into the state, step
    after step."""
    scene, cfg = port_scene(default_scene()), PortConfig(**_KW)
    prepared = port_prog.progressive_prepare(scene, cfg, device="cpu")
    st = port_prog.progressive_tiles_init(cfg, seed=2, device="cpu")
    st = _steps(st, scene, cfg, prepared, 2, 4)
    assert int(st.overflow) == 0 and int(prepared[3]) == 0
    assert st.overflow.dtype == torch.int32
    pairs, starts, lens, _ovf = prepared
    crowded = (pairs, starts, lens, torch.tensor(7, dtype=torch.int32))
    st = port_prog.progressive_tiles_init(cfg, seed=2, device="cpu")
    st = _steps(st, scene, cfg, crowded, 3, 4)
    assert int(st.overflow) == 3 * 7


def test_sobol_cursor_carries_into_hi_word_at_wrap():
    """Power-of-two step sizes land the 64-bit cursor exactly on the
    2^32 boundary; the hi word picks up the carry there. samples_traced
    is a uint32 and wraps."""
    scene, cfg = port_scene(default_scene()), PortConfig(**_KW)
    prepared = port_prog.progressive_prepare(scene, cfg, device="cpu")
    st = port_prog.progressive_tiles_init(cfg, seed=0, device="cpu")
    st = dataclasses.replace(
        st, sample_lo=2**32 - 4, samples_traced=2**32 - 1024
    )
    st = _steps(st, scene, cfg, prepared, 1, 4)
    assert (st.sample_lo, st.sample_hi) == (0, 1)
    assert st.samples_traced == 3 * 1024  # wrapped past 2^32
    st = _steps(st, scene, cfg, prepared, 1, 4)
    assert (st.sample_lo, st.sample_hi) == (4, 1)


def test_unprepared_step_rebins_and_matches_prepared():
    scene, cfg = port_scene(default_scene()), PortConfig(**_KW)
    prepared = port_prog.progressive_prepare(scene, cfg, device="cpu")
    st0 = port_prog.progressive_tiles_init(cfg, seed=3, device="cpu")
    a = _steps(st0, scene, cfg, prepared, 1, 6)
    b = _steps(st0, scene, cfg, None, 1, 6)
    assert torch.equal(a.rows, b.rows) and torch.equal(a.covered, b.covered)
    # a step is pure: the state it was given is unchanged
    assert not st0.covered.any() and st0.sample_lo == 0
    assert (st0.rows[:, 0] == 3.0e38).all()


def test_grow_frameless_capacity_ladder():
    """The frameless ladder doubles global_cap, agrees with the
    reference's rung for rung, and ends with a clean error at the
    ceiling."""
    cfg, ref_cfg = PortConfig(**_KW), RefConfig(**_KW)
    rungs = 0
    while True:
        try:
            ref_cfg = ref_prog.grow_frameless_capacity(ref_cfg)
        except RuntimeError:
            break
        cfg = port_prog.grow_frameless_capacity(cfg)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
        rungs += 1
    assert rungs == 3 and cfg.global_cap == 9 << 16
    with pytest.raises(RuntimeError, match="capacity ceiling"):
        port_prog.grow_frameless_capacity(cfg)
    assert issubclass(port_prog.FramelessCapacityError, RuntimeError)


def test_tile_step_makes_no_host_reads(monkeypatch):
    """Nothing between a tile step's entry and its return reads a tensor
    back to the host. The subset kernel's plain version reads
    max(lens) and is excused — on the card the kernel takes its place."""
    names = ("item", "tolist", "__int__", "__float__", "__bool__",
             "__index__", "nonzero", "unique")
    originals = {name: getattr(torch.Tensor, name) for name in names}
    scene, cfg = port_scene(default_scene()), PortConfig(**_KW)
    prepared = port_prog.progressive_prepare_trimmed(scene, cfg, device="cpu")
    st = port_prog.progressive_tiles_init(cfg, seed=1, device="cpu")
    plain = port_binned.trace_pairs_fused_subset_plain
    calls = []

    def excused(*a, **k):
        with pytest.MonkeyPatch.context() as inner:
            for name in names:
                inner.setattr(torch.Tensor, name, originals[name])
            calls.append(1)
            return plain(*a, **k)

    def forbidden(name):
        def raiser(*a, **k):
            raise AssertionError(f"host read through {name} in a tile step")
        return raiser

    monkeypatch.setattr(port_binned, "trace_pairs_fused_subset_plain", excused)
    for name in names:
        monkeypatch.setattr(torch.Tensor, name, forbidden(name))
    st = _steps(st, scene, cfg, prepared, 2, 4)
    monkeypatch.undo()
    assert calls == [1, 1]
    assert st.sample_lo == 8 and 0 < int(st.covered.sum()) <= 8


def test_states_need_a_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = PortConfig(**_KW)
    scene = port_scene(default_scene())
    with pytest.raises(RuntimeError, match="cuda"):
        port_prog.progressive_tiles_init(cfg)  # default device: "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        port_prog.progressive_init(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        port_prog.progressive_prepare(scene, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        port_prog.progressive_prepare_trimmed(scene, cfg)


def _trim_tie_table():
    """One 32x32 tile seen by a camera at the origin looking down -z
    (fov 90): a small sphere at segment position 0, sphere A (+x, code
    19) at 1, six spheres far outside the tile's frustum at 2..7, and
    sphere B (-x, code 26) at 8 — A and B of one radius mirrored about
    x = 0, so every ray of pixel column 16 (dx == 0 exactly) meets both
    at exactly the same t. Returns (camera leaves, pairs, starts, lens)
    as NumPy arrays."""
    pairs = np.zeros((7, 64), np.float32)
    pairs[3] = -3.0e38

    def put(k, c, r, code):
        c = np.asarray(c, np.float32)
        cc, r2 = np.float32(np.dot(c, c)), np.float32(r * r)
        pairs[0:3, k] = c
        pairs[3, k] = r2 - cc
        pairs[4, k] = code
        pairs[5, k] = np.float32(4900.0) * np.float32(r)
        pairs[6, k] = np.float32(4.0) * r2 - cc

    put(0, [-0.6, 0.6, -3.0], 0.1, 15.0)
    put(1, [0.75, 0.0, -5.0], 1.0, 19.0)
    for k in range(2, 8):
        put(k, [50.0, 0.0, -5.0 - k], 0.1, 28.0 + k)
    put(8, [-0.75, 0.0, -5.0], 1.0, 26.0)
    starts = np.asarray([0], np.int32)
    lens = np.asarray([9], np.int32)
    cam = dict(position=np.zeros(3, np.float32), yaw=np.float32(0.0),
               pitch=np.float32(0.0), roll=np.float32(0.0),
               fov=np.float32(90.0))
    return cam, pairs, starts, lens


def test_trim_can_swap_an_exact_tie_like_the_reference(monkeypatch):
    """The trim's "bit-identical" promise does not cover exact ties. The
    kernels break equal t by (k mod 8, k) of the segment position; the
    trim closes the gaps its dropped pairs leave, so a tied pair behind
    them moves to a smaller k and the winner can change: here B at
    k = 8 (k mod 8 = 0) beats A at k = 1 untrimmed, and after the six
    pairs between them are dropped B sits at k = 2 and A wins. The
    reference package trims the same pairs and swaps the same winner,
    ray for ray — this is the reference's rule, pinned here. Off the tie
    column, trimmed == untrimmed bit for bit in both packages."""
    import jax.numpy as jnp

    from sphereflake_tpu.config import CameraParams as RefCamera
    from sphereflake_tpu.ops import binned as ref_binned

    cam, pairs, starts, lens = _trim_tie_table()
    kw = dict(width=32, height=32, max_depth=3, **_BINNED)
    ids = np.asarray([0], np.int32)

    # The port.
    scene = port_scene(default_scene())
    scene = dataclasses.replace(scene, camera=dataclasses.replace(
        scene.camera, **{k: torch.tensor(v) for k, v in cam.items()}))
    cfg = PortConfig(**kw)
    table = tuple(torch.from_numpy(x) for x in (pairs, starts, lens))
    monkeypatch.setattr(
        port_prog, "progressive_prepare",
        lambda *a, **k: (*table, torch.zeros((), dtype=torch.int32)),
    )
    trimmed = port_prog.progressive_prepare_trimmed(scene, cfg, device="cpu")
    assert trimmed[2].tolist() == [3]  # the six outside the frustum went
    camv = port_binned.camera_vector(scene, cfg)

    def port_rows(p, s, n):
        out, _ = port_binned.trace_pairs_fused_subset(
            camv, p, s, n, torch.from_numpy(ids), cfg, shade_only=True
        )
        return out.numpy()[0].reshape(7, 32, 32)

    untrim_p = port_rows(*table)
    trim_p = port_rows(*trimmed[:3])

    # The reference, on the same table.
    ref_scene = default_scene()
    ref_scene = dataclasses.replace(ref_scene, camera=RefCamera(
        **{k: jnp.asarray(v) for k, v in cam.items()}))
    rcfg = RefConfig(**kw)
    rtable = tuple(jnp.asarray(x) for x in (pairs, starts, lens))
    monkeypatch.setattr(
        ref_prog, "progressive_prepare",
        lambda *a, **k: (*rtable, jnp.int32(0)),
    )
    rtrim = ref_prog.progressive_prepare_trimmed(ref_scene, rcfg)
    assert np.asarray(rtrim[2]).tolist() == [3]
    rcam = ref_binned.camera_vector(ref_scene, rcfg)

    def ref_rows(p, s, n):
        out, _ = ref_binned.trace_pairs_fused_subset(
            rcam, p, s, n, jnp.asarray(ids), rcfg, interpret=True,
            shade_only=True,
        )
        return np.asarray(out)[0].reshape(7, 32, 32)

    untrim_r = ref_rows(*rtable)
    trim_r = ref_rows(*rtrim[:3])

    for untrim, trim in ((untrim_p, trim_p), (untrim_r, trim_r)):
        hit = untrim[0, :, 16] < 1e38
        assert hit.sum() >= 8
        assert (untrim[4, :, 16][hit] > 0.0).all()  # B (-x) won the tie
        assert (trim[4, :, 16][hit] < 0.0).all()  # A (+x) wins trimmed
        off = np.ones(32, bool)
        off[16] = False
        np.testing.assert_array_equal(untrim[:, :, off], trim[:, :, off])
    np.testing.assert_array_equal(trim_p[0] < 1e38, trim_r[0] < 1e38)
    np.testing.assert_array_equal(
        np.sign(trim_p[4, :, 16]), np.sign(trim_r[4, :, 16])
    )
