"""The port's sharded frameless refresh
(`sphereflake_tpu_torch/parallel/frameless.py`, meshes of repeated CPU
devices: the subset kernel's plain version) vs the reference package's
(`sphereflake_tpu/parallel/frameless.py`, the Pallas kernel in
interpret mode), and vs the port's single-device frameless state.

- Against the reference: one reference program, `sharded_tiles_step` at
  128x64, depth 2, 32x32 tiles over a 2x2 mesh (re-binned inside the
  step), run twice from one state in a module fixture. Integers — which
  tiles each cell refreshed (`covered`), the per-cell cursors, the seed,
  samples_traced, overflow — bit for bit; float rows at the bars of
  `test_torch_progressive_tiles.py` (min_t / position within
  rtol = atol = 1e-4 on >= 99 % of the refreshed values).
- Within the port: at full coverage the sharded state equals the
  single-device state tile for tile, bit for bit, and the full render's
  min_t; cells refresh only their own blocks; the per-cell cursor
  carries into its hi word at the 2^32 wrap (ROADMAP queue 3, reference
  `parallel/frameless.py:190-198`); checkpoints pass between the
  packages both ways under the key `progressive_tiles_sharded`.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sphereflake_tpu.config import RenderConfig as RefConfig
from sphereflake_tpu.config import default_scene
from sphereflake_tpu.parallel import frameless as ref_frameless
from sphereflake_tpu.parallel import make_mesh as ref_make_mesh
from sphereflake_tpu.runtime import checkpoint as ref_ckpt
from sphereflake_tpu_torch.config import RenderConfig
from sphereflake_tpu_torch.convert import leaves_from_numpy
from sphereflake_tpu_torch.ops.sobol import sobol_sample_np
from sphereflake_tpu_torch.parallel import (
    make_mesh,
    sharded_tiles_as_single,
    sharded_tiles_init,
    sharded_tiles_step,
)
from sphereflake_tpu_torch.parallel import frameless as port_frameless
from sphereflake_tpu_torch.render import render_gbuffer
from sphereflake_tpu_torch.runtime import checkpoint as port_ckpt
from sphereflake_tpu_torch.runtime import progressive as port_prog

from _torch_helpers import port_scene

_BINNED = dict(tile_h=32, tile_w=32, algorithm="binned")
_KW = dict(width=128, height=64, max_depth=2, **_BINNED)  # 2x4 tiles
_SEED = 2**31 + 5
_M32 = 0xFFFFFFFF


def _cpu_mesh(shape):
    return make_mesh(["cpu"] * (shape[0] * shape[1]), shape=shape)


def _to_numpy(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


@pytest.fixture(scope="module")
def reference_steps():
    """Two reference steps of one tile per cell (each cell owns 2).
    The state between them is brought back to host-made arrays, so the
    second call reuses the first one's compiled program."""
    scene, cfg = default_scene(), RefConfig(**_KW)
    mesh = ref_make_mesh(jax.devices()[:4], shape=(2, 2))
    st0 = ref_frameless.sharded_tiles_init(cfg, mesh, seed=_SEED)
    st1 = ref_frameless.sharded_tiles_step(st0, scene, cfg, mesh,
                                           tiles_per_device=1)
    st1 = jax.tree.map(lambda x: jax.numpy.asarray(np.asarray(x)), st1)
    st2 = ref_frameless.sharded_tiles_step(st1, scene, cfg, mesh,
                                           tiles_per_device=1)
    return dict(scene=scene, mesh=mesh, st1=st1, np1=_to_numpy(st1),
                np2=_to_numpy(st2))


def _check_against_reference(got, want, partial=True):
    np.testing.assert_array_equal(got.covered.numpy(), want["covered"])
    cov = want["covered"]
    if partial:  # partially covered: the ids matter
        assert 0 < cov.sum() < cov.size
    for name in ("sample_lo", "sample_hi"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      want[name].astype(np.int64))
    assert got.seed == int(want["seed"])
    assert got.samples_traced == int(want["samples_traced"])
    assert int(got.overflow) == int(want["overflow"]) == 0
    rows_g, rows_w = got.rows.numpy(), want["rows"]
    assert rows_g.shape == rows_w.shape == (2, 4, 7, 8, 128)
    np.testing.assert_array_equal(rows_g[~cov], rows_w[~cov])
    hit_g, hit_w = rows_g[cov][:, 0] < 1e38, rows_w[cov][:, 0] < 1e38
    assert (hit_g == hit_w).mean() >= 0.999
    both = hit_g & hit_w
    for row in range(4):  # min_t, position
        close = np.isclose(rows_g[cov][:, row][both],
                           rows_w[cov][:, row][both], rtol=1e-4, atol=1e-4)
        assert close.mean() >= 0.99
    np.testing.assert_allclose(float(got.closest_distance),
                               float(want["closest_distance"]), rtol=1e-4)


def test_sharded_step_matches_reference(reference_steps):
    scene = port_scene(reference_steps["scene"])
    cfg, mesh = RenderConfig(**_KW), _cpu_mesh((2, 2))
    st = sharded_tiles_init(cfg, mesh, seed=_SEED)
    st = sharded_tiles_step(st, scene, cfg, mesh, tiles_per_device=1)
    _check_against_reference(st, reference_steps["np1"])
    assert st.sample_lo.dtype == torch.int64 and st.sample_lo.shape == (2, 2)


def test_checkpoints_pass_both_ways(reference_steps, tmp_path):
    """A reference state saved by the reference continues in the port
    (its next step equals the reference's), and the port's state loads
    into the reference's template unchanged."""
    scene = port_scene(reference_steps["scene"])
    cfg, mesh = RenderConfig(**_KW), _cpu_mesh((2, 2))
    ref_path = tmp_path / "ref.npz"
    ref_ckpt.save_checkpoint(str(ref_path), progressive_tiles_sharded=(
        reference_steps["st1"]))
    st1 = port_ckpt.load_checkpoint(str(ref_path), {
        "progressive_tiles_sharded": sharded_tiles_init(cfg, mesh)
    })["progressive_tiles_sharded"]
    assert st1.seed == _SEED and isinstance(st1.samples_traced, int)
    st2 = sharded_tiles_step(st1, scene, cfg, mesh, tiles_per_device=1)
    _check_against_reference(st2, reference_steps["np2"], partial=False)

    port_path = tmp_path / "port.npz"
    port_ckpt.save_checkpoint(str(port_path), progressive_tiles_sharded=st2)
    template = ref_frameless.sharded_tiles_init(
        RefConfig(**_KW), reference_steps["mesh"])
    back = ref_ckpt.load_checkpoint(str(port_path), {
        "progressive_tiles_sharded": template
    })["progressive_tiles_sharded"]
    for name, want in _to_numpy(st2).items():
        got = np.asarray(getattr(back, name))
        assert got.dtype == np.asarray(getattr(template, name)).dtype, name
        np.testing.assert_array_equal(got.astype(np.float64),
                                      np.asarray(want, dtype=np.float64))


def test_full_coverage_equals_single_device_state():
    """The reference's own case (`tests/test_sharded.py:277-330`) on the
    port: 256x128, depth 3, 2x4 cells."""
    scene = port_scene(default_scene())
    cfg = RenderConfig(width=256, height=128, max_depth=3, **_BINNED)
    mesh = _cpu_mesh((2, 4))  # tiles 4x8 -> 2x2 per cell
    T = cfg.tiles_y * cfg.tiles_x
    prepared = port_prog.progressive_prepare(scene, cfg, device="cpu")
    st_s = sharded_tiles_init(cfg, mesh, seed=5)
    for _ in range(8):
        st_s = sharded_tiles_step(st_s, scene, cfg, mesh,
                                  tiles_per_device=4, prepared=prepared)
    assert int(st_s.covered.sum()) == T and int(st_s.overflow) == 0
    st_1 = port_prog.progressive_tiles_init(cfg, seed=5, device="cpu")
    for _ in range(10):
        st_1 = port_prog.progressive_tiles_step(
            st_1, scene, cfg, tiles_per_step=8, prepared=prepared)
    assert int(st_1.covered.sum()) == T
    view = sharded_tiles_as_single(st_s)
    assert torch.equal(view.rows, st_1.rows)
    _p, _n, min_t, _h = port_prog.tile_progressive_gbuffer(view, cfg)
    assert torch.equal(min_t, render_gbuffer(scene, cfg, device="cpu").min_t)
    assert float(st_s.closest_distance) == float(st_1.closest_distance)
    assert st_s.samples_traced == 8 * 8 * 4 * 1024


def test_cells_refresh_only_their_own_blocks():
    scene = port_scene(default_scene())
    cfg = RenderConfig(width=256, height=128, max_depth=2, **_BINNED)
    mesh = _cpu_mesh((4, 2))  # tiles 4x8 -> 1x4 per cell
    st = sharded_tiles_init(cfg, mesh, seed=1)
    st = sharded_tiles_step(st, scene, cfg, mesh, tiles_per_device=1,
                            prepared=port_prog.progressive_prepare(
                                scene, cfg, device="cpu"))
    cov = st.covered.numpy()
    assert cov.sum() == 8
    for iy in range(4):
        for ix in range(2):
            assert cov[iy:iy + 1, ix * 4:(ix + 1) * 4].sum() == 1


def test_cursor_carries_into_the_hi_word_at_the_wrap():
    """Cell cursors near 2^32: the Sobol indices are those of the 64-bit
    cursor, and the step's cursor carries into the hi word — landing
    exactly on the boundary (a power-of-two step) and crossing it."""
    cfg, mesh = RenderConfig(width=128, height=64, max_depth=1,
                             **_BINNED), _cpu_mesh((1, 2))
    bty, btx = 2, 2
    st = sharded_tiles_init(cfg, mesh, seed=9)
    st.sample_lo[:] = torch.tensor([[2**32 - 128, 2**32 - 100]])
    st.sample_hi[:] = torch.tensor([[3, 2**32 - 1]])
    for ix in range(2):
        lo, hi = int(st.sample_lo[0, ix]), int(st.sample_hi[0, ix])
        got = port_frameless._cell_tile_ids(st, cfg, mesh, 0, ix, 128, "cpu")
        index = ((hi << 32) + lo + np.arange(128, dtype=np.uint64)) % 2**52
        scr = port_prog._hash_u32(9 ^ (ix + 1))
        s = sobol_sample_np(index.astype(np.uint64), 0, scr)
        local = np.minimum((s.astype(np.float32) * np.float32(4)).astype(
            np.int32), 3)
        want = (local // btx) * cfg.tiles_x + ix * btx + local % btx
        np.testing.assert_array_equal(got.numpy(), want)
    st = sharded_tiles_step(st, port_scene(default_scene()), cfg, mesh,
                            tiles_per_device=128)
    assert st.sample_lo.tolist() == [[0, 28]]
    assert st.sample_hi.tolist() == [[4, 0]]  # the hi word wraps too
    assert all(0 <= v <= _M32 for v in st.sample_hi.view(-1).tolist())
    # A state's cursors as the reference holds them: uint32 words.
    words = leaves_from_numpy(st, [np.asarray(x) for x in
                                   port_ckpt.leaves_to_numpy(st)])
    assert torch.equal(words.sample_hi, st.sample_hi)
