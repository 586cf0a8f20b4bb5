"""The plain torch version of the pairs kernel's subset mode
(`trace_pairs_fused_subset_plain`, what `trace_pairs_fused_subset` runs
for CPU tensors) vs the reference package's Pallas kernel in interpret
mode (`indirect=True`, with and without `shade_only`), on the
reference's own camera pack and pair table and on tile ids that repeat
and are not sorted. The CUDA kernel itself is held against the same
plain version on the card by `chip_smoke.py`.

Tolerance (as for the full-grid mode, `test_torch_pairs_kernel.py`):
hit masks (and codes, where there are codes) equal on >= 99.9 % of
rays, min_t / position within rtol = atol = 1e-4 on >= 99.5 % of common
hits — XLA's CPU code contracts multiply-adds, which moves tangent
grazes at a handful of silhouette pixels. Against the port's own
full-grid plain version the subset rows are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphereflake_tpu.config import RenderConfig as RefConfig
from sphereflake_tpu.config import default_scene
from sphereflake_tpu.models.sphereflake import child_templates, root_frame
from sphereflake_tpu.ops import binned as ref_binned
from sphereflake_tpu_torch.config import RenderConfig as PortConfig
from sphereflake_tpu_torch.convert import tensor_from_numpy
from sphereflake_tpu_torch.ops import binned as port_binned

from _torch_helpers import port_scene
from test_binned import dive_scene
from test_torch_pairs_kernel import _check_rows, _tie_table

_BIG = np.float32(3.0e38)
_SHADED = [0, 2, 3, 4, 5, 6, 7]  # (min_t, pos3, nrm3) of the 8 coded rows


def _reference_table(scene, **kw):
    kw = dict(tile_h=32, tile_w=32, algorithm="binned", **kw)
    cfg = RefConfig(**kw)
    root = root_frame(scene.camera.position)
    templates = child_templates(scene.fractal)
    pairs, starts, lens, _ = ref_binned.binned_pairs(scene, cfg, root, templates)
    cam = ref_binned.camera_vector(scene, cfg)
    return cfg, PortConfig(**kw), (cam, pairs, starts, lens)


def _tensors(*arrays):
    return [tensor_from_numpy(np.asarray(x), "cpu") for x in arrays]


def _check_shaded(got, want, depth):
    """7-row (min_t, pos3, nrm3) comparison; a hit is min_t < BIG / 2."""
    assert got.shape == want.shape and got.shape[1] == 7
    hit_g, hit_w = got[:, 0] < 1e38, want[:, 0] < 1e38
    assert (hit_g == hit_w).mean() >= 0.999
    both = hit_g & hit_w
    assert both.mean() > 0.05
    for row in range(4):  # min_t, position
        close = np.isclose(
            got[:, row][both], want[:, row][both], rtol=1e-4, atol=1e-4
        )
        assert close.mean() >= 0.995, f"row {row}: {close.mean()}"
    n_atol = 1e-3 * 3.0 ** min(depth, 5)  # see `_check_rows`
    for row in range(4, 7):
        close = np.abs(got[:, row][both] - want[:, row][both]) <= n_atol
        assert close.mean() >= 0.995, f"row {row}: {close.mean()}"
    sky = ~hit_g
    assert (got[:, 0][sky] == _BIG).all()
    assert (got[:, 1:][np.broadcast_to(sky[:, None], got[:, 1:].shape)] == 0).all()


_CASES = {
    "shallow": (
        lambda: default_scene(), dict(width=128, height=64, max_depth=2),
        [5, 0, 7, 5, 2, 2, 6, 1, 5, 3, 4, 0],  # 12 ids: repeats, unsorted
    ),
    "depth7": (
        dive_scene, dict(width=64, height=32, max_depth=7, global_cap=1 << 15),
        [1, 0, 1],
    ),
}


@pytest.mark.parametrize("shade_only", [True, False], ids=["shade_only", "coded"])
@pytest.mark.parametrize("case", ["shallow", "depth7"])
def test_plain_matches_reference_subset_kernel(case, shade_only):
    make_scene, kw, id_list = _CASES[case]
    ref_cfg, cfg, table = _reference_table(make_scene(), **kw)
    ids = np.asarray(id_list, np.int32)
    want, want_m = ref_binned.trace_pairs_fused_subset(
        *table, jnp.asarray(ids), ref_cfg, interpret=True,
        shade_only=shade_only,
    )
    want, want_m = np.asarray(want), np.asarray(want_m)
    got, got_m = port_binned.trace_pairs_fused_subset(
        *_tensors(*table, ids), cfg, shade_only=shade_only
    )
    got, got_m = got.numpy(), got_m.numpy()
    deep = kw["max_depth"] >= 7
    if shade_only:
        _check_shaded(got, want, kw["max_depth"])
    else:
        _check_rows(got, want, deep=deep, depth=kw["max_depth"])
    np.testing.assert_array_equal(got_m, want_m)
    assert (got_m[:, 0, 0] == np.asarray(table[3])[ids]).all()
    # Rows of a repeated id are identical.
    first, again = id_list.index(id_list[-1]), len(id_list) - 1
    assert first != again
    np.testing.assert_array_equal(got[first], got[again])


@pytest.mark.parametrize("case", ["shallow", "depth7"])
def test_subset_rows_equal_full_grid_rows_at_the_ids(case):
    """Exact, in the port (on its own pair table): the subset plain
    version on ids == the full-grid plain version gathered at those
    ids, coded rows and `shade_only` rows alike (same walk, same raygen,
    same epilogue)."""
    from sphereflake_tpu_torch.models import sphereflake as port_model

    make_scene, kw, id_list = _CASES[case]
    cfg = PortConfig(tile_h=32, tile_w=32, algorithm="binned", **kw)
    scene = port_scene(make_scene())
    pairs, starts, lens, _ = port_binned.binned_pairs(
        scene, cfg, port_model.root_frame(scene.camera.position),
        port_model.child_templates(scene.fractal),
    )
    cam = port_binned.camera_vector(scene, cfg)
    ids = torch.tensor(id_list, dtype=torch.int32)
    full, _ = port_binned.trace_pairs_fused_plain(cam, pairs, starts, lens, cfg)
    coded, m = port_binned.trace_pairs_fused_subset_plain(
        cam, pairs, starts, lens, ids, cfg
    )
    shaded, m2 = port_binned.trace_pairs_fused_subset_plain(
        cam, pairs, starts, lens, ids, cfg, shade_only=True
    )
    gathered = full[ids.long()]
    assert float((gathered[:, 0] < 1e38).float().mean()) > 0.05
    assert torch.equal(coded, gathered)
    rows = _SHADED if kw["max_depth"] < 7 else [0, 3, 4, 5, 6, 7, 8]
    assert torch.equal(shaded, gathered[:, rows])
    assert torch.equal(m, m2) and torch.equal(m[:, 0, 0], lens[ids.long()])


def _mirror_tie_table():
    """One 32x32 tile, camera at the origin looking down -z: two spheres
    of one radius mirrored about the plane x = 0, at segment positions 9
    (+x) and 16 (-x). Every ray of pixel column 16 has dx == 0 exactly,
    so it meets both at exactly the same t; the winner decides the
    normal's x sign."""
    cam, pairs, starts, lens = _tie_table(False)
    pairs = np.roll(pairs, -2, axis=1)  # back to segment positions
    pairs[:, :] = 0
    pairs[3] = -_BIG

    def put(k, c, r, code):
        c = np.asarray(c, np.float32)
        cc, r2 = np.float32(np.dot(c, c)), np.float32(r * r)
        pairs[0:3, k] = c
        pairs[3, k] = r2 - cc
        pairs[4, k] = code
        pairs[5, k] = np.float32(4900.0) * np.float32(r)
        pairs[6, k] = np.float32(4.0) * r2 - cc

    put(9, [0.75, 0.0, -5.0], 1.0, 19.0)
    put(16, [-0.75, 0.0, -5.0], 1.0, 26.0)
    return cam, np.roll(pairs, 2, axis=1), starts, lens


def test_exact_tie_under_shade_only_decides_the_normal():
    """Without codes the tie rule still picks the winner's centre: on
    the column where both mirrored spheres are met at the same t, the
    candidate at position 16 (chain 0) beats the one at position 9
    (chain 1), so the normal points to +x (away from the -x sphere). The
    reference kernel decides the same way, ray for ray."""
    kw = dict(width=32, height=32, tile_h=32, tile_w=32, algorithm="binned",
              max_depth=3)
    cam, pairs, starts, lens = _mirror_tie_table()
    ids = np.asarray([0], np.int32)
    got, _ = port_binned.trace_pairs_fused_subset(
        *_tensors(cam, pairs, starts, lens, ids), PortConfig(**kw),
        shade_only=True,
    )
    got = got.numpy()[0].reshape(7, 32, 32)
    col = got[:, :, 16]  # rows of the image, pixel column 16
    hit = col[0] < 1e38
    assert hit.sum() >= 8
    assert (col[4][hit] > 0.5).all()  # nx: the -x sphere won the tie
    want, _ = ref_binned.trace_pairs_fused_subset(
        jnp.asarray(cam), jnp.asarray(pairs), jnp.asarray(starts),
        jnp.asarray(lens), jnp.asarray(ids), RefConfig(**kw),
        interpret=True, shade_only=True,
    )
    want = np.asarray(want)[0].reshape(7, 32, 32)
    np.testing.assert_array_equal(want[0, :, 16] < 1e38, hit)
    np.testing.assert_array_equal(
        np.sign(want[4, :, 16][hit]), np.sign(col[4][hit])
    )
    # The coded flavour names the winner outright.
    coded, _ = port_binned.trace_pairs_fused_subset(
        *_tensors(cam, pairs, starts, lens, ids), PortConfig(**kw)
    )
    code_col = coded.numpy()[0, 1].reshape(32, 32)[:, 16]
    assert set(np.unique(code_col[hit])) == {26.0}


def _valid_inputs():
    cfg = PortConfig(width=64, height=32, tile_h=32, tile_w=32,
                     algorithm="binned", max_depth=2)
    cam = torch.from_numpy(_tie_table(False)[0])
    pairs = torch.zeros((7, 128), dtype=torch.float32)
    starts = torch.zeros(2, dtype=torch.int32)
    lens = torch.zeros(2, dtype=torch.int32)
    ids = torch.tensor([1, 0, 1], dtype=torch.int32)
    return cfg, [cam, pairs, starts, lens, ids]


@pytest.mark.parametrize(
    "index,mutate,error",
    [
        (4, lambda x: x.long(), TypeError),
        (4, lambda x: x.float(), TypeError),
        (4, lambda x: x.tolist(), TypeError),
        (4, lambda x: x.reshape(3, 1), ValueError),
        (4, lambda x: torch.zeros(6, dtype=torch.int32)[::2], ValueError),
        (1, lambda x: x.double(), TypeError),
        (1, lambda x: torch.zeros((8, 128)), ValueError),
        (2, lambda x: torch.zeros(3, dtype=torch.int32), ValueError),
        (0, lambda x: torch.zeros(12), ValueError),
    ],
    ids=["ids-i64", "ids-f32", "ids-list", "ids-rank", "ids-strided",
         "pairs-f64", "pairs-rows", "starts-size", "cam-size"],
)
@pytest.mark.parametrize("shade_only", [True, False])
def test_wrapper_rejects_what_the_kernel_does_not_take(
    index, mutate, error, shade_only
):
    cfg, args = _valid_inputs()
    port_binned.trace_pairs_fused_subset(*args, cfg, shade_only=shade_only)
    args[index] = mutate(args[index])
    with pytest.raises(error):
        port_binned.trace_pairs_fused_subset(*args, cfg, shade_only=shade_only)


def test_cpu_tensors_count_no_launch_and_empty_id_lists_return_empty():
    cfg, args = _valid_inputs()
    before = port_binned.trace_pairs_fused_subset.launches
    out, metrics = port_binned.trace_pairs_fused_subset(
        *args, cfg, shade_only=True
    )
    assert out.shape == (3, 7, 8, 128) and metrics.shape == (3, 1, 4)
    assert (out[:, 0] == 3.0e38).all() and (out[:, 1:] == 0).all()
    coded, _ = port_binned.trace_pairs_fused_subset(*args, cfg)
    assert coded.shape == (3, 8, 8, 128)
    args[4] = torch.zeros(0, dtype=torch.int32)
    empty, empty_m = port_binned.trace_pairs_fused_subset(
        *args, cfg, shade_only=True
    )
    assert empty.shape == (0, 7, 8, 128) and empty_m.shape == (0, 1, 4)
    assert port_binned.trace_pairs_fused_subset.launches == before
    assert port_binned.trace_pairs_fused_soa.launches >= 0  # own counters
    assert (port_binned.trace_pairs_fused_subset
            is not port_binned.trace_pairs_fused_soa)
