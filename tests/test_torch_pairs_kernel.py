"""The plain torch version of the fused pairs kernel
(`trace_pairs_fused_plain`, what `trace_pairs_fused_soa` runs for CPU
tensors) vs the reference package's Pallas kernel in interpret mode, on
the reference's own camera pack and pair table. The CUDA kernel itself
is held against the same plain version on the card by `chip_smoke.py`.

Tolerance (the reference's own bars between two of its traversals,
`tests/test_binned.py`): hit mask and path codes equal on >= 99.9 % of
rays, min_t / position within rtol = atol = 1e-4 on >= 99.5 % of common
hits (normals: see `_check_rows`) — XLA's CPU code contracts multiply-adds,
which moves tangent grazes (disc ~ 0, where t = tca - sqrt(disc) is
ill-conditioned) at a handful of silhouette pixels."""

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

from _torch_helpers import off_center
from test_binned import dive_scene

_BIG = np.float32(3.0e38)


def _reference_run(scene, **kw):
    """(numpy cam, pairs, starts, lens, kernel rows, metrics) from the
    reference package, kernel in interpret mode."""
    kw = dict(tile_h=32, tile_w=32, algorithm="binned", **kw)
    cfg = RefConfig(**kw)
    root = root_frame(scene.camera.position)
    templates = child_templates(scene.fractal)
    pairs, starts, lens, _ = ref_binned.binned_pairs(scene, cfg, root, templates)
    cam = ref_binned.camera_vector(scene, cfg)
    out, metrics = ref_binned.trace_pairs_fused_soa(
        cam, pairs, starts, lens, cfg, interpret=True
    )
    return PortConfig(**kw), tuple(
        np.asarray(x) for x in (cam, pairs, starts, lens, out, metrics)
    )


def _port_run(cfg, cam, pairs, starts, lens):
    out, metrics = port_binned.trace_pairs_fused_soa(
        *(tensor_from_numpy(x, "cpu") for x in (cam, pairs, starts, lens)), cfg
    )
    return out.numpy(), metrics.numpy()


def _check_rows(got, want, deep, depth):
    n_code = 2 if deep else 1
    assert got.shape == want.shape and got.shape[1] == (9 if deep else 8)
    code_g, code_w = got[:, 1:1 + n_code], want[:, 1:1 + n_code]
    hit_g, hit_w = (code_g >= 1).any(axis=1), (code_w >= 1).any(axis=1)
    assert (hit_g == hit_w).mean() >= 0.999
    same = (code_g == code_w).all(axis=1)
    assert same.mean() >= 0.999
    both = hit_g & hit_w & same
    assert both.mean() > 0.05  # the comparison is not vacuous
    for row in [0] + list(range(1 + n_code, 4 + n_code)):  # min_t, position
        close = np.isclose(
            got[:, row][both], want[:, row][both], rtol=1e-4, atol=1e-4
        )
        assert close.mean() >= 0.995, f"row {row}: {close.mean()}"
    # normal = (position - centre) / r amplifies a position difference by
    # 1 / r = 3^level: the position's bar (~1e-3 at |position| ~ 9) over
    # the smallest radius rendered.
    n_atol = 1e-3 * 3.0 ** min(depth, 5)
    for row in range(4 + n_code, 7 + n_code):
        close = np.abs(got[:, row][both] - want[:, row][both]) <= n_atol
        assert close.mean() >= 0.995, f"row {row}: {close.mean()}"
    # Sky rays: min_t = BIG, position and normal zero.
    sky = ~hit_g
    assert (got[:, 0][sky] == _BIG).all()
    assert (got[:, 1 + n_code:][np.broadcast_to(
        sky[:, None], got[:, 1 + n_code:].shape)] == 0).all()


@pytest.mark.parametrize(
    "name,build,kw",
    [
        ("reference_d3", lambda s: s, dict(width=128, height=96, max_depth=3)),
        ("off_center_d2", lambda s: off_center(s, 0.1, 0.08),
         dict(width=128, height=64, max_depth=2)),
        ("padded_d2", lambda s: s, dict(width=100, height=60, max_depth=2)),
    ],
)
def test_plain_matches_reference_kernel_shallow(name, build, kw):
    cfg, (cam, pairs, starts, lens, want, want_m) = _reference_run(
        build(default_scene()), **kw
    )
    got, got_m = _port_run(cfg, cam, pairs, starts, lens)
    _check_rows(got, want, deep=False, depth=kw["max_depth"])
    np.testing.assert_array_equal(got_m, want_m)
    assert got_m.dtype == np.int32 and (got_m[:, 0, 0] == lens).all()


def test_plain_matches_reference_kernel_deep():
    """max_depth == 7 on a dive pose: level-7 codes live in the hi lane,
    8 payload rows in, 9 rows out."""
    cfg, (cam, pairs, starts, lens, want, want_m) = _reference_run(
        dive_scene(), width=64, height=32, max_depth=7, global_cap=1 << 15
    )
    assert pairs.shape[0] == 8
    got, got_m = _port_run(cfg, cam, pairs, starts, lens)
    _check_rows(got, want, deep=True, depth=7)
    assert (got[:, 2] >= 1).mean() > 0.05  # hi-lane hits are present
    np.testing.assert_array_equal(got_m, want_m)


def _tie_table(deep):
    """One 32x32 tile whose segment holds the SAME sphere at positions
    3, 8, 9 and 16 under different codes (exact ties in t at every ray
    that hits it), a nearer small sphere at position 5, and fillers that
    can never be hit."""
    n_rows, seg = (8, 20) if deep else (7, 20)
    r_lodr, r_rc4 = (6, 7) if deep else (5, 6)
    pairs = np.zeros((n_rows, 64), np.float32)
    pairs[3] = -_BIG  # fillers: disc < 0 always

    def put(k, c, r, code):
        cc = np.float32(np.dot(c, c))
        r2 = np.float32(r * r)
        pairs[0:3, k] = c
        pairs[3, k] = r2 - cc
        pairs[4, k] = code
        if deep:
            pairs[5, k] = code + 1
        pairs[r_lodr, k] = np.float32(4900.0) * np.float32(r)
        pairs[r_rc4, k] = np.float32(4.0) * r2 - cc

    c = np.asarray([0.0, 0.0, -5.0], np.float32)
    for k, code in ((3, 13.0), (8, 18.0), (9, 19.0), (16, 26.0)):
        put(k, c, 1.0, code)
    put(5, np.asarray([0.3, 0.2, -3.0], np.float32), 0.2, 15.0)
    # Camera at the origin looking down -z over a 32x32 frame.
    cam = np.asarray(
        [-0.5, 0.5, -1.0, 1.0, 0.0, 0.0, 0.0, -1.0, 0.0, 0.0, 0.0, 0.0,
         0.0, 0.0, 32.0, 32.0], np.float32,
    )
    starts = np.asarray([2], np.int32)  # a segment that does not start at 0
    lens = np.asarray([seg], np.int32)
    return cam, np.roll(pairs, 2, axis=1), starts, lens


@pytest.mark.parametrize("deep", [False, True], ids=["shallow", "deep"])
def test_exact_tie_goes_to_smallest_k_mod_8_then_k(deep):
    """Among candidates with the same minimal t the winner is the one
    with the smallest (k mod 8, k) of its segment position: here k = 8
    (chain 0) beats k = 16 (chain 0, later), k = 9 (chain 1) and k = 3
    (chain 3). The reference kernel decides the same way on the same
    table, ray for ray."""
    kw = dict(width=32, height=32, tile_h=32, tile_w=32, algorithm="binned",
              max_depth=7 if deep else 3)
    cam, pairs, starts, lens = _tie_table(deep)
    got, _ = _port_run(PortConfig(**kw), cam, pairs, starts, lens)
    code = got[0, 1].reshape(-1)
    assert set(np.unique(code)) == {0.0, 15.0, 18.0}
    assert (code == 18.0).sum() > 50 and (code == 15.0).sum() > 5
    want, _ = ref_binned.trace_pairs_fused_soa(
        jnp.asarray(cam), jnp.asarray(pairs), jnp.asarray(starts),
        jnp.asarray(lens), RefConfig(**kw), interpret=True,
    )
    want = np.asarray(want)
    np.testing.assert_array_equal(got[0, 1], want[0, 1])
    if deep:
        np.testing.assert_array_equal(got[0, 2], want[0, 2])
        assert (got[0, 2].reshape(-1)[code == 18.0] == 19.0).all()
    hit = code >= 1
    np.testing.assert_allclose(
        got[0, 0].reshape(-1)[hit], want[0, 0].reshape(-1)[hit],
        rtol=1e-5, atol=1e-5,
    )


def _valid_inputs():
    cfg = PortConfig(width=64, height=32, tile_h=32, tile_w=32,
                     algorithm="binned", max_depth=2)
    cam = torch.from_numpy(_tie_table(False)[0])  # a well-formed camera
    pairs = torch.zeros((7, 128), dtype=torch.float32)
    starts = torch.zeros(2, dtype=torch.int32)
    lens = torch.zeros(2, dtype=torch.int32)
    return cfg, [cam, pairs, starts, lens]


@pytest.mark.parametrize(
    "index,mutate,error",
    [
        (1, lambda x: x.double(), TypeError),
        (2, lambda x: x.long(), TypeError),
        (3, lambda x: x.float(), TypeError),
        (0, lambda x: x.numpy(), TypeError),
        (1, lambda x: torch.zeros((7, 256))[:, ::2], ValueError),
        (1, lambda x: torch.zeros((8, 128)), ValueError),
        (0, lambda x: torch.zeros(12), ValueError),
        (2, lambda x: torch.zeros(3, dtype=torch.int32), ValueError),
        (3, lambda x: torch.zeros((2, 1), dtype=torch.int32), ValueError),
    ],
    ids=["pairs-f64", "starts-i64", "lens-f32", "cam-numpy",
         "pairs-strided", "pairs-rows", "cam-size", "starts-size",
         "lens-rank"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(index, mutate, error):
    cfg, args = _valid_inputs()
    port_binned.trace_pairs_fused_soa(*args, cfg)  # the valid call passes
    args[index] = mutate(args[index])
    with pytest.raises(error):
        port_binned.trace_pairs_fused_soa(*args, cfg)


def test_cpu_tensors_do_not_count_as_kernel_launches():
    cfg, args = _valid_inputs()
    before = port_binned.trace_pairs_fused_soa.launches
    out, metrics = port_binned.trace_pairs_fused_soa(*args, cfg)
    assert port_binned.trace_pairs_fused_soa.launches == before
    assert out.shape == (2, 8, 8, 128) and metrics.shape == (2, 1, 4)
    assert (out[:, 0] == 3.0e38).all() and (out[:, 1:] == 0).all()
