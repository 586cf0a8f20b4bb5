"""The plain torch version of the pairs kernel's ray-bundle mode
(`trace_pairs_pallas_soa_plain`, what `trace_pairs_pallas_soa` runs for
CPU tensors) vs the reference package's Pallas kernel in interpret mode
(`fused=None`), on the reference's own pair table: bundles of 1024
arbitrary rays against spans of any length — longer than one
shared-memory chunk (256 pairs), the whole table, and empty. The CUDA
kernel itself is held against the same plain version on the card by
`chip_smoke.py`.

Tolerance: t within rtol = atol = 1e-4 on >= 99.5 % of common hits and
hit masks equal on >= 99.9 % of rays (XLA's CPU code contracts
multiply-adds, which moves tangent grazes); codes and centres are
compared where both sides picked the same winner, which must be
>= 99.9 % of rays — two candidates whose t differ by ulps can swap."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphereflake_tpu.camera import ray_directions
from sphereflake_tpu.config import RenderConfig as RefConfig
from sphereflake_tpu.config import default_scene
from sphereflake_tpu.models.sphereflake import child_templates, root_frame
from sphereflake_tpu.ops import binned as ref_binned
from sphereflake_tpu_torch.config import RenderConfig as PortConfig
from sphereflake_tpu_torch.convert import tensor_from_numpy
from sphereflake_tpu_torch.ops import binned as port_binned

from _torch_helpers import port_scene
from test_binned import dive_scene

_BIG = np.float32(3.0e38)


def _bundles(scene, n_bundles, seed, **kw):
    """Reference pair table plus `n_bundles` bundles of random pixels,
    tile-sorted as `progressive_step` sorts them, each with the span of
    the tiles it touches. The last two bundles get the whole table and
    an empty span."""
    kw = dict(tile_h=32, tile_w=32, algorithm="binned", **kw)
    cfg = RefConfig(**kw)
    root = root_frame(scene.camera.position)
    templates = child_templates(scene.fractal)
    pairs, starts, lens, _ = ref_binned.binned_pairs(scene, cfg, root, templates)
    starts_np, lens_np = np.asarray(starts), np.asarray(lens)
    rng = np.random.default_rng(seed)
    n = n_bundles * 1024
    px = rng.integers(0, cfg.width, n).astype(np.float32)
    py = rng.integers(0, cfg.height, n).astype(np.float32)
    tile = (py // 32).astype(np.int32) * cfg.tiles_x + (px // 32).astype(np.int32)
    order = np.argsort(tile, kind="stable")
    dirs = np.asarray(ray_directions(
        scene.camera, jnp.asarray(px[order]), jnp.asarray(py[order]),
        cfg.width, cfg.height,
    )).reshape(n_bundles, 1024, 3)
    tid = tile[order].reshape(n_bundles, 1024)
    t_lo, t_hi = tid[:, 0], tid[:, -1]
    b_start = starts_np[t_lo]
    b_len = starts_np[t_hi] + lens_np[t_hi] - b_start
    b_start[-2], b_len[-2] = 0, starts_np[-1] + lens_np[-1]  # everything
    b_len[-1] = 0  # nothing
    return cfg, PortConfig(**kw), (
        dirs, np.asarray(pairs), b_start.astype(np.int32),
        b_len.astype(np.int32),
    )


def _check(got, want, deep):
    n_code = 2 if deep else 1
    assert got.shape == want.shape and got.shape[1] == 4 + n_code
    code_g, code_w = got[:, 1:1 + n_code], want[:, 1:1 + n_code]
    hit_g, hit_w = (code_g >= 1).any(axis=1), (code_w >= 1).any(axis=1)
    assert (hit_g == hit_w).mean() >= 0.999
    same = (code_g == code_w).all(axis=1)
    assert same.mean() >= 0.999
    both = hit_g & hit_w
    close = np.isclose(got[:, 0][both], want[:, 0][both], rtol=1e-4, atol=1e-4)
    assert close.mean() >= 0.995
    # Same winner -> the very same centre columns of the table.
    same_hit = both & same
    for row in range(1 + n_code, 4 + n_code):
        np.testing.assert_array_equal(got[:, row][same_hit], want[:, row][same_hit])
    # No candidate passed: t stays BIG, codes and centre stay 0.
    miss = ~hit_g
    assert (got[:, 0][miss] == _BIG).all()
    assert (got[:, 1:][np.broadcast_to(miss[:, None], got[:, 1:].shape)] == 0).all()
    return both


@pytest.mark.parametrize(
    "name,make_scene,n_bundles,kw",
    [
        ("shallow", default_scene, 5, dict(width=128, height=96, max_depth=3)),
        ("depth7", dive_scene, 3,
         dict(width=64, height=32, max_depth=7, global_cap=1 << 15)),
    ],
)
def test_plain_matches_reference_dirs_kernel(name, make_scene, n_bundles, kw):
    ref_cfg, cfg, (dirs, pairs, b_start, b_len) = _bundles(
        make_scene(), n_bundles, seed=len(name), **kw
    )
    deep = kw["max_depth"] >= 7
    assert b_len.max() > 256 and b_len[-1] == 0  # > one chunk, and empty
    dirs_k = np.ascontiguousarray(
        np.moveaxis(dirs, 2, 1).reshape(n_bundles, 3, 8, 128)
    )
    want, want_m = ref_binned.trace_pairs_pallas_soa(
        jnp.asarray(dirs_k), jnp.asarray(pairs), jnp.asarray(b_start),
        jnp.asarray(b_len), ref_cfg, interpret=True,
    )
    want, want_m = np.asarray(want), np.asarray(want_m)
    got, got_m = port_binned.trace_pairs_pallas_soa(
        *(tensor_from_numpy(x, "cpu") for x in (dirs_k, pairs, b_start, b_len)),
        cfg,
    )
    got, got_m = got.numpy(), got_m.numpy()
    both = _check(got, want, deep)
    assert both[:-1].mean() > 0.05 and not both[-1].any()  # empty span: sky
    np.testing.assert_array_equal(got_m, want_m)
    assert (got_m[:, 0, 0] == b_len).all() and (got_m[:, 0, 1:] == 0).all()
    if deep:
        assert (got[:, 2] >= 1).mean() > 0.05  # hi-lane winners present



@pytest.mark.parametrize("deep", [False, True], ids=["shallow", "deep"])
def test_aos_wrapper_unpacks_the_soa_rows(deep):
    """`trace_pairs_pallas` takes [B, 1024, 3] directions and returns
    (min_t, code_lo, code_hi or None, metrics) of the same call."""
    from test_torch_pairs_kernel import _tie_table

    _cam, pairs, starts, lens = _tie_table(deep)
    cfg = PortConfig(width=32, height=32, tile_h=32, tile_w=32,
                     algorithm="binned", max_depth=7 if deep else 3)
    rng = np.random.default_rng(5)
    d = rng.normal(size=(2, 1024, 3)).astype(np.float32) * 0.2
    d[..., 2] = -1.0  # towards the table's spheres
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dirs = torch.from_numpy(d)
    args = [torch.from_numpy(pairs), torch.tensor([2, 2], dtype=torch.int32),
            torch.tensor([int(lens[0]), 0], dtype=torch.int32)]
    mt, lo, hi, m = port_binned.trace_pairs_pallas(dirs, *args, cfg)
    dirs_k = torch.movedim(dirs, 2, 1).reshape(2, 3, 8, 128).contiguous()
    out, m2 = port_binned.trace_pairs_pallas_soa(dirs_k, *args, cfg)
    assert mt.shape == lo.shape == (2, 1024)
    assert torch.equal(mt, out[:, 0].reshape(2, 1024))
    assert torch.equal(lo, out[:, 1].reshape(2, 1024))
    assert (hi is None) == (not deep)
    if deep:
        assert torch.equal(hi, out[:, 2].reshape(2, 1024))
    assert torch.equal(m, m2)
    assert float((lo[0] >= 1).float().mean()) > 0.05 and not (lo[1] >= 1).any()


def test_whole_table_span_finds_the_full_render_winner():
    """A bundle given the whole table as its span picks, ray for ray,
    what the full-grid kernel picks from the ray's own tile segment
    (a tile's segment holds every candidate that can hit its rays)."""
    from sphereflake_tpu_torch.models import sphereflake as port_model

    cfg = PortConfig(width=64, height=32, max_depth=3, tile_h=32, tile_w=32,
                     algorithm="binned")
    scene = port_scene(default_scene())
    pairs, starts, lens, _ = port_binned.binned_pairs(
        scene, cfg, port_model.root_frame(scene.camera.position),
        port_model.child_templates(scene.fractal),
    )
    cam = port_binned.camera_vector(scene, cfg)
    full, _ = port_binned.trace_pairs_fused_plain(cam, pairs, starts, lens, cfg)
    tid = torch.arange(2, dtype=torch.int32)
    dx, dy, dz = port_binned._tile_raygen(cam, tid, cfg)
    dirs_k = torch.stack([dx, dy, dz], dim=1).reshape(2, 3, 8, 128)
    whole = torch.stack([starts[0], starts[0]]).to(torch.int32)
    length = torch.stack([lens.sum(), lens.sum()]).to(torch.int32)
    out, _ = port_binned.trace_pairs_pallas_soa_plain(
        dirs_k, pairs, whole, length, cfg
    )
    hit = full[:, 1] >= 1
    assert float(hit.float().mean()) > 0.05
    assert torch.equal(out[:, 1] >= 1, hit)
    same_t = out[:, 0][hit] == full[:, 0][hit]
    assert float(same_t.float().mean()) >= 0.999


def _valid_inputs():
    cfg = PortConfig(width=64, height=32, tile_h=32, tile_w=32,
                     algorithm="binned", max_depth=2)
    dirs_k = torch.zeros((3, 3, 8, 128), dtype=torch.float32)
    dirs_k[:, 2] = -1.0
    pairs = torch.zeros((7, 128), dtype=torch.float32)
    starts = torch.zeros(3, dtype=torch.int32)
    lens = torch.zeros(3, dtype=torch.int32)
    return cfg, [dirs_k, pairs, starts, lens]


@pytest.mark.parametrize(
    "index,mutate,error",
    [
        (0, lambda x: x.double(), TypeError),
        (0, lambda x: x.numpy(), TypeError),
        (0, lambda x: x.reshape(3, 3, 1024), ValueError),
        (0, lambda x: torch.zeros((3, 8, 128, 3)).movedim(3, 1), ValueError),
        (1, lambda x: torch.zeros((8, 128)), ValueError),
        (2, lambda x: x.long(), TypeError),
        (2, lambda x: torch.zeros(2, dtype=torch.int32), ValueError),
        (3, lambda x: torch.zeros(4, dtype=torch.int32), ValueError),
    ],
    ids=["dirs-f64", "dirs-numpy", "dirs-rank", "dirs-strided", "pairs-rows",
         "starts-i64", "starts-size", "lens-size"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(index, mutate, error):
    cfg, args = _valid_inputs()
    port_binned.trace_pairs_pallas_soa(*args, cfg)  # the valid call passes
    args[index] = mutate(args[index])
    with pytest.raises(error):
        port_binned.trace_pairs_pallas_soa(*args, cfg)


def test_cpu_tensors_count_no_launch_and_no_bundles_return_empty():
    cfg, args = _valid_inputs()
    before = port_binned.trace_pairs_pallas_soa.launches
    out, metrics = port_binned.trace_pairs_pallas_soa(*args, cfg)
    assert out.shape == (3, 5, 8, 128) and metrics.shape == (3, 1, 4)
    assert (out[:, 0] == 3.0e38).all() and (out[:, 1:] == 0).all()
    empty, empty_m = port_binned.trace_pairs_pallas_soa(
        torch.zeros((0, 3, 8, 128)), args[1],
        torch.zeros(0, dtype=torch.int32), torch.zeros(0, dtype=torch.int32),
        cfg,
    )
    assert empty.shape == (0, 5, 8, 128) and empty_m.shape == (0, 1, 4)
    assert port_binned.trace_pairs_pallas_soa.launches == before
