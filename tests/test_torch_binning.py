"""The port's binning front end (`expand_global`, `bin_geometry`,
`_decode_tiles_window`, `_sort_pairs`, `node_rows`, `bin_nodes`) vs the
reference package, stage by stage on IDENTICAL inputs: each stage of
the port is fed the reference's own upstream arrays (camera planes,
node dict, corner basis) as NumPy, so integer tables must come out
bit-exact and floats within the stated tolerance."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphereflake_tpu import camera as ref_camera
from sphereflake_tpu.config import RenderConfig as RefConfig
from sphereflake_tpu.config import default_scene
from sphereflake_tpu.models.sphereflake import child_templates, root_frame
from sphereflake_tpu.ops import binned as ref_binned
from sphereflake_tpu_torch.config import RenderConfig as PortConfig
from sphereflake_tpu_torch.convert import (
    geo_from_numpy,
    nodes_from_numpy,
    tensor_from_numpy,
    to_numpy,
)
from sphereflake_tpu_torch.ops import binned as port_binned

from _torch_helpers import off_center, port_scene, tree_to_numpy


def _interior(scene):
    cam = dataclasses.replace(
        scene.camera, position=jnp.asarray([0.0, 0.2, 1.1], jnp.float32)
    )
    return dataclasses.replace(scene, camera=cam)


# name -> (function posing the scene, RenderConfig kwargs)
CASES = {
    "reference_d3": (lambda s: s, dict(width=256, height=128, max_depth=3)),
    "off_center_d3": (off_center, dict(width=128, height=96, max_depth=3)),
    "interior_d4": (_interior, dict(width=256, height=128, max_depth=4)),
    "padded_d2": (lambda s: s, dict(width=100, height=60, max_depth=2)),
    "deep_rows_d7": (lambda s: s, dict(width=64, height=32, max_depth=7,
                                       global_cap=1 << 12)),
    # 9^4 = 6561 > 5000: emit-time compaction; 5000 > ecap = 4096:
    # parent compaction before level 5.
    "compaction_d5": (lambda s: s, dict(width=128, height=96, max_depth=5,
                                        global_cap=5000)),
    # pair_cap = 2048 < n_pairs = 2568: the pair table overflows (and
    # level 4 is compacted to the 1024-node cap on the way).
    "pair_overflow_d4": (lambda s: s, dict(width=256, height=128,
                                           max_depth=4, global_cap=1024)),
}

_cache = {}


def _case(name):
    """Reference-side arrays of one case, as NumPy (computed once)."""
    if name in _cache:
        return _cache[name]
    build, kw = CASES[name]
    kw = dict(tile_h=32, tile_w=32, algorithm="binned", **kw)
    scene = build(default_scene())
    cfg = RefConfig(**kw)
    root = root_frame(scene.camera.position)
    templates = child_templates(scene.fractal)
    planes = ref_camera.tile_frustum_planes(
        scene.camera, cfg.width, cfg.height,
        cfg.padded_height, cfg.padded_width,
        block_h=cfg.padded_height, block_w=cfg.padded_width,
    )[0]
    nodes, exp_ovf = ref_binned.expand_global(
        root, templates, scene.fractal, cfg, planes
    )
    minv = ref_binned.corner_basis(scene.camera, cfg.width, cfg.height)
    origin, tl, tr, bl = ref_camera.corner_rays(
        scene.camera, cfg.width / cfg.height
    )
    ex, ey = tr - tl, bl - tl
    corners = jnp.stack([
        (tl - origin) + u * ex + v * ey
        for u in (0.0, cfg.padded_width / cfg.width)
        for v in (0.0, cfg.padded_height / cfg.height)
    ])
    geo = ref_binned.bin_geometry(nodes, minv, cfg, corners=corners)
    tile, pair_node = ref_binned._decode_tiles_window(geo, cfg, 0, cfg.pair_cap)
    tile_s, node_s = ref_binned._sort_pairs(
        tile, pair_node, geo["n_nodes"], cfg.tiles_x * cfg.tiles_y
    )
    pairs, starts, lens, (n_pairs, pair_ovf) = ref_binned.bin_nodes(
        nodes, minv, cfg, corners=corners
    )
    out = dict(
        scene=scene, ref_cfg=cfg, cfg=PortConfig(**kw),
        root=np.asarray(root), templates=np.asarray(templates),
        planes=np.asarray(planes), nodes=tree_to_numpy(nodes),
        exp_ovf=int(exp_ovf), minv=np.asarray(minv),
        corners=np.asarray(corners), geo=tree_to_numpy(geo),
        tile=np.asarray(tile), pair_node=np.asarray(pair_node),
        tile_s=np.asarray(tile_s), node_s=np.asarray(node_s),
        rows=np.asarray(ref_binned.node_rows(nodes, cfg)),
        pairs=np.asarray(pairs), starts=np.asarray(starts),
        lens=np.asarray(lens), n_pairs=int(n_pairs), pair_ovf=int(pair_ovf),
    )
    _cache[name] = out
    return out


def _cpu(x):
    return tensor_from_numpy(x, "cpu")


@pytest.mark.parametrize("name", list(CASES))
def test_expand_global(name):
    """Same root/templates/planes in: `live`, `code`, `code_hi` and the
    overflow count exact; centres and radii atol 1e-6 (XLA's CPU code
    contracts some multiply-adds that eager torch does not)."""
    c = _case(name)
    port = port_scene(c["scene"])
    nodes, ovf = port_binned.expand_global(
        _cpu(c["root"]), _cpu(c["templates"]), port.fractal, c["cfg"],
        _cpu(c["planes"]),
    )
    got = to_numpy(nodes)
    want = c["nodes"]
    assert int(ovf) == c["exp_ovf"]
    assert ovf.dtype == torch.int32 and ovf.dim() == 0
    for key in ("live", "code", "code_hi"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got[key].dtype == want[key].dtype
    live = want["live"]
    for key in ("cx", "cy", "cz", "cc", "r2", "rad"):
        np.testing.assert_allclose(
            got[key][live], want[key][live], rtol=1e-6, atol=1e-6,
            err_msg=key,
        )
    if name in ("compaction_d5",):
        assert c["exp_ovf"] > 0  # the case really crosses global_cap


@pytest.mark.parametrize("name", list(CASES))
def test_bin_geometry_exact(name):
    """Reference nodes + corner basis in: every integer field of the
    pair layout bit-exact."""
    c = _case(name)
    geo = port_binned.bin_geometry(
        nodes_from_numpy(c["nodes"], "cpu"), _cpu(c["minv"]), c["cfg"],
        corners=_cpu(c["corners"]),
    )
    got = to_numpy(geo)
    assert got["n_nodes"] == c["geo"]["n_nodes"]
    for key in ("counts", "first", "tx0", "ty0", "bw", "n_pairs",
                "pair_overflow"):
        np.testing.assert_array_equal(got[key], c["geo"][key], err_msg=key)
        assert got[key].dtype == np.int32, key


@pytest.mark.parametrize("name", list(CASES))
def test_decode_and_sort_exact(name):
    """Reference geometry in: the (tile, node) decode of every pair slot
    and its tile-segment sort are bit-exact — valid slots, the sentinel
    tail and the overflow case alike. The decode also composes from
    slot windows."""
    c = _case(name)
    cfg = c["cfg"]
    geo = geo_from_numpy(c["geo"], "cpu")
    tile, node = port_binned._decode_tiles_window(geo, cfg, 0, cfg.pair_cap)
    np.testing.assert_array_equal(tile.numpy(), c["tile"])
    np.testing.assert_array_equal(node.numpy(), c["pair_node"])
    assert tile.dtype == torch.int32 and node.dtype == torch.int32
    w = cfg.pair_cap // 4
    parts = [
        port_binned._decode_tiles_window(geo, cfg, k * w, w) for k in range(4)
    ]
    np.testing.assert_array_equal(
        torch.cat([p[0] for p in parts]).numpy(), c["tile"]
    )
    np.testing.assert_array_equal(
        torch.cat([p[1] for p in parts]).numpy(), c["pair_node"]
    )
    tile_s, node_s = port_binned._sort_pairs(
        tile, node, geo["n_nodes"], cfg.tiles_x * cfg.tiles_y
    )
    np.testing.assert_array_equal(tile_s.numpy(), c["tile_s"])
    np.testing.assert_array_equal(node_s.numpy(), c["node_s"])


def test_sort_pairs_two_key_branch():
    """Grids too large for the packed 31-bit key take the stable
    two-array sort; both packages order pairs identically."""
    rng = np.random.default_rng(0)
    n_nodes, n_tiles = 1 << 20, 1 << 12
    tile = rng.integers(0, n_tiles + 1, 4096).astype(np.int32)
    node = rng.integers(0, n_nodes, 4096).astype(np.int32)
    want = ref_binned._sort_pairs(
        jnp.asarray(tile), jnp.asarray(node), n_nodes, n_tiles
    )
    got = port_binned._sort_pairs(_cpu(tile), _cpu(node), n_nodes, n_tiles)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("name", list(CASES))
def test_bin_nodes_exact(name):
    """Reference nodes in: the fat-row payload, the whole pair table
    (dead tail included), starts, lens, n_pairs and the overflow count
    are bit-exact."""
    c = _case(name)
    cfg = c["cfg"]
    nodes = nodes_from_numpy(c["nodes"], "cpu")
    rows = port_binned.node_rows(nodes, cfg)
    np.testing.assert_array_equal(rows.numpy(), c["rows"])
    assert rows.shape[0] == (8 if cfg.max_depth >= 7 else 7)
    pairs, starts, lens, (n_pairs, ovf) = port_binned.bin_nodes(
        nodes, _cpu(c["minv"]), cfg, corners=_cpu(c["corners"])
    )
    assert pairs.shape == (rows.shape[0], cfg.pair_cap)
    np.testing.assert_array_equal(pairs.numpy(), c["pairs"])
    np.testing.assert_array_equal(starts.numpy(), c["starts"])
    np.testing.assert_array_equal(lens.numpy(), c["lens"])
    assert starts.dtype == torch.int32 and lens.dtype == torch.int32
    assert int(n_pairs) == c["n_pairs"] and int(ovf) == c["pair_ovf"]
    if name == "pair_overflow_d4":
        assert c["pair_ovf"] > 0  # the case really overflows the table


@pytest.mark.parametrize("name", ["reference_d3", "off_center_d3"])
def test_corner_basis_and_camera_vector(name):
    """The closed-form adjugate inverse vs the reference's LU inverse
    (rtol 1e-5 of the largest entry), and the 16-float camera pack
    (atol 2e-6: the trig functions differ by ulps)."""
    c = _case(name)
    port = port_scene(c["scene"])
    cfg = c["cfg"]
    minv = port_binned.corner_basis(port.camera, cfg.width, cfg.height)
    np.testing.assert_allclose(
        minv.numpy(), c["minv"], rtol=0,
        atol=1e-5 * float(np.abs(c["minv"]).max()),
    )
    cam = port_binned.camera_vector(port, cfg)
    want = ref_binned.camera_vector(c["scene"], c["ref_cfg"])
    assert cam.shape == (16,) and cam.dtype == torch.float32
    np.testing.assert_allclose(cam.numpy(), np.asarray(want), rtol=0, atol=2e-6)


def test_binned_pairs_end_to_end_counts():
    """The port's whole front end on its own camera math: pair and
    overflow counts equal the reference's at the reference pose, and
    every tile's segment holds the same set of path codes."""
    c = _case("reference_d3")
    port = port_scene(c["scene"])
    cfg = c["cfg"]
    pairs, starts, lens, (n_pairs, ovf) = port_binned.binned_pairs(
        port, cfg, _cpu(c["root"]), _cpu(c["templates"])
    )
    assert int(ovf) == 0
    # ulp-level camera differences may move a node across a tile
    # boundary: allow 0.5 % of the pair count.
    assert abs(int(n_pairs) - c["n_pairs"]) <= 0.005 * c["n_pairs"]
    same = 0
    for t in range(cfg.tiles_x * cfg.tiles_y):
        got = set(pairs[4, starts[t]: starts[t] + lens[t]].tolist())
        s, n = c["starts"][t], c["lens"][t]
        same += got == set(c["pairs"][4, s: s + n].tolist())
    assert same >= 0.9 * cfg.tiles_x * cfg.tiles_y
