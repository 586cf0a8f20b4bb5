"""The plain torch version of the per-tile traversal kernel
(`trace_tiles_pallas_soa_plain`, what `trace_tiles_pallas_soa` runs for
CPU tensors) vs the reference package's Pallas kernel in interpret
mode, fed the reference's own directions, planes, root frame and
templates. The CUDA kernel itself is held against the same plain
version on the card by `chip_smoke.py`.

Tolerance. XLA's CPU code contracts multiply-adds, the port rounds every
multiply and add, so a tangent graze (`d2 <= r^2`, where
`d2 = |c|^2 - tca^2` cancels to a few ulps of |c|^2) may flip a hit and
a borderline cull may flip a node:
- 64x32 at depths 0, 1, 2 (the sizes of `tests/test_pallas.py`): codes,
  hit masks and all 8 metrics came out exactly equal; `min_t` within
  rtol = atol = 1e-3 everywhere (t = tca - sqrt(r^2 - d2) amplifies the
  last ulps near tangency);
- 128x96 at depth 4 (level-4 spheres of radius 1/81 seen from 9 units:
  the rounding of d2 is 6 % of r^2), with and without overflow: codes
  equal on >= 99.5 % of the rays, `min_t` within rtol = atol = 1e-4 on
  >= 98 % of the common hits (the reference's own pallas-vs-fast figure
  at this size is 98.6 %); deepest level and overflow equal, queue
  length within 0.1 % — all 8 metrics came out exactly equal here too.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphereflake_tpu import camera as ref_camera
from sphereflake_tpu import render as ref_render
from sphereflake_tpu.config import RenderConfig as RefConfig
from sphereflake_tpu.config import default_scene
from sphereflake_tpu.models.sphereflake import child_templates, root_frame
from sphereflake_tpu.ops import pallas_traversal as ref_pt
from sphereflake_tpu_torch import camera as port_camera
from sphereflake_tpu_torch.config import RenderConfig as PortConfig
from sphereflake_tpu_torch.convert import tensor_from_numpy
from sphereflake_tpu_torch.ops import pallas_traversal as port_pt

from _torch_helpers import port_scene

_BIG = np.float32(3.0e38)
_TILE = dict(tile_h=32, tile_w=32, tile_batch=4, algorithm="pallas")
_CASES = {
    "depth0": dict(width=64, height=32, max_depth=0, max_frontier=128),
    "depth1": dict(width=64, height=32, max_depth=1, max_frontier=128),
    "depth2": dict(width=64, height=32, max_depth=2, max_frontier=128),
    "depth4": dict(width=128, height=96, max_depth=4, max_frontier=1024),
    "overflow": dict(width=128, height=96, max_depth=4, max_frontier=128),
}
_EXACT = ("depth0", "depth1", "depth2")


def _tensors(*arrays):
    return [tensor_from_numpy(np.asarray(x), "cpu") for x in arrays]


def _reference_inputs(scene, cfg):
    """The reference's tile directions [T, 1024, 3], tile planes, root
    frame and templates for `cfg`'s frame."""
    xs, ys = ref_camera.pixel_grid(cfg.padded_width, cfg.padded_height)
    dirs = ref_camera.ray_directions(
        scene.camera, xs, ys, cfg.width, cfg.height
    )
    tiles = ref_render._tile(dirs, cfg)
    planes = ref_camera.tile_frustum_planes(
        scene.camera, cfg.width, cfg.height, cfg.tile_h, cfg.tile_w,
        block_h=cfg.padded_height, block_w=cfg.padded_width,
    )
    return (tiles, planes, root_frame(scene.camera.position),
            child_templates(scene.fractal))


@pytest.fixture(scope="module")
def runs():
    """One interpret-mode run of the reference kernel and one run of
    the port's wrapper per case, shared by the tests of this file."""
    cache = {}

    def get(case):
        if case not in cache:
            kw = dict(_CASES[case], **_TILE)
            scene, ref_cfg = default_scene(), RefConfig(**kw)
            inputs = _reference_inputs(scene, ref_cfg)
            want = ref_pt.trace_tiles_pallas(
                *inputs, scene.fractal, ref_cfg, interpret=True
            )
            got = port_pt.trace_tiles_pallas(
                *_tensors(*inputs), port_scene(scene).fractal,
                PortConfig(**kw),
            )
            cache[case] = (
                [np.asarray(x) for x in want], [x.numpy() for x in got]
            )
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(_CASES))
def test_plain_codes_match_reference_kernel(runs, case):
    (_, code_w, _), (_, code_g, _) = runs(case)
    assert code_g.shape == code_w.shape and code_g.dtype == np.float32
    same = code_g == code_w
    if case in _EXACT:
        assert same.all()
    else:
        assert same.mean() >= 0.995
    assert ((code_g > 0) == (code_w > 0)).mean() >= 0.999
    depth = _CASES[case]["max_depth"]
    hit = code_g[code_g > 0]
    assert hit.size > 100
    assert (hit == np.round(hit)).all() and hit.max() < 2 * 9**depth
    assert hit.min() >= 1.0


@pytest.mark.parametrize("case", list(_CASES))
def test_plain_distances_match_reference_kernel(runs, case):
    (t_w, code_w, _), (t_g, code_g, _) = runs(case)
    both = (code_g > 0) & (code_w > 0)
    if case in _EXACT:
        np.testing.assert_allclose(t_g[both], t_w[both], rtol=1e-3, atol=1e-3)
    close = np.isclose(t_g[both], t_w[both], rtol=1e-4, atol=1e-4)
    assert close.mean() >= (0.995 if case in _EXACT else 0.98)
    # A miss is BIG with code 0, in both packages.
    miss = code_g == 0
    assert (t_g[miss] == _BIG).all() and (t_w[code_w == 0] == _BIG).all()


@pytest.mark.parametrize("case", list(_CASES))
def test_plain_metrics_match_reference_kernel(runs, case):
    (_, _, m_w), (_, _, m_g) = runs(case)
    assert m_g.shape == m_w.shape == (m_w.shape[0], 1, 8)
    assert m_g.dtype == np.int32
    np.testing.assert_array_equal(m_g[:, 0, 1], m_w[:, 0, 1])  # overflow
    np.testing.assert_array_equal(m_g[:, 0, 2], m_w[:, 0, 2])  # deepest level
    qlen_g, qlen_w = m_g[:, 0, 0].sum(), m_w[:, 0, 0].sum()
    assert abs(int(qlen_g) - int(qlen_w)) <= 1e-3 * qlen_w
    assert (m_g[:, 0, 4:] == 0).all()
    # What came out in these five cases: every metric exactly equal.
    np.testing.assert_array_equal(m_g, m_w)
    overflowed = int(m_g[:, 0, 1].sum())
    assert (overflowed > 0) == (case in ("depth4", "overflow"))
    if case == "overflow":
        caps = port_pt.level_caps(PortConfig(**dict(_CASES[case], **_TILE)))
        assert caps == [128] * 5 and m_g[:, 0, 3].max() == 128


def _tie_inputs(swap: bool):
    """One bundle whose rays lie in the plane x = 0 and two level-1
    spheres mirrored in that plane: every ray meets both at exactly the
    same t. Children 0 and 1 are the mirrored pair (swapped with
    `swap`); the other seven sit below the root, out of the rays' way."""
    templates = np.zeros((9, 3, 4), np.float32)
    templates[:, :, :3] = np.eye(3, dtype=np.float32)
    pair = [(0.15, 0.9, 0.0), (-0.15, 0.9, 0.0)]
    templates[0, :, 3], templates[1, :, 3] = pair[::-1] if swap else pair
    for j in range(2, 9):
        templates[j, :, 3] = (0.1 * (j - 5), -0.9, 0.0)
    root = np.zeros((3, 4), np.float32)
    root[:, :3] = np.eye(3, dtype=np.float32)
    root[:, 3] = (0.0, 0.0, -5.0)
    y = np.linspace(1.0, 1.5, 1024, dtype=np.float32)
    d = np.stack([np.zeros_like(y), y, np.full_like(y, -5.0)], axis=-1)
    d = d / np.sqrt((d * d).sum(axis=-1, keepdims=True))
    assert (d[:, 0] == 0).all()
    planes = np.zeros((1, 4, 3), np.float32)  # all-pass
    return d[None].astype(np.float32), planes, root, templates


_TIE_CFG = dict(width=32, height=32, max_depth=1, max_frontier=128, **_TILE)


@pytest.fixture(scope="module")
def tie_runs():
    """The reference kernel (interpret mode) and the port's wrapper on
    `_tie_inputs(swap)`, once per `swap`."""
    cache = {}

    def get(swap):
        if swap not in cache:
            scene = default_scene()
            inputs = _tie_inputs(swap)
            want = ref_pt.trace_tiles_pallas(
                *(jnp.asarray(x) for x in inputs), scene.fractal,
                RefConfig(**_TIE_CFG), interpret=True,
            )
            got = port_pt.trace_tiles_pallas(
                *_tensors(*inputs), port_scene(scene).fractal,
                PortConfig(**_TIE_CFG),
            )
            cache[swap] = (
                [np.asarray(x) for x in want], [x.numpy() for x in got]
            )
        return cache[swap]

    return get


@pytest.mark.parametrize("swap", [False, True], ids=["pair", "swapped"])
def test_first_in_queue_order_wins_an_exact_tie(tie_runs, swap):
    """Child 0 comes before child 1 in the queue (lane j * 128 + p), so
    on an exact tie in t the winner's code is 9 * 1 + 0 whichever of
    the two mirrored spheres child 0 is — in both packages."""
    (t_w, code_w, m_w), (t_g, code_g, m_g) = tie_runs(swap)
    tied = code_g == 9.0
    assert tied.sum() > 100  # rays through the lens both spheres share
    assert not (code_g == 10.0).any() and not (code_w == 10.0).any()
    np.testing.assert_array_equal(code_g, code_w)
    np.testing.assert_array_equal(m_g, m_w)
    # (near the lens' rim t = tca - sqrt(r^2 - d2) amplifies the last ulps)
    np.testing.assert_allclose(t_g[tied], t_w[tied], rtol=1e-4)
    if swap:  # the same rays, the same t: the tie is exact
        np.testing.assert_array_equal(t_g, tie_runs(False)[1][0])


def _split_ray_walk(inputs, cfg, item_nodes):
    """The port's node work on `inputs` (dirs [T, 1024, 3], planes, root,
    templates), then the ray launch's plain pieces: the packed queue
    walked in items of `item_nodes` nodes, merged and finished. Returns
    (t, code) [T, 1024] and the whole walk's (t, code) and metrics."""
    tiles, planes, root, templates = _tensors(*inputs)
    fractal = port_scene(default_scene()).fractal
    level_tab, expand = port_pt._level_tables(templates, fractal, cfg)
    d = torch.movedim(tiles, 2, 1).contiguous()
    queue, metrics = port_pt._expand_bundles(
        planes, root, level_tab, expand, port_pt.level_caps(cfg)
    )
    pool, qlen = port_pt._pack_queue(queue)
    assert torch.equal(qlen, metrics[:, 0].long())
    split = port_pt._walk_queue_split(d, pool, qlen, level_tab, item_nodes)
    return split, port_pt._walk_queue(d, queue, level_tab), metrics


@pytest.mark.parametrize("swap", [False, True], ids=["pair", "swapped"])
@pytest.mark.parametrize("item_nodes", [1, 2])
def test_exact_tie_across_items_matches_reference_kernel(tie_runs, item_nodes,
                                                         swap):
    """The tied children sit at queue positions 1 and 2: in items of 1
    or 2 nodes they fall in different items, and the merge by (t, q)
    still gives the first in queue order — the reference's winner on
    every ray."""
    (_, code_w, _), (t_g, _, _) = tie_runs(swap)
    (t_s, code_s), _, _ = _split_ray_walk(
        _tie_inputs(swap), PortConfig(**_TIE_CFG), item_nodes
    )
    np.testing.assert_array_equal(code_s.numpy().reshape(code_w.shape), code_w)
    assert (code_s == 9.0).sum() > 100
    assert torch.equal(t_s.reshape(t_g.shape).view(torch.int32),
                       torch.from_numpy(t_g).view(torch.int32))


def _straddle_inputs():
    """One all-pass depth-2 bundle (identity rotations) whose nine
    level-1 nodes all survive, so level-2 node (j, p) sits at queue
    position 10 + 9j + p: (5, 8) at 63 and (6, 0) at 64, in two items of
    64. The two are mirrored in the plane x = 0 that holds every ray,
    and every other node lies out of the rays' way: wherever a ray hits
    one it hits the other at exactly the same t."""
    templates = np.zeros((9, 3, 4), np.float32)
    templates[:, :, :3] = np.eye(3, dtype=np.float32)
    for j in range(9):
        templates[j, :, 3] = (0.1 * (j - 5), -0.9, 0.0)
    templates[0, :, 3], templates[8, :, 3] = (0.3, 0.9, 0.0), (-0.3, 0.9, 0.0)
    templates[6, :, 3], templates[5, :, 3] = (-0.8, 0.9, 0.0), (0.8, 0.9, 0.0)
    root = np.zeros((3, 4), np.float32)
    root[:, :3] = np.eye(3, dtype=np.float32)
    root[:, 3] = (0.0, 0.0, -5.0)
    y = np.linspace(1.45, 1.75, 1024, dtype=np.float32)
    d = np.stack([np.zeros_like(y), y, np.full_like(y, -5.0)], axis=-1)
    d = d / np.sqrt((d * d).sum(axis=-1, keepdims=True))
    assert (d[:, 0] == 0).all()
    planes = np.zeros((1, 4, 3), np.float32)  # all-pass
    return d[None].astype(np.float32), planes, root, templates


def test_exact_tie_straddling_an_item_boundary_matches_reference_kernel():
    """The tied nodes at queue positions 63 and 64 fall in two items of
    the kernel's size: the merge by (t, q) gives q = 63, code
    9 * (9 + 8) + 5 = 158, on every tied ray — the reference's winner,
    and the whole walk's, t included."""
    kw = dict(width=32, height=32, max_depth=2, max_frontier=128, **_TILE)
    scene = default_scene()
    inputs = _straddle_inputs()
    _, code_w, m_w = (np.asarray(x) for x in ref_pt.trace_tiles_pallas(
        *(jnp.asarray(x) for x in inputs), scene.fractal, RefConfig(**kw),
        interpret=True,
    ))
    (t_s, code_s), (t_p, code_p), metrics = _split_ray_walk(
        inputs, PortConfig(**kw), port_pt.ITEM_NODES
    )
    np.testing.assert_array_equal(metrics.numpy()[:, None], m_w)
    assert int(metrics[0, 0]) == 1 + 9 + 81
    np.testing.assert_array_equal(code_s.numpy().reshape(code_w.shape), code_w)
    assert int((code_s == 158.0).sum()) > 500
    assert not bool((code_s == 87.0).any())
    assert torch.equal(code_s, code_p)
    assert torch.equal(t_s.view(torch.int32), t_p.view(torch.int32))


def _seeded_bundles(seed, n_bundles, spread, scene, depth):
    """Bundles of 1024 unit rays scattered by `spread` around the
    direction of one seeded node of the tree (the root, or a child of a
    child), with all-pass planes: the expansion keeps every node the
    LOD bound lets through."""
    rng = np.random.default_rng(seed)
    root = np.asarray(root_frame(scene.camera.position))
    templates = np.asarray(child_templates(scene.fractal))
    aim = []
    for b in range(n_bundles):
        c = root[:, 3].copy()
        rot, scale = root[:, :3], 4.0 / 3.0
        for _ in range(min(b, depth)):
            j = rng.integers(0, 9)
            c = c + rot @ templates[j, :, 3] * scale
            rot, scale = rot @ templates[j, :, :3], scale / 3.0
        aim.append(c / np.linalg.norm(c))
    d = np.asarray(aim)[:, None, :] + spread * rng.normal(size=(n_bundles, 1024, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    planes = np.zeros((n_bundles, 4, 3), np.float32)
    return d, planes, root, templates


@pytest.mark.parametrize("item_nodes", [1, 7, 64])
def test_split_ray_walk_equals_whole_walk_on_seeded_queues(item_nodes):
    """The ray launch's pieces — keys of (t, q), a walk over an item,
    the merge by minimum, the finish — give `_trace_bundles_plain`'s
    winner bit for bit, t included, at any item size: on seeded bundles
    aimed at nodes of the tree (queues of 219 nodes, overflowing the
    caps) and on the frame of the depth-4 case (queues of 1 to a few
    hundred nodes)."""
    scene = default_scene()
    seeded = PortConfig(width=64, height=32, max_depth=3, max_frontier=128,
                        **_TILE)
    frame = PortConfig(**dict(_CASES["depth4"], **_TILE))
    for inputs, cfg in (
        (_seeded_bundles(item_nodes, 4, 0.05, scene, 3), seeded),
        (_reference_inputs(scene, RefConfig(**dict(_CASES["depth4"], **_TILE))),
         frame),
    ):
        (t_s, code_s), (t_w, code_w), metrics = _split_ray_walk(
            inputs, cfg, item_nodes
        )
        assert torch.equal(t_s.view(torch.int32), t_w.view(torch.int32))
        assert torch.equal(code_s, code_w)
        hits = code_w[code_w > 0]
        assert hits.numel() > 1000 and hits.unique().numel() > 20
        assert int(metrics[:, 0].max()) > 3 * item_nodes


def test_level_caps_match_reference_over_a_grid_of_configs():
    for depth in range(0, 8):
        for frontier in (1, 64, 128, 200, 729, 1000, 1024, 2048, 5000):
            kw = dict(max_depth=depth, max_frontier=frontier, **_TILE)
            want = ref_pt.level_caps(RefConfig(**kw))
            assert port_pt.level_caps(PortConfig(**kw)) == want
            assert len(want) == depth + 1 and all(c % 128 == 0 for c in want)
    assert port_pt.PALLAS_MAX_DEPTH == ref_pt.PALLAS_MAX_DEPTH == 7
    assert port_pt.TILE_RAYS == ref_pt.TILE_RAYS == 1024


def test_kernel_scratch_sizes():
    """The kernel's scratch follows the configuration alone: a queue
    region per bundle of 5 rows x sum(level caps) and two 9-row panels
    of the widest level per resident node block — one body for every
    frontier, the default's and the CLI ladder's next rung (2048)."""
    cfg = lambda **kw: PortConfig(**dict(_TILE, **kw))
    frame = cfg(max_depth=6)
    assert port_pt.level_caps(frame) == [128, 128, 128, 768, 1024, 1024, 1024]
    assert port_pt.queue_words(frame) == 5 * 4224
    assert port_pt.panel_words(frame) == 18 * 1024
    # A 1080p frame's 2,040 bundles: 172 MB of queues (298 MB at 2048).
    assert 2040 * 4 * port_pt.queue_words(frame) == 172_339_200
    wide = cfg(max_depth=6, max_frontier=2048)
    assert port_pt.level_caps(wide) == [128, 128, 128, 768, 2048, 2048, 2048]
    assert 2040 * 4 * port_pt.queue_words(wide) == 297_676_800
    assert port_pt.panel_words(wide) == 18 * 2048
    assert port_pt.queue_words(cfg(max_depth=0)) == 5 * 128
    assert port_pt.ITEM_NODES == 64
    # The plain queue packs like the kernel's pool: no longer than its
    # region, levels one after the other.
    kw = dict(_CASES["overflow"], **_TILE)
    inputs = _reference_inputs(default_scene(), RefConfig(**kw))
    tiles, planes, root, templates = _tensors(*inputs)
    small = PortConfig(**kw)
    level_tab, expand = port_pt._level_tables(
        templates, port_scene(default_scene()).fractal, small
    )
    queue, metrics = port_pt._expand_bundles(
        planes, root, level_tab, expand, port_pt.level_caps(small)
    )
    pool, qlen = port_pt._pack_queue(queue)
    assert int(qlen.max()) <= port_pt.queue_words(small) // 5
    assert int(metrics[:, 1].sum()) > 0  # overflow: every cap is full
    level = port_pt._code_level(pool[:, 4])
    in_queue = torch.arange(pool.shape[2])[None, :] < qlen[:, None]
    steps = torch.diff(level, dim=1)[in_queue[:, 1:]]
    assert bool((steps >= 0).all()) and bool((steps <= 1).all())


def test_plain_version_takes_any_frontier():
    """What the workspace variant of the kernel is held against on the
    card: the plain version at a frontier past one block's shared
    memory, where the overflow of the default frontier is gone."""
    kw = dict(_CASES["depth4"], **_TILE)
    scene = default_scene()
    inputs = _tensors(*_reference_inputs(scene, RefConfig(**kw)))
    fractal = port_scene(scene).fractal
    small = port_pt.trace_tiles_pallas(*inputs, fractal, PortConfig(**kw))
    wide = port_pt.trace_tiles_pallas(
        *inputs, fractal, PortConfig(**dict(kw, max_frontier=8192))
    )
    assert int(small[2][:, 0, 1].sum()) > 0 == int(wide[2][:, 0, 1].sum())
    assert int(wide[2][:, 0, 0].sum()) > int(small[2][:, 0, 0].sum())
    # More candidates can only bring a ray's hit nearer.
    assert bool((wide[0] <= small[0]).all())


def test_wrapper_contract_on_cpu_tensors():
    scene = port_scene(default_scene())
    kw = dict(width=64, height=32, max_depth=1, max_frontier=128, **_TILE)
    cfg = PortConfig(**kw)
    tiles, planes, root, templates = _tensors(
        *_reference_inputs(default_scene(), RefConfig(**kw))
    )
    dirs_k = torch.movedim(tiles, 2, 1).reshape(-1, 3, 8, 128).contiguous()
    args = (root, templates, scene.fractal)
    before = port_pt.trace_tiles_pallas_soa.launches
    out, m = port_pt.trace_tiles_pallas_soa(dirs_k, planes, *args, cfg)
    assert out.shape == (2, 2, 8, 128) and m.shape == (2, 1, 8)
    # CPU tensors run the plain version: no launch is counted.
    assert port_pt.trace_tiles_pallas_soa.launches == before
    plain = port_pt.trace_tiles_pallas_soa_plain(dirs_k, planes, *args, cfg)
    assert torch.equal(out, plain[0]) and torch.equal(m, plain[1])
    # tile_batch only sizes the plain version's batches.
    one = port_pt.trace_tiles_pallas_soa(
        dirs_k, planes, *args, dataclasses.replace(cfg, tile_batch=1)
    )
    assert torch.equal(out, one[0]) and torch.equal(m, one[1])
    # No bundles: empty outputs.
    out0, m0 = port_pt.trace_tiles_pallas_soa(dirs_k[:0], planes[:0], *args, cfg)
    assert out0.shape == (0, 2, 8, 128) and m0.shape == (0, 1, 8)
    assert m0.dtype == torch.int32
    # What the kernel does not take raises.
    with pytest.raises(ValueError, match="shape"):
        port_pt.trace_tiles_pallas_soa(dirs_k, planes[:1], *args, cfg)
    with pytest.raises(TypeError, match="float32"):
        port_pt.trace_tiles_pallas_soa(dirs_k.double(), planes, *args, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        port_pt.trace_tiles_pallas_soa(
            torch.movedim(tiles, 2, 1).reshape(-1, 3, 128, 8).transpose(2, 3),
            planes, *args, cfg,
        )
    with pytest.raises(AssertionError, match="max_depth <= 7"):
        port_pt.trace_tiles_pallas_soa(
            dirs_k, planes, *args, dataclasses.replace(cfg, max_depth=8)
        )
    with pytest.raises(AssertionError, match="1024-ray tiles"):
        port_pt.trace_tiles_pallas(tiles[:, :512], planes, *args, cfg)


def test_traversal_is_detached_and_gradients_flow_through_the_resolve():
    scene = port_scene(default_scene())
    kw = dict(width=64, height=32, max_depth=1, max_frontier=128, **_TILE)
    cfg = PortConfig(**kw)
    tiles, planes, root, templates = _tensors(
        *_reference_inputs(default_scene(), RefConfig(**kw))
    )
    root = root.clone().requires_grad_(True)
    t, code, _ = port_pt.trace_tiles_pallas(
        tiles, planes, root, templates, scene.fractal, cfg
    )
    assert not t.requires_grad and not code.requires_grad
    min_t, _, hit = port_pt.resolve_codes(
        tiles, code, root, templates, scene.fractal, cfg
    )
    min_t[hit].sum().backward()
    assert root.grad is not None and bool(root.grad.abs().sum() > 0)


def _random_bundles(seed, n_bundles, spread):
    """Unit-ray bundles scattered by `spread` around random axes."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(n_bundles, 1, 3))
    d = axis + spread * rng.normal(size=(n_bundles, 256, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_bundle_frustum_planes_match_reference():
    import jax

    dirs = _random_bundles(0, 6, 0.05)
    want = np.asarray(jax.vmap(ref_camera.bundle_frustum_planes)(
        jnp.asarray(dirs)
    ))
    got = port_camera.bundle_frustum_planes(torch.from_numpy(dirs))
    assert got.shape == (6, 4, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
    # Conservative: every ray of a bundle lies inside its 4 planes.
    inside = np.einsum("bpk,brk->bpr", got.numpy(), dirs)
    assert inside.min() >= -1e-6
    # One bundle [R, 3] gives [4, 3], the reference's own shapes.
    single = port_camera.bundle_frustum_planes(torch.from_numpy(dirs[2]))
    np.testing.assert_array_equal(single.numpy(), got[2].numpy())


def test_bundle_wider_than_a_cone_gets_all_pass_planes():
    import jax

    wide = _random_bundles(1, 3, 5.0)  # rays all over the sphere
    narrow = _random_bundles(2, 1, 0.05)
    dirs = np.concatenate([wide[:1], narrow, wide[1:]])
    want = np.asarray(jax.vmap(ref_camera.bundle_frustum_planes)(
        jnp.asarray(dirs)
    ))
    got = port_camera.bundle_frustum_planes(torch.from_numpy(dirs)).numpy()
    for b in (0, 2, 3):
        assert (got[b] == 0).all() and (want[b] == 0).all()
    assert np.abs(got[1]).max() > 0.5
    np.testing.assert_allclose(got, want, atol=2e-6)
