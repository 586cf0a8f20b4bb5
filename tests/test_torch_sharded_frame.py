"""The frame of the benchmark cell `frame_16k_d8_sharded_4chips`
(BASELINE config 5: a 16384x16384 depth-8 camera path on a 2x2 mesh of
four cards) at a small size on a mesh of `[cpu] * 4`, through the
per-block path its banded frames take:

- `render_frame_sharded` against the benchmark's float64 reference
  (`benchmark/reference/`), G-buffer and image, within the cell's limits;
- `animate(mesh=...)` records the mesh's spans and counters in its
  `frame` unit (and a one-device frame none of them), with the bytes the
  mesh moves reckoned from the planes' shapes;
- the sharded G-buffer equals the one-device `render_gbuffer` bit for
  bit;
- a block's bands expanded and binned at once (`band_fronts`, as every
  binned frame makes them) equal each band's own one-band front bit for
  bit.
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import check, scene as sc
from benchmark.reference import noise as ref_noise
from benchmark.reference import post as ref_post
from benchmark.reference import sphereflake as ref
from sphereflake_tpu_torch import spans
from sphereflake_tpu_torch.config import RenderConfig
from sphereflake_tpu_torch.models.sphereflake import child_templates, root_frame
from sphereflake_tpu_torch.ops.binned import (
    band_fronts,
    binned_pairs,
    camera_vector,
)
from sphereflake_tpu_torch.parallel import (
    make_mesh,
    render_frame_sharded,
    shared_bin_supported,
)
from sphereflake_tpu_torch.render import band_layout, render_gbuffer
from sphereflake_tpu_torch.runtime.animate import animate

import _torch_helpers  # noqa: F401  (one intra-op thread per worker)

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "benchmark")
CONFIG = json.load(open(os.path.join(BENCH, "configs", "sphereflake_16k_d8.json")))
LIMITS = json.load(open(os.path.join(
    BENCH, "workloads", "frame_16k_d8_sharded_4chips.json")))["limits"]
# The cell's render settings at 128x128 depth 3, in 1-tile-row bands: the
# frame is banded, as the 16384^2 one is, so it takes the per-block path.
SMALL = dict(CONFIG["render"], width=128, height=128, max_depth=3,
             band_tile_rows=1)
H = W = 128
SCENE0 = sc.posed(sc.base_scene(CONFIG), 0.7)


def _mesh():
    return make_mesh(["cpu"] * 4, shape=tuple(CONFIG["mesh"]["shape"]))


@pytest.fixture(scope="module")
def frame():
    cfg = RenderConfig(**SMALL)
    assert not shared_bin_supported(cfg, _mesh())
    with torch.no_grad():
        image, gb = render_frame_sharded(sc.to_program(SCENE0, "cpu"), cfg,
                                         _mesh())
    return cfg, image, gb


def test_sharded_frame_against_the_reference(frame):
    cfg, image, gb = frame
    assert int(gb.metrics.overflow) == 0
    rc = {k: SMALL[k] for k in ("width", "height", "max_depth", "lod_factor",
                                "tile_h", "tile_w")}
    s = sc.to_reference(SCENE0, "cpu")
    g = ref.gbuffer(s, rc, "cpu")
    t = ref.image(rc, g["t"])
    assert 0.05 < float((t < ref.BIG).double().mean()) < 0.95
    num = check.gbuffer_numbers(gb.min_t, gb.normal, t, ref.image(rc, g["normal"]))
    tex = torch.from_numpy(ref_noise.ssao_noise_texture(64))
    r_img = ref_post.postprocess(ref.image(rc, g["position"]),
                                 ref.image(rc, g["normal"]), t, s, tex)
    num.update(check.image_numbers(image, r_img))
    ok, rows = check.judge(num, LIMITS)
    assert ok, rows


def _nbytes(*shape, size=4):
    return int(np.prod(shape)) * size


def test_animate_on_the_mesh_records_the_mesh_spans():
    cfg = RenderConfig(**SMALL)
    scene = sc.to_program(SCENE0, "cpu")
    with torch.no_grad():
        list(animate(scene, cfg, 1, mesh=_mesh()))
    rec = spans.records("frame")[-1]
    for name in ("mesh.blocks", "mesh.gather", "mesh.post", "gbuffer.k1",
                 "animate.to_host"):
        assert rec["spans"].get(name, 0) > 0, name
    assert rec["counts"]["mesh.cells"] == 4
    # What reaches a cell from another on a 2x2 mesh of 64x64 blocks: the
    # three far cells' blocks gathered home (position, normal, min_t,
    # float32; hit, bool) and their metrics (3 int32 each); the scene (60
    # float32 leaves) sent to them twice; the post's planes (position,
    # normal), noise (64x64x4), closest distance, and the AO target after
    # each pass sent to them; their SSAO and blurred AO blocks and image
    # blocks gathered home.
    far = 3
    scene_b = _nbytes(60)
    gbuffer = far * (2 * _nbytes(64, 64, 3) + _nbytes(64, 64)
                     + _nbytes(64, 64, size=1) + 3 * 4 + scene_b)
    post = far * (scene_b + 2 * _nbytes(H, W, 3) + _nbytes(64, 64, 4) + 4
                  + 2 * _nbytes(H, W) + 2 * _nbytes(64, 64)
                  + _nbytes(64, 64, 3))
    assert sum(x.numel() for x in scene.leaves()) == 60
    assert rec["counts"]["mesh.peer_bytes"] == gbuffer + post
    # None of it on a one-device frame.
    with torch.no_grad():
        list(animate(scene, cfg, 1, device="cpu"))
    one = spans.records("frame")[-1]
    assert not [k for k in [*one["spans"], *one["counts"]] if k.startswith("mesh.")]
    assert one["spans"]["gbuffer.k1"] > 0


def test_sharded_gbuffer_against_one_device(frame):
    cfg, _image, gb = frame
    with torch.no_grad():
        one = render_gbuffer(sc.to_program(SCENE0, "cpu"), cfg, device="cpu")
    # Bit for bit. `nodes_visited` is not compared: it counts the pair
    # table's entries walked, and each block bins against its own frustum,
    # so the tables differ while every ray's winner does not.
    for k in ("min_t", "position", "normal", "hit"):
        assert torch.equal(getattr(gb, k), getattr(one, k)), k
    for k in ("max_depth_reached", "overflow", "closest_distance"):
        assert torch.equal(getattr(gb.metrics, k), getattr(one.metrics, k)), k


def _bits(x):
    return x.view(torch.int32) if x.is_floating_point() else x


@pytest.mark.parametrize("kw", [
    # 6561 > ecap = 4096 live parents before level 5: both compactions
    dict(max_depth=5, global_cap=5000),
    # the hi code lane, both compactions
    dict(max_depth=7, global_cap=4096),
], ids=["compaction_d5", "deep_d7"])
def test_band_fronts_equal_each_bands_own(kw):
    # The lower right 128x128 block of a 256x256 frame, in four bands.
    cfg = RenderConfig(**dict(SMALL, **kw))
    frame = (256, 256, 128.0, 128.0)
    band_cfg, offsets = band_layout(cfg, frame)
    assert len(offsets) == 4
    scene = sc.to_program(SCENE0, "cpu")
    root = root_frame(scene.camera.position)
    templates = child_templates(scene.fractal)
    fronts = band_fronts(scene, band_cfg, *frame[:3], offsets)
    n_pairs = []
    for y, (pairs, starts, lens, (n, ovf), cam) in zip(offsets, fronts):
        f = (*frame[:3], y)
        w_pairs, w_starts, w_lens, (w_n, w_ovf) = binned_pairs(
            scene, band_cfg, root, templates, frame=f)
        for got, want in ((pairs, w_pairs), (starts, w_starts),
                          (lens, w_lens), (n, w_n), (ovf, w_ovf),
                          (cam, camera_vector(scene, band_cfg, frame=f))):
            assert got.shape == want.shape and got.dtype == want.dtype
            assert torch.equal(_bits(got), _bits(want)), y
        n_pairs.append((int(n), int(ovf)))
    assert len(set(n_pairs)) > 1  # the bands differ
    assert max(o for _n, o in n_pairs) > 0  # and the compactions drop nodes
