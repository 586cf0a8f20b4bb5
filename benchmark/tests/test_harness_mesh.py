"""The pieces of the kind `orbit_mesh`: the banded reference against the
whole-frame one, the mesh's devices, the kind's readers; and,
on four cards (`cards4`, skips without them), the kind for a few frames on
a mesh of the four, through the per-block path its cell's frames take."""

import json
import math
import os
import shutil

import pytest
import torch

from benchmark import drivers, run, scene as sc, spec
from benchmark.reference import blocked, noise, post, sphereflake as ref
from benchmark.tests import tiny

SEED = 2**31 + 8191
NAME = "frame_16k_d8_sharded_4chips"


@pytest.mark.parametrize("n_devices", [1, 3])
def test_bands_equal_the_whole_frame(n_devices, tiny_dir):
    cell = tiny.cell(NAME, tiny_dir)
    rc = dict(drivers.ref_config(cell["config"]), width=96, height=96)
    s = spec.kind("orbit").reference_orbit(
        sc.posed(sc.base_scene(cell["config"]), 1.1), 0, 240, "cpu")
    tex = torch.from_numpy(noise.ssao_noise_texture(64))
    g = ref.gbuffer(s, rc, "cpu")
    t, nrm = ref.image(rc, g["t"]), ref.image(rc, g["normal"])
    img = post.postprocess(ref.image(rc, g["position"]), nrm, t, s, tex)
    bands = blocked.frame(s, rc, ["cpu"] * n_devices, tex)
    want = [(0, 96)] if n_devices == 1 else [(0, 32), (32, 64), (64, 96)]
    assert [(b.y0, b.y1) for b in bands] == want
    for name, whole in (("t", t), ("normal", nrm), ("image", img)):
        assert torch.equal(torch.cat([getattr(b, name) for b in bands]), whole), name
    got = blocked.numbers(bands, lambda y0, y1, dev: (t[y0:y1], nrm[y0:y1],
                                                      img[y0:y1].numpy()))
    assert got == dict(hit_mismatch=0.0, t_bad=0.0, normal_bad=0.0, image_bad=0.0)
    sky = blocked.numbers(bands, lambda y0, y1, dev: (
        torch.full_like(t[y0:y1], ref.BIG), torch.zeros_like(nrm[y0:y1]),
        torch.zeros_like(img[y0:y1])))
    assert sky["hit_mismatch"] == pytest.approx(float((t < ref.BIG).double().mean()))


def test_mesh_devices():
    md = spec.kind("orbit_mesh").mesh_devices
    cpu = torch.device("cpu")
    assert md(torch, ["cpu"], (2, 2)) == [cpu] * 4
    cards = [f"cuda:{i}" for i in range(5)]
    assert md(torch, cards, (2, 2)) == [torch.device(c) for c in cards[:4]]
    with pytest.raises(ValueError, match="needs 4 distinct cards"):
        md(torch, cards[:3], (2, 2))
    with pytest.raises(ValueError, match="needs 4 distinct cards"):
        md(torch, ["cuda:0"] * 4, (2, 2))


MESH_METRICS = ["mesh_blocks_ms.sharded", "mesh_gather_ms.sharded", "mesh_post_ms.sharded",
                "peer_gb.sharded", "device_idle.sharded", "launches.sharded",
                "to_host_ms.sharded"]

# A profile of 2 frames on two cards, as `frozen/device_profile.summarize`
# gives it.
PROFILE = dict(window_s=4.0, busy_s=1.0, busy_s_per_device={0: 1.5, 1: 0.5}, ops=900,
               ops_per_device={0: 600, 1: 300}, idle_gaps={}, units=2,
               by_name={"Memcpy PtoP (Device -> Device)": 0.25,
                        "Memcpy DtoD (Device -> Device)": 0.125,
                        "Memcpy DtoH (Device -> Pageable)": 1.0, "walk_items_kernel": 0.5})


@pytest.mark.parametrize("metric", MESH_METRICS)
def test_mesh_readers_read_the_mesh_kind_only(metric):
    ctx = dict(kind="orbit", units=3, spans_ms={}, profile=PROFILE, work=None, notes={})
    assert spec.reader(metric)(ctx) is None


@pytest.mark.parametrize("metric, want", [("mesh_gather_ms.sharded", 125.0),
                                          ("device_idle.sharded", 0.75),
                                          ("launches.sharded", 450.0)])
def test_mesh_trace_readers(metric, want):
    """The trace's readers on a synthetic profile: the gathers are the peer
    copies alone (not a copy within a card, nor the image's to the host),
    per frame; without a profile, or without a peer copy, nothing."""
    ctx = dict(kind="orbit_mesh", units=3, spans_ms={}, profile=PROFILE, work=None, notes={})
    assert spec.reader(metric)(ctx) == pytest.approx(want)
    assert spec.reader(metric)(dict(ctx, profile=None)) is None
    if metric == "mesh_gather_ms.sharded":
        assert set(ctx["notes"]["memcpy_s"]) == {n for n in PROFILE["by_name"]
                                                 if n.startswith("Memcpy")}
        one_card = dict(PROFILE, by_name={"walk_items_kernel": 0.5})
        assert spec.reader(metric)(dict(ctx, profile=one_card)) is None


def _per_block_cell(here: str, tiny_dir: str) -> dict:
    """The cell at 256x256 depth 3 in 2-tile-row bands: banded, so its
    frames take the per-block path, as the 16384^2 frames do."""
    shutil.copytree(tiny_dir, here)
    path = os.path.join(here, "configs", "sphereflake_16k_d8.json")
    c = spec.load_json(path)
    c["render"].update(width=256, height=256, max_depth=3, band_tile_rows=2)
    with open(path, "w") as f:
        json.dump(c, f)
    return tiny.cell(NAME, here)


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_kind_on_four_cards(trace, cards4, tiny_dir, tmp_path):
    cell = _per_block_cell(str(tmp_path / "b"), tiny_dir)
    out = run.run(torch, cell, SEED, 2.0, bool(trace), cards4)
    res = out["result"]
    assert res["correct"] is True, res["checks"]
    assert out["notes"]["re_renders"] == 0
    dev = res["device"]
    assert dev["count"] == 4
    assert all(p > 0 for p in dev["memory_peak_bytes_per_device"])
    if trace:
        for m in MESH_METRICS:
            assert math.isfinite(res["metrics"][m]["value"]) and res["metrics"][m]["value"] > 0, m
        assert all(b > 0 for b in dev["busy_s_per_device"])
    else:
        assert set(res["metrics"]) == {"frame_ms", "setup_s"}
    with pytest.raises(ValueError, match="distinct cards"):
        run.run(torch, cell, SEED, 0.5, False, cards4[:2])
