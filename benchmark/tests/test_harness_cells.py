"""Each traffic driver, each metric reader and the result's format, at a
tiny size on the CPU."""

import json
import math

import pytest
import torch

from benchmark import run, spec
from benchmark.tests import tiny

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEED = 2**31 + 977  # more than 32 signed bits hold


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(name, tiny_dir):
    cell = tiny.cell(name, tiny_dir)
    out = run.run(torch, cell, SEED, 0.3, False, "cpu")
    res = out["result"]
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert list(res["device"]) == ["platform", "kind", "count", "memory_peak_bytes",
                                   "memory_peak_bytes_per_device"]
    assert res["device"]["count"] == 1
    assert res["device"]["memory_peak_bytes_per_device"] == [res["device"]["memory_peak_bytes"]]
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    want = {m["name"] for m in cell["end_to_end"]}
    assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0
    for name_, row in res["checks"].items():
        assert row["limit"] == cell["workload"]["limits"][name_]
    json.dumps(res)  # one JSON line


def test_same_seed_same_inputs():
    """The seed alone sets the inputs: the start pose of the orbit, the
    static view, the frames sampled for the check."""
    from benchmark import scene as sc

    base = sc.base_scene(spec.load_json(spec.HERE + "/configs/sphereflake_1080p_d6.json"))
    pos = lambda seed: sc.posed(base, sc.seeded_angle(seed))["camera"]["position"].tolist()
    assert pos(SEED) == pos(SEED) != pos(SEED + 1)
    draws = lambda seed: [sc.rng(seed, "sample").random() for _ in range(3)]
    assert draws(SEED) == draws(SEED) != draws(SEED + 1)


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_its_spans(name, tiny_dir):
    cell = tiny.cell(name, tiny_dir)
    out = run.run(torch, cell, SEED, 0.3, True, "cpu")
    res = out["result"]
    assert res["device"]["count"] == 1
    allowed = {m["name"] for m in cell["per_layer"]}
    assert set(res["metrics"]) <= allowed
    spans = cell["traffic"].get("spans", {})
    readers = {"gbuffer": "gbuffer_ms.frame", "post": "post_ms.frame",
               "forward": "forward_ms.fit"}
    for s in spans:
        assert res["metrics"][readers[s]]["value"] > 0
    # Device metrics come from the card's profile only.
    assert not any(k.startswith(("device_idle", "launches", "k1_", "k2_"))
                   for k in res["metrics"])


PROFILE = dict(window_s=0.2, busy_s=0.05, ops=300, units=3,
               by_name={"walk_items_kernel": 0.002, "item_prologue_kernel": 0.0001,
                        "elementwise": 0.0479},
               idle_gaps={"aten::sort": 0.1})


@pytest.mark.parametrize("metric,kind,work,want", [
    ("device_idle.frame", "orbit", None, 0.75),
    ("device_idle.refresh", "refresh", None, 0.75),
    ("launches.frame", "orbit", None, 100.0),
    ("launches.refresh", "refresh", None, 100.0),
    ("device_idle.fit", "fit", None, 0.75),
    ("launches.fit", "fit", None, 100.0),
])
def test_profile_readers(metric, kind, work, want):
    ctx = dict(kind=kind, units=10, spans_ms={}, profile=PROFILE, work=work, notes={})
    assert spec.reader(metric)(ctx) == pytest.approx(want)
    other = "refresh" if kind != "refresh" else "orbit"
    assert spec.reader(metric)(dict(ctx, kind=other)) is None
    assert spec.reader(metric)(dict(ctx, profile=None)) is None


def test_span_readers():
    ctx = dict(kind="orbit", units=4, spans_ms={"gbuffer": 100.0, "post": 60.0},
               profile=None, work=None, notes={})
    assert spec.reader("gbuffer_ms.frame")(ctx) == pytest.approx(25.0)
    assert spec.reader("post_ms.frame")(ctx) == pytest.approx(15.0)
    assert spec.reader("gbuffer_ms.frame")(dict(ctx, kind="refresh")) is None
    fit = dict(ctx, kind="fit", spans_ms={"forward": 600.0})
    assert spec.reader("forward_ms.fit")(fit) == pytest.approx(150.0)
    assert spec.reader("forward_ms.fit")(ctx) is None
