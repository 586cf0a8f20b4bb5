"""The port's stage spans (`sphereflake_tpu_torch/spans.py`): units, spans
and counters where the work happens, their place on the profiler's clock,
the switch that turns them off, and the benchmark's readers of them
(`benchmark/metrics/*.py`).

One 64x32 depth-2 frame (two bands of one 16x64 tile row), one tile step
and one fit step are run once for the module; the records are the rings'
newest after each."""

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import pytest
import torch

from sphereflake_tpu_torch import spans
from sphereflake_tpu_torch.config import RenderConfig, default_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(width=64, height=32, max_depth=2, algorithm="binned", tile_h=16,
          tile_w=64, band_tile_rows=1)


@pytest.fixture(scope="module")
def recorded():
    """{unit: its newest record} after one frame of `animate`, one tile
    step and one single-step `fit`."""
    from sphereflake_tpu_torch import fit
    from sphereflake_tpu_torch.render import render_gbuffer
    from sphereflake_tpu_torch.runtime import progressive as pg
    from sphereflake_tpu_torch.runtime.animate import animate

    torch.set_num_threads(1)
    cfg = RenderConfig(**KW)
    scene = default_scene("cpu")
    out = {}
    next(animate(scene, cfg, 4, device="cpu"))
    out["frame"] = spans.records("frame")[-1]
    with torch.no_grad():
        prepared = pg.progressive_prepare_trimmed(scene, cfg, device="cpu")
        state = pg.progressive_tiles_init(cfg, seed=3, device="cpu")
        pg.progressive_tiles_step(state, scene, cfg, tiles_per_step=2,
                                  prepared=prepared)
    out["tiles_step"] = spans.records("tiles_step")[-1]
    with torch.no_grad():
        gb = render_gbuffer(scene, cfg, device="cpu")
    fit.fit(scene, gb.position, gb.normal, cfg, steps=1, device="cpu")
    out["fit"] = spans.records("fit")[-1]
    return out


FRAME_STAGES = {"gbuffer", "gbuffer.expand", "gbuffer.bin", "gbuffer.k1",
                "gbuffer.untile", "post", "animate.to_host",
                "animate.overflow_read"}


def test_frame_spans_sum_over_bands(recorded):
    r = recorded["frame"]
    assert set(r["spans"]) == FRAME_STAGES
    assert r["counts"] == {"frame.renders": 1}
    s = r["spans"]
    inner = sum(s[k] for k in ("gbuffer.expand", "gbuffer.bin", "gbuffer.k1",
                               "gbuffer.untile"))
    assert 0 < inner <= s["gbuffer"]
    top = sum(s[k] for k in ("gbuffer", "post", "animate.to_host",
                             "animate.overflow_read"))
    assert 0 < top <= r["ns"]


def test_tile_step_and_fit_spans(recorded):
    step = recorded["tiles_step"]
    assert set(step["spans"]) == {"tiles_step.ids", "tiles_step.pack",
                                  "tiles_step.k2", "tiles_step.scatter"}
    assert sum(step["spans"].values()) <= step["ns"]
    f = recorded["fit"]
    assert f["counts"] == {"fit.steps": 1}
    # Two bands, a recompute each, inside the backward.
    assert set(f["spans"]) == {"fit.forward", "fit.backward", "gbuffer",
                               "gbuffer.expand", "gbuffer.bin", "gbuffer.k1",
                               "gbuffer.untile", "gbuffer.recompute"}
    assert 0 < f["spans"]["gbuffer.recompute"] <= f["spans"]["fit.backward"]
    assert f["spans"]["gbuffer"] <= f["spans"]["fit.forward"]
    assert f["spans"]["fit.forward"] + f["spans"]["fit.backward"] <= f["ns"]


def test_unit_inside_a_unit():
    with spans.unit("test.outer"):
        for _ in range(2):
            with spans.span("test.a"):
                time.sleep(0.001)
        with spans.unit("test.inner"):
            with spans.span("test.b"):
                pass
            spans.count("test.n", 2)
        spans.count("test.n")
    outer, inner = spans.records("test.outer")[-1], spans.records("test.inner")[-1]
    assert set(outer["spans"]) == {"test.a", "test.inner"}
    assert outer["spans"]["test.a"] >= 2_000_000  # both calls summed
    assert outer["spans"]["test.inner"] == inner["ns"]
    assert outer["counts"] == {"test.n": 1}
    assert set(inner["spans"]) == {"test.b"}
    assert inner["counts"] == {"test.n": 2}
    assert inner["start_ns"] >= outer["start_ns"]
    assert inner["start_ns"] + inner["ns"] <= outer["start_ns"] + outer["ns"]
    # With no unit open, a span and a counter record nothing.
    with spans.span("test.loose"):
        spans.count("test.loose")
    assert "test.loose" not in spans.units()


def test_span_on_another_thread_lands_in_the_open_unit():
    """As the fit's backward does: autograd runs it on a device thread of
    its own while the thread that opened the unit waits."""
    def work():
        with spans.span("test.thread"):
            time.sleep(0.002)

    with spans.unit("test.threaded"):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    r = spans.records("test.threaded")[-1]
    assert set(r["spans"]) == {"test.thread"}
    assert 2_000_000 <= r["spans"]["test.thread"] <= r["ns"]


def test_ring_is_bounded():
    for i in range(spans.RING + 5):
        with spans.unit("test.ring"):
            spans.count("test.i", i)
    recs = spans.records("test.ring")
    assert len(recs) == spans.RING
    assert recs[0]["counts"]["test.i"] == 5 and recs[-1]["counts"]["test.i"] == spans.RING + 4


SWITCHED_OFF = r"""
import torch
from sphereflake_tpu_torch import spans
from sphereflake_tpu_torch.config import RenderConfig, default_scene
from sphereflake_tpu_torch.runtime.animate import animate
torch.set_num_threads(1)
a, b = spans.span("a"), spans.unit("b")
with a, b:
    spans.count("c")
next(animate(default_scene("cpu"), RenderConfig(**%r), 4, device="cpu"))
print(spans.ENABLED, a is b is spans.span("d"), spans.units())
"""


def test_switched_off_records_nothing_and_shares_one_noop():
    env = dict(os.environ, SPHEREFLAKE_TORCH_SPANS="0")
    out = subprocess.run([sys.executable, "-c", SWITCHED_OFF % KW],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == (
        "False True []")


def test_span_is_a_cpu_op_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.unit("test.profiled"):
            with spans.span("test.stage"):
                torch.ones(64).sum()
    rec = spans.records("test.profiled")[-1]
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for name in ("test.profiled", "test.stage"):
        assert events[name].activity_type() == "cpu_op", name
        assert str(events[name].device_type()).endswith("CPU")
    ev = events["test.profiled"]
    assert abs(ev.start_ns() - rec["start_ns"]) < 5_000_000
    assert abs(ev.start_ns() + ev.duration_ns()
               - (rec["start_ns"] + rec["ns"])) < 5_000_000
    assert set(rec["spans"]) == {"test.stage"}


def test_no_range_without_a_profiler(monkeypatch):
    opened = []

    class Range:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(spans, "_Range", Range)
    with spans.unit("test.quiet"):
        with spans.span("test.quiet_stage"):
            pass
    assert opened == []
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("test.loud"):
            pass
    assert opened == ["test.loud"]


def test_private_profiler_calls_are_there():
    """The spans use two private torch calls (checked on 2.11 and 2.13);
    this fails by name if a release drops either."""
    assert callable(torch._C._autograd._profiler_enabled)
    assert torch._C._autograd._profiler_enabled() is False
    rng = torch._C._profiler._RecordFunctionFast("test.pin")
    with rng:
        pass


def _reader(metric):
    path = os.path.join(ROOT, "benchmark", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "reader_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


READERS = [
    ("expand_ms.frame", "orbit", "frame", "gbuffer.expand", None),
    ("bin_ms.frame", "orbit", "frame", "gbuffer.bin", None),
    ("to_host_ms.frame", "orbit", "frame", "animate.to_host", None),
    ("ids_ms.refresh", "refresh", "tiles_step", "tiles_step.ids", None),
    ("pack_ms.refresh", "refresh", "tiles_step", "tiles_step.pack", None),
    ("scatter_ms.refresh", "refresh", "tiles_step", "tiles_step.scatter", None),
    ("backward_ms.fit", "fit", "fit", "fit.backward", "fit.steps"),
    ("recompute_ms.fit", "fit", "fit", "gbuffer.recompute", "fit.steps"),
]


@pytest.mark.parametrize("metric,kind,unit,span,per", READERS)
def test_reader_on_hand_made_records(metric, kind, unit, span, per,
                                     monkeypatch):
    mod = _reader(metric)
    ms = [3.0, 1.0, 40.0, 2.0, 5.0]  # a slow profiled unit among them
    steps = [1, 2, 1, 4, 1]
    recs = [{"start_ns": i, "ns": 10**9, "spans": {span: int(m * 1e6)},
             "counts": {per: n} if per else {}}
            for i, (m, n) in enumerate(zip(ms, steps))]
    # A unit that never reached the stage counts as none of its time.
    recs.append({"start_ns": 9, "ns": 1, "spans": {},
                 "counts": {per: 1} if per else {}})
    if per:  # a call of no steps is left out
        recs.append({"start_ns": 10, "ns": 1, "spans": {span: 7},
                     "counts": {}})
    rings = {unit: tuple(recs)}
    monkeypatch.setattr(spans, "records", lambda name: rings.get(name, ()))
    ctx = dict(kind=kind, units=5, spans_ms={}, profile=None, work=None,
               notes={})
    if per:
        want = statistics.median([m / n for m, n in zip(ms, steps)] + [0.0])
    else:
        want = statistics.median(ms + [0.0])
    assert mod.read(ctx) == pytest.approx(want)
    for other in {"orbit", "refresh", "fit"} - {kind}:
        assert mod.read(dict(ctx, kind=other)) is None
    # The span under another unit, or another span under the unit: none.
    rings = {unit + "_other": tuple(recs)}
    assert mod.read(ctx) is None
    rings = {unit: tuple(dict(r, spans={span + "_other": 1}) for r in recs)}
    assert mod.read(ctx) is None


@pytest.mark.parametrize("metric,kind", [m[:2] for m in READERS])
def test_reader_in_the_benchmark(metric, kind):
    """Each reader is an entry of `BENCHMARK.json`'s per-layer metrics with
    the cells where it finds its span."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next(m for m in bench["per_layer"] if m["name"] == metric)
    cells = {"orbit": ["frame_1080p_d6_orbit", "frame_4k_d8_orbit"],
             "refresh": ["refresh_1080p_d6_1024tiles"], "fit": ["fit_4k_d8"]}
    assert entry["workloads"] == cells[kind]
    assert (entry["unit"], entry["better"], entry["source"]) == (
        "ms", "lower", "program_span")


def test_cli_profile_writes_the_spans(tmp_path, capsys):
    from sphereflake_tpu_torch.cli import main

    prof = tmp_path / "prof"
    rc = main(["--device", "cpu", "--width", "64", "--height", "32",
               "--depth", "2", "--tile", "16x64", "--frames", "2",
               "--profile", str(prof), "--output", str(tmp_path / "p.png")])
    assert rc == 0
    with open(prof / "spans.json") as f:
        recs = json.load(f)
    frames = recs["frame"][-2:]
    assert len(frames) == 2
    assert all(set(r["spans"]) >= {"gbuffer", "gbuffer.expand", "post"}
               for r in frames)
    text = capsys.readouterr().out
    assert "wrote stage spans" in text and "spans:   gbuffer.expand" in text
    with open(prof / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"frame", "gbuffer", "gbuffer.k1", "post"} <= names


@pytest.mark.parametrize("mode,unit,stage,counter", [
    (("--animate", "2"), "frame", "animate.overflow_read", "frame.renders"),
    (("--progressive", "2", "--batch", "1024"), "tiles_step", "tiles_step.k2",
     None),
    (("--fit", "{target}", "--fit-steps", "1"), "fit", "fit.backward",
     "fit.steps"),
])
def test_cli_profile_writes_the_spans_in_every_mode(mode, unit, stage,
                                                     counter, tmp_path,
                                                     capsys):
    """`--profile DIR` writes `DIR/spans.json` and prints the medians after
    the camera path, the frameless refresh and the fit as well."""
    from sphereflake_tpu_torch.cli import main

    common = ["--device", "cpu", "--width", "64", "--height", "32",
              "--depth", "2", "--tile", "16x64"]
    target = tmp_path / "target.npz"
    if "--fit" in mode:
        assert main(common + ["--output", str(tmp_path / "t.png"),
                              "--gbuffer", str(target)]) == 0
    prof = tmp_path / "prof"
    rc = main(common + [a.format(target=target) for a in mode]
              + ["--profile", str(prof), "--output", str(tmp_path / "m.png")])
    assert rc == 0
    with open(prof / "spans.json") as f:
        recs = json.load(f)
    assert stage in recs[unit][-1]["spans"]
    text = capsys.readouterr().out
    assert f"spans:   {stage} " in text and f" {unit} units, median" in text
    if counter:
        assert f"spans:   {counter} " in text
