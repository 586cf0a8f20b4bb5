"""A cell, a configuration, a traffic mix, a kind of traffic and a
per-layer metric added as new files (and entries of `BENCHMARK.json`)
are found by name, with no edit to any file that was there."""

import hashlib
import json
import os

import torch

from benchmark import run
from benchmark.tests import tiny


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_added_files_are_found_without_edits(tiny_dir, tmp_path):
    import shutil

    here = str(tmp_path / "b")
    shutil.copytree(tiny_dir, here)
    before = _digests(here)
    bench_path = os.path.join(here, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)

    # A new configuration: the 1080p one at another start pose.
    with open(os.path.join(here, "configs", "sphereflake_1080p_d6.json")) as f:
        conf = json.load(f)
    conf["scene"]["camera"]["position"] = [-4.0, -6.0, 3.0]
    with open(os.path.join(here, "configs", "sphereflake_other_pose.json"), "w") as f:
        json.dump(conf, f)
    # A new traffic mix of an existing kind: data only.
    with open(os.path.join(here, "traffic", "orbit_3.json"), "w") as f:
        json.dump({"kind": "orbit", "frames_per_revolution": 3, "warmup_frames": 1,
                   "spans": {"gbuffer": "sphereflake_tpu_torch.render:render_gbuffer"}}, f)
    # A new cell.
    with open(os.path.join(here, "workloads", "frame_other_orbit3.json"), "w") as f:
        json.dump({"config": "sphereflake_other_pose", "traffic": "orbit_3",
                   "check_frames": 1, "profile_units": 1,
                   "limits": {"hit_mismatch": 0.05, "t_bad": 0.2,
                              "normal_bad": 0.3, "image_bad": 0.1}}, f)
    # A new per-layer metric reader.
    with open(os.path.join(here, "metrics", "frames_seen.frame.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx['units']) if ctx['kind'] == 'orbit' else None\n")

    bench["configs"].append(dict(bench["configs"][0], name="sphereflake_other_pose",
                                 file="benchmark/configs/sphereflake_other_pose.json"))
    bench["workloads"].append({"name": "frame_other_orbit3", "config": "sphereflake_other_pose",
                               "traffic": "orbit_3", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "frame_ms":
            m["workloads"].append("frame_other_orbit3")
    bench["per_layer"].append({"name": "frames_seen.frame", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "frame", "moves": "frame_ms",
                               "workloads": ["frame_other_orbit3"]})
    with open(bench_path, "w") as f:
        json.dump(bench, f)

    cell = tiny.cell("frame_other_orbit3", here)
    assert cell["traffic"]["frames_per_revolution"] == 3
    out = run.run(torch, cell, 11, 0.3, True, "cpu")["result"]
    assert out["correct"] is True, out["checks"]
    # Only the per-layer metrics whose `workloads` name the new cell.
    assert set(out["metrics"]) == {"frames_seen.frame"}
    assert out["metrics"]["frames_seen.frame"]["value"] >= 1
    plain = run.run(torch, cell, 11, 0.3, False, "cpu")["result"]
    assert set(plain["metrics"]) == {"frame_ms", "setup_s"}

    after = _digests(here)
    changed = {k for k in before if before[k] != after.get(k)}
    assert changed == {"BENCHMARK.json"}


STILL = """
from benchmark import check, drivers, scene as sc

TINY = {}
FAULTS = {}


class Driver(drivers.Driver):
    def setup(self):
        from sphereflake_tpu_torch.render import render_gbuffer

        self.render = render_gbuffer
        self.scene0 = sc.posed(sc.base_scene(self.config), sc.seeded_angle(self.seed))
        self.program_scene = sc.to_program(self.scene0, self.dev)
        self.unit()
        self.attempted = 0

    def unit(self):
        self.gb = self.render(self.program_scene, self.cfg, device=self.dev)
        self.attempted += 1

    def end_to_end(self, window_s, times):
        return {"still_ms": 1e3 * window_s / len(times)}

    def check(self):
        from benchmark.reference import sphereflake as ref

        g = ref.gbuffer(sc.to_reference(self.scene0, self.dev), self.ref_cfg, self.dev)
        return check.gbuffer_numbers(self.gb.min_t, self.gb.normal,
                                     ref.image(self.ref_cfg, g["t"]),
                                     ref.image(self.ref_cfg, g["normal"]))
"""


def test_added_kind_is_found_without_edits(tiny_dir, tmp_path):
    """A new kind of traffic (`kinds/<kind>.py`), its mix and its cell,
    with an end-to-end metric of their own."""
    import shutil

    here = str(tmp_path / "b")
    shutil.copytree(tiny_dir, here)
    before = _digests(here)
    with open(os.path.join(here, "kinds", "still.py"), "w") as f:
        f.write(STILL)
    with open(os.path.join(here, "traffic", "still_frame.json"), "w") as f:
        json.dump({"kind": "still", "spans": {}}, f)
    with open(os.path.join(here, "workloads", "still_1080p.json"), "w") as f:
        json.dump({"config": "sphereflake_1080p_d6", "traffic": "still_frame",
                   "profile_units": 1,
                   "limits": {"hit_mismatch": 0.03, "t_bad": 0.3, "normal_bad": 0.4}}, f)
    bench_path = os.path.join(here, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "still_1080p", "config": "sphereflake_1080p_d6",
                               "traffic": "still_frame", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "still_ms", "unit": "ms", "better": "lower",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["still_1080p"]})
    with open(bench_path, "w") as f:
        json.dump(bench, f)

    cell = tiny.cell("still_1080p", here)
    out = run.run(torch, cell, 12, 0.3, False, "cpu")["result"]
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"still_ms", "setup_s"}
    after = _digests(here)
    changed = {k for k in before if before[k] != after.get(k)}
    assert changed == {"BENCHMARK.json"}
