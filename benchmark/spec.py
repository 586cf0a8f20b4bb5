"""Finding a cell's files by name.

`BENCHMARK.json` names the cells, configurations, traffic mixes and
metrics. Each has files of its own under this folder, which the harness
finds by name alone, so that a later change adds a cell, a configuration,
a traffic mix or a per-layer metric by adding files and entries:

- `configs/<config>.json`: the render settings, the scene and the
  guarantees of one configuration;
- `traffic/<traffic>.json`: the parameters of one traffic mix, read by
  the general driver of its `kind`;
- `kinds/<kind>.py`: the driver of one kind of traffic (what the window
  drives, its end-to-end statistic, its check and its control), the base
  in `drivers.py`;
- `workloads/<cell>.json`: the cell's own settings (the frames or steps
  it profiles and checks) and the limit of every number its check
  compares;
- `metrics/<metric>.py`: the reader of one per-layer metric.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, spec: dict, here: str = HERE) -> dict:
    """Everything one cell needs: its entry in `spec`, its config, traffic
    and workload files, and the metrics it reports (end-to-end, and the
    per-layer ones whose `workloads` name it or, without that key, whose
    `moves` metric it reports)."""
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = entries[name]
    work = load_json(os.path.join(here, "workloads", f"{name}.json"))
    for key in ("config", "traffic"):
        if work.get(key) != w[key]:
            raise ValueError(
                f"workloads/{name}.json names {key} {work.get(key)!r}, "
                f"BENCHMARK.json {w[key]!r}"
            )
    config = load_json(os.path.join(here, "configs", f"{w['config']}.json"))
    traffic = load_json(os.path.join(here, "traffic", f"{w['traffic']}.json"))

    def reports(m):
        return m.get("workloads") is None or name in m["workloads"]

    e2e = [m for m in spec["end_to_end"] if reports(m)]
    names = {m["name"] for m in e2e}
    per_layer = [
        m for m in spec["per_layer"]
        if (name in m["workloads"] if "workloads" in m else m["moves"] in names)
    ]
    return dict(name=name, entry=w, workload=work, config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per_layer, here=here)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(name: str, here: str = HERE):
    """The module `kinds/<name>.py`: its `Driver` class, its `control`
    function and its `TINY` traffic parameters."""
    return _module(os.path.join(here, "kinds", f"{name}.py"),
                   "benchmark_kind_" + name.replace(".", "_").replace("-", "_"))


def reader(metric: str, here: str = HERE):
    """The `read(ctx)` function of `metrics/<metric>.py`."""
    return _module(os.path.join(here, "metrics", f"{metric}.py"),
                   "benchmark_metric_" + metric.replace(".", "_").replace("-", "_")).read
