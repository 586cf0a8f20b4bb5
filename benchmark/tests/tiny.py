"""A copy of the benchmark's files at a size the CPU runs in seconds,
for the harness's tests: every configuration cut to a small frame and
depth, every traffic mix to its kind's `TINY` parameters (a few frames, tiles a step or steps). The program
runs its kernels' plain versions on CPU tensors."""

from __future__ import annotations

import json
import os
import shutil

from benchmark import spec

SMALL = {"width": 128, "height": 64, "max_depth": 3}


def folder(dst: str, small: dict = SMALL) -> str:
    """Copy `BENCHMARK.json` and the benchmark's folders of files into
    `dst`, cut to size; returns `dst`."""
    for sub in ("configs", "traffic", "workloads", "metrics", "kinds"):
        shutil.copytree(os.path.join(spec.HERE, sub), os.path.join(dst, sub))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), dst)
    for name in os.listdir(os.path.join(dst, "configs")):
        path = os.path.join(dst, "configs", name)
        c = spec.load_json(path)
        c["render"].update(small)
        _dump(path, c)
    for name in os.listdir(os.path.join(dst, "traffic")):
        path = os.path.join(dst, "traffic", name)
        t = spec.load_json(path)
        t.update(spec.kind(t["kind"]).TINY)
        _dump(path, t)
    return dst


def _dump(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def cell(name: str, here: str) -> dict:
    return spec.cell(name, spec.load_json(os.path.join(here, "BENCHMARK.json")), here)
