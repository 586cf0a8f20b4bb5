"""Device-side view of a run of whole frames or steps, from `torch.profiler`.

The method is `profile_device` of the program's `chip_smoke.py` (a
profiler session with CPU and CUDA activities around the calls, the
device's operations read back by name), copied when the benchmark was
written and frozen here. Beside its sums it keeps the raw intervals, so
that busy time is the union of the device's operations (not their sum)
and every idle gap can be named by the host operation that was running
in it.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict


def _raw_events(prof):
    """[(name, is_device, start_s, end_s)] of a finished profiler session."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = str(e.device_type()).split(".")[-1].upper() != "CPU"
        start = e.start_ns() * 1e-9
        out.append((e.name(), dev, start, start + e.duration_ns() * 1e-9))
    return out


def union(intervals):
    """Merged [(start, end)] of intervals, in order."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def profile(torch, fn, units: int, dev):
    """Run `fn()` `units` times inside a profiler session; returns a dict:
    `window_s` (host clock of the calls, between two synchronizes),
    `busy_s` (union of the device's operations), `ops` (number of device
    operations), `by_name` ({name: device seconds}), `idle_gaps`
    ({host operation: idle seconds}) and `units`. None where the
    profiler saw no device operation."""
    from torch.profiler import ProfilerActivity, profile as _profile

    torch.cuda.synchronize(dev)
    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(units):
            fn()
        torch.cuda.synchronize(dev)
        window_s = time.perf_counter() - t0
    events = _raw_events(prof)
    device = [(s, e, n) for n, d, s, e in events if d and e > s]
    if not device:
        return None
    by_name = defaultdict(float)
    for s, e, n in device:
        by_name[n] += e - s
    busy = union([(s, e) for s, e, _ in device])
    busy_s = sum(e - s for s, e in busy)
    # Idle gaps between device operations, each named by the innermost
    # host operation running at its middle (latest start among those
    # that contain it).
    host = sorted((s, e, n) for n, d, s, e in events if not d)
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        name = "no host operation"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 400, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        gaps[name] += s1 - e0
    return dict(window_s=window_s, busy_s=busy_s, ops=len(device),
                by_name=dict(by_name), idle_gaps=dict(gaps), units=units)


def top(d: dict, n: int = 10, width: int = 120):
    """[[name, seconds]] of the n largest entries, each name cut to
    `width` characters (a templated kernel's name runs to thousands)."""
    return [[k[:width], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
