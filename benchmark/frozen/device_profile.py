"""Device-side view of a run of whole frames or steps, from `torch.profiler`.

The method is `profile_device` of the program's `chip_smoke.py` (a
profiler session with CPU and CUDA activities around the calls, the
device's operations read back by name), copied when the benchmark was
written and frozen here. Beside its sums it keeps the raw intervals, so
that busy time is the union of the device's operations (not their sum)
and every idle gap can be named by the host operation that was running
in it. The intervals are grouped by the card they ran on: each card's
busy time is the union of its own operations, and `busy_s` the mean over
the cards, so that one card's work never covers another's idle time. One
card is the case of one group.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict


def _raw_events(prof):
    """[(name, card, start_s, end_s)] of a finished profiler session; `card`
    is the device index of a device operation, None for a host one."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = str(e.device_type()).split(".")[-1].upper() != "CPU"
        start = e.start_ns() * 1e-9
        out.append((e.name(), e.device_index() if dev else None, start,
                    start + e.duration_ns() * 1e-9))
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


def profile(torch, fn, units: int, devs):
    """Run `fn()` `units` times inside a profiler session, with every card
    of `devs` synchronized at both ends; returns `summarize` of its
    events, or None where the profiler saw no device operation."""
    from torch.profiler import ProfilerActivity, profile as _profile

    def sync():
        for d in devs:
            torch.cuda.synchronize(d)

    sync()
    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        for _ in range(units):
            fn()
        sync()
        window_s = time.perf_counter() - t0
    return summarize(_raw_events(prof), window_s, units)


def summarize(events, window_s: float, units: int):
    """A dict from `_raw_events`' list: `window_s` (host clock of the
    calls, between two synchronizes), `busy_s` (the mean over the cards
    that ran an operation of the union of each card's operations),
    `busy_s_per_device` ({card: its union}), `ops` (number of device
    operations), `ops_per_device` ({card: its number}), `by_name` ({name:
    device seconds, all cards}), `idle_gaps` ({host operation: idle
    seconds between a card's operations, all cards}) and `units`. None
    where there is no device operation."""
    device = [(s, e, n, c) for n, c, s, e in events if c is not None and e > s]
    if not device:
        return None
    by_name = defaultdict(float)
    cards = defaultdict(list)
    for s, e, n, c in device:
        by_name[n] += e - s
        cards[c].append((s, e))
    host = sorted((s, e, n) for n, c, s, e in events if c is None)
    starts = [h[0] for h in host]
    busy_per = {}
    gaps = defaultdict(float)
    for c, intervals in cards.items():
        busy = union(intervals)
        busy_per[c] = sum(e - s for s, e in busy)
        # Idle gaps between the card's operations, each named by the
        # innermost host operation running at its middle (latest start
        # among those that contain it).
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            mid = 0.5 * (e0 + s1)
            name = "no host operation"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 400, -1), -1):
                if host[j][1] >= mid:
                    name = host[j][2]
                    break
            gaps[name] += s1 - e0
    return dict(window_s=window_s, busy_s=sum(busy_per.values()) / len(busy_per),
                busy_s_per_device=busy_per, ops=len(device),
                ops_per_device={c: len(v) for c, v in cards.items()},
                by_name=dict(by_name), idle_gaps=dict(gaps), units=units)


def top(d: dict, n: int = 10, width: int = 120):
    """[[name, seconds]] of the n largest entries, each name cut to
    `width` characters (a templated kernel's name runs to thousands)."""
    return [[k[:width], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
