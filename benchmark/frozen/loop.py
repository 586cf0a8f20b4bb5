"""The measurement loop, frozen.

The method of the program's `bench.py` (`frame_marginal`,
`refresh_marginal`: a loop of whole frames or steps between two
synchronizes, timed by the host clock), copied when the benchmark was
written and frozen here. Its statistic is not copied: the benchmark
takes no marginal t(22) - t(2) and no median of trials, but all the work
of the whole window over all its time, and the tail of every unit in it.
"""

from __future__ import annotations

import time


def window(unit, seconds: float, sync):
    """Run `unit()` whole, again and again, until `seconds` have passed
    since the first began; the window closes with `sync()` after the last.
    Returns (window seconds, [seconds of each unit by the host clock])."""
    sync()
    t0 = time.perf_counter()
    marks = [t0]
    while marks[-1] - t0 < seconds:
        unit()
        marks.append(time.perf_counter())
    sync()
    end = time.perf_counter()
    marks[-1] = max(marks[-1], end)
    return end - t0, [b - a for a, b in zip(marks, marks[1:])]
