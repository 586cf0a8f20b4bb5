"""Stage spans: where a unit of the program's work spends its host time.

A **unit** is one unit of user work: a frame of `runtime/animate.py:animate`
(`frame`), a frameless tile step (`tiles_step`), a `fit.fit` call (`fit`).
A **span** is one stage inside it (`gbuffer.expand`, `tiles_step.ids`, ...),
and a **counter** counts something inside it (`frame.renders`, `fit.steps`).
Each closed unit appends one record to a bounded ring of its name:

    {"start_ns": Unix-epoch ns at entry, "ns": host ns it took,
     "spans": {span: host ns, summed over its calls},
     "counts": {counter: total}}

Spans and counters land in the innermost open unit; a unit opened inside
another counts as one span of the outer. The open units are shared by the
whole process, not by a thread: a span opened on autograd's device thread,
while the main thread waits in `torch.autograd.grad`, lands in the unit the
main thread opened. A span or counter with no unit open records nothing.

Durations are `time.perf_counter_ns` differences, on the host's clock: a
stage that ends in a host read (`int(...)`, `.cpu()`) or in an upload from
pageable memory includes the wait for the stream's earlier work. `start_ns`
is placed on the Unix epoch, the clock of the events of `torch.profiler`, by
one offset taken at import. While a profiler is active, and only then, a
span also opens a CPU-scope profiler range of its name (a `cpu_op` event,
which the profiler does not mirror onto the device's timeline), so the trace
names the stage around each host operation.

Recording is on by default and costs two clock reads and a dict update a
span. `SPHEREFLAKE_TORCH_SPANS=0`, read once at import, turns `span`,
`unit` and `count` into one shared no-op.
"""

from __future__ import annotations

import collections
import os
import statistics
import threading
import time

import torch

ENABLED = os.environ.get("SPHEREFLAKE_TORCH_SPANS", "1") != "0"
RING = 4096  # records kept a unit name

# perf_counter_ns() + _EPOCH_NS is the Unix epoch in ns (the profiler's).
_EPOCH_NS = time.time_ns() - time.perf_counter_ns()
_clock = time.perf_counter_ns
# Private to torch (checked on 2.11 and 2.13): `_RecordFunctionFast` opens a
# `cpu_op` range where `torch.profiler.record_function` opens a
# `user_annotation`, which the profiler mirrors onto the device's timeline.
# tests/test_torch_spans.py::test_private_profiler_calls_are_there fails by
# name if a release drops either.
_profiling = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast

_lock = threading.Lock()  # guards the open units and the rings
_open: list = []  # the open units, innermost last
_top = None  # _open[-1], or None
_rings: dict = {}  # unit name -> deque of records


class _Span:
    __slots__ = ("name", "t0", "rng")

    def __init__(self, name: str):
        self.name = name
        self.rng = None

    def __enter__(self):
        if _profiling():
            self.rng = _Range(self.name)
            self.rng.__enter__()
        self.t0 = _clock()
        return self

    def __exit__(self, et, ev, tb):
        ns = _clock() - self.t0
        if self.rng is not None:
            self.rng.__exit__(et, ev, tb)
        u = _top
        if u is not None:
            # No lock: the unit's other thread, if any, waits meanwhile
            # (autograd's device thread runs while the main thread waits
            # in `torch.autograd.grad`).
            u.spans[self.name] = u.spans.get(self.name, 0) + ns
        return False


class _Unit(_Span):
    __slots__ = ("spans", "counts")

    def __enter__(self):
        global _top
        self.spans, self.counts = {}, {}
        with _lock:
            _open.append(self)
            _top = self
        return super().__enter__()

    def __exit__(self, et, ev, tb):
        global _top
        ns = _clock() - self.t0
        if self.rng is not None:
            self.rng.__exit__(et, ev, tb)
        with _lock:
            _open.remove(self)
            _top = _open[-1] if _open else None
            if _top is not None:
                _top.spans[self.name] = _top.spans.get(self.name, 0) + ns
            ring = _rings.get(self.name)
            if ring is None:
                ring = _rings[self.name] = collections.deque(maxlen=RING)
        ring.append({"start_ns": self.t0 + _EPOCH_NS, "ns": ns,
                     "spans": self.spans, "counts": self.counts})
        return False


class _NoOp:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoOp()

if ENABLED:
    def span(name: str):
        """Context manager: the host time of the `with` body, under `name`,
        in the open unit."""
        return _Span(name)

    def unit(name: str):
        """Context manager: one unit of work named `name`; on exit its
        record joins the ring of `name` (see the module's docstring)."""
        return _Unit(name)

    def count(name: str, n: int = 1) -> None:
        """Add `n` to counter `name` in the open unit."""
        u = _top
        if u is not None:
            u.counts[name] = u.counts.get(name, 0) + n
else:
    def span(name: str):
        return _NOOP

    unit = span

    def count(name: str, n: int = 1) -> None:
        return None


def records(name: str) -> tuple:
    """The records of unit `name` still in its ring, oldest first."""
    ring = _rings.get(name)
    return tuple(ring) if ring is not None else ()


def units() -> list:
    """The names of the units that have records."""
    return sorted(_rings)


def median_ms(unit: str, span: str, per: str | None = None):
    """The median over the records of unit `unit` of span `span`'s
    milliseconds a unit or, with `per`, a unit's counter `per` (records
    where it is 0 are left out); None where no record holds the span."""
    recs = records(unit)
    if not any(span in r["spans"] for r in recs):
        return None
    ms = [r["spans"].get(span, 0) * 1e-6 / (r["counts"].get(per, 0) if per
                                            else 1)
          for r in recs if not per or r["counts"].get(per, 0)]
    return statistics.median(ms) if ms else None
