"""Spans around calls into the program's layers, recorded from the
benchmark's side: a module attribute is replaced by a wrapper that
records a CUDA event before and after each call (the host clock on the
CPU, where the tests drive the harness), and put back afterwards.
"""

from __future__ import annotations

import importlib
import time
from collections import defaultdict


class Spans:
    def __init__(self, torch, device):
        self.torch = torch
        self.cuda = torch.device(device).type == "cuda"
        self.records = defaultdict(list)
        self._restore = []

    def _mark(self):
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def wrap(self, name: str, target: str):
        """Record span `name` around every call of `target`
        ("package.module:attribute")."""
        mod_name, attr = target.split(":")
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, attr)
        rec = self.records[name]

        def wrapped(*args, **kwargs):
            start = self._mark()
            out = orig(*args, **kwargs)
            rec.append((start, self._mark()))
            return out

        setattr(mod, attr, wrapped)
        self._restore.append((mod, attr, orig))

    def close(self):
        for mod, attr, orig in reversed(self._restore):
            setattr(mod, attr, orig)
        self._restore.clear()

    def totals_ms(self) -> dict:
        """{span: total milliseconds over every recorded call}."""
        if self.cuda:
            self.torch.cuda.synchronize()
            return {k: sum(s.elapsed_time(e) for s, e in v)
                    for k, v in self.records.items()}
        return {k: sum(e - s for s, e in v) * 1e3
                for k, v in self.records.items()}
