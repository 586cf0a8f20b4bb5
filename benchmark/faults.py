"""Faults planted in the timed path underneath a run, for the check's
tests (`tests/test_harness_faults.py`) and for reading them at a cell's
own size on the card (`controls.py --faults`). Each traffic kind lists
its own in `kinds/<kind>.py:FAULTS` (name -> a function that plants it
through a `Patch`); each must come out as not correct."""

from __future__ import annotations

import contextlib


class Patch:
    """Module attributes replaced, and put back by `undo`."""

    def __init__(self):
        self._undo = []

    def setattr(self, obj, name, value):
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        for obj, name, value in reversed(self._undo):
            setattr(obj, name, value)
        self._undo.clear()


@contextlib.contextmanager
def planted(plant):
    """Run the block with `plant(patch)` in force."""
    p = Patch()
    plant(p)
    try:
        yield
    finally:
        p.undo()
