"""A run with the timed path broken underneath comes out as not correct:
the harness's look for a card is skipped (the run is driven on the CPU at
a tiny size) and every other part of a run is kept. One test a fault
that the cell can have (its kind's `FAULTS`, `kinds/<kind>.py`)."""

import pytest
import torch

from benchmark import faults, run, spec
from benchmark.tests import tiny

SEED = 4242
CASES = [(w["name"], f) for w in spec.benchmark()["workloads"]
         for f in spec.kind(spec.cell(w["name"], spec.benchmark())["traffic"]["kind"]).FAULTS]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(name, fault, tiny_dir):
    cell = tiny.cell(name, tiny_dir)
    plant = spec.kind(cell["traffic"]["kind"], tiny_dir).FAULTS[fault]
    with faults.planted(plant):
        res = run.run(torch, cell, SEED, 0.3, False, "cpu")["result"]
    assert res["correct"] is False, res["checks"]
