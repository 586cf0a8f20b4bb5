"""The controls come out as not correct: the reference computed in
bfloat16 in the program's place, judged by each cell's own limits. At a
tiny size on the CPU; the readings at the cells' own sizes on the card
are in PERF.md."""

import pytest
import torch

from benchmark import check, controls, spec
from benchmark.tests import tiny

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("seed", [3, 2**31 + 7])
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, seed, tiny_dir):
    cell = tiny.cell(name, tiny_dir)
    numbers = controls.control_numbers(torch, cell, seed, "cpu")
    correct, rows = check.judge(numbers, cell["workload"]["limits"])
    assert not correct, rows
