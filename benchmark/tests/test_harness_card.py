"""On the card: every cell's command, as the benchmark runs it, prints a
correct result as its last line. Skips without a card."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, card):
    out = subprocess.run([sys.executable, os.path.join(spec.HERE, "run.py"),
                          "--workload", name, "--seed", "3000000019", "--seconds", "2",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=600, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
