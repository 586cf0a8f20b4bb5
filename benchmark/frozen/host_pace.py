"""The host's launch pace, frozen.

`launch_us` is copied from the program's `host_pace.py` when the
benchmark was written and frozen here. Every run prints its reading on
an earlier line, beside the card's clocks and power, to explain the
run-to-run spread of host-bound cells; it is not a metric.
"""

from __future__ import annotations

import subprocess
import time


def launch_us(torch, dev, n: int = 2000, repeats: int = 5) -> list:
    """Microseconds a launch of `n` one-element adds, host clock between
    two synchronizes, `repeats` times."""
    x = torch.zeros(1, device=dev)
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            x.add_(1.0)
        torch.cuda.synchronize(dev)
        out.append((time.perf_counter() - t0) / n * 1e6)
    return out


def card_state() -> dict:
    """The card's name, clocks, power and temperature as `nvidia-smi`
    reads them (an empty dict where it cannot)."""
    keys = ("name", "clocks.sm", "clocks.mem", "power.draw", "power.limit",
            "temperature.gpu")
    try:
        line = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(keys)}",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {}
    return dict(zip(keys, (s.strip() for s in line.split(","))))
