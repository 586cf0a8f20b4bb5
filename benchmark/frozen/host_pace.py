"""The host's launch pace, frozen.

`launch_us` is copied from the program's `host_pace.py` when the
benchmark was written and frozen here. Every run prints its reading on
an earlier line, beside the clocks and power of each of the cell's
cards, to explain the run-to-run spread of host-bound cells; it is not a
metric.
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


KEYS = ("name", "clocks.sm", "clocks.mem", "power.draw", "power.limit",
        "temperature.gpu")


def card_state(torch, devs):
    """Each card of `devs`, in order: its name, clocks, power and
    temperature as `nvidia-smi` reads them (an empty dict where it cannot).
    One card gives its dict, several a list of them. A card is found by
    its UUID, else by its index."""
    try:
        lines = subprocess.run(
            ["nvidia-smi", f"--query-gpu=uuid,{','.join(KEYS)}",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        lines = []
    rows = [[s.strip() for s in line.split(",")] for line in lines]
    states = []
    for d in devs:
        # nvidia-smi writes "GPU-<uuid>"; its order may not be CUDA's.
        uuid = str(getattr(torch.cuda.get_device_properties(d), "uuid", ""))
        row = next((r for r in rows if uuid and uuid in r[0]), None)
        if row is None and d.index < len(rows):
            row = rows[d.index]
        states.append(dict(zip(KEYS, row[1:])) if row else {})
    return states[0] if len(states) == 1 else states
