"""Does the history of a process set the pace of the port's host-bound
loops on the card?

The bench's two rates (`python -m sphereflake_tpu_torch.bench`) are set
by how fast the host issues launches: a 1,024-tile refresh step is ~100
launches, a 1080p frame ~3,000. The same step takes about twice as long
at the end of `chip_smoke.py` as in a fresh process. This tool times, in
one process, the bench's refresh step and moving-camera frame (its own
`refresh_marginal` and `frame_marginal`, the reference's loop counts)
and a loop of 2,000 one-element launches, first fresh and then after
each thing a long process accumulates:

- `fresh`, twice: the baseline and its repeat;
- `held`: 1,800 device tensors of 1 MiB kept alive (the caching
  allocator's block count; `chip_smoke.py` holds ~1.8 GB by then);
- `profiled`: one `torch.profiler` session (CPU and CUDA activities)
  around one frame, as `chip_smoke.py` opens several;
- `gc_frozen`: `gc.collect()` then `gc.freeze()`.

    python -m sphereflake_tpu_torch.host_pace

Prints the card's name and power limit, then one JSON line per stage:
`launch_us` (host clock, five repeats), `step_ms` and `frame_ms` (the
marginal, median, and its trials), and the number of objects the
garbage collector tracks. Needs one card.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
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


def stage(torch, bench, scene, cfg, dev, name: str) -> dict:
    with torch.no_grad():
        step, steps, _calls, _split = bench.refresh_marginal(scene, cfg, dev)
        frame, frames, _calls = bench.frame_marginal(scene, cfg, dev)
    row = dict(stage=name, launch_us=launch_us(torch, dev),
               step_ms=step * 1e3, step_trials_ms=[t * 1e3 for t in steps],
               frame_ms=frame * 1e3,
               frame_trials_ms=[t * 1e3 for t in frames],
               gc_objects=len(gc.get_objects()))
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    import torch

    from sphereflake_tpu_torch import bench
    from sphereflake_tpu_torch.config import default_scene, resolve_device
    from sphereflake_tpu_torch.render import render_gbuffer

    dev = resolve_device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    cfg = bench.bench_config()
    scene = default_scene(dev)
    with torch.no_grad():
        render_gbuffer(scene, cfg, device=dev)  # builds the kernels
    stage(torch, bench, scene, cfg, dev, "fresh")
    stage(torch, bench, scene, cfg, dev, "fresh")

    held = [torch.empty(1 << 18, device=dev) for _ in range(1800)]
    stage(torch, bench, scene, cfg, dev, "held")

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with torch.no_grad():
            render_gbuffer(scene, cfg, device=dev)
        torch.cuda.synchronize(dev)
    stage(torch, bench, scene, cfg, dev, "profiled")

    gc.collect()
    gc.freeze()
    stage(torch, bench, scene, cfg, dev, "gc_frozen")
    del held
    return 0


if __name__ == "__main__":
    sys.exit(main())
