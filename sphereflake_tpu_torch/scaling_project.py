"""Projected multi-device scaling, measured on one card: the counterpart
of the reference's `tools/scaling_project.py`.

    python -m sphereflake_tpu_torch.scaling_project [depth] [1080p|config5]

The forward render is embarrassingly parallel: rays are independent, and
a sharded frame needs no collective but the metrics' reductions. So N
devices cost what each device's block costs alone, and one card can
measure that cost by rendering each block's exact workload in sequence
(the reference's method, `tools/scaling_project.py:1-21`):

- `1080p` (strong scaling): a 1920x1024 frame whole, then in N bands of
  1024 / N rows (N = 2, 4, 8). Band k is the work of device k of a
  (N, 1) mesh, so N devices would take t_banded / N against the ideal
  t_whole / N: projected efficiency = t_whole / t_banded.
- `config5` (weak scaling, BASELINE config 5): the whole 16384^2 frame,
  then one 16384 x 16384/N frame (N = 2, 4, 8), the block each of N
  devices would render: projected efficiency = t_whole / (N t_block).

Each time is `bench.frame_marginal` (the moving camera, every frame
re-binned), the minimum of 2 trials. What the projection cannot see:
anything that overlaps or contends across real devices. The port also
bands a 16384^2 frame on one device (`RenderConfig.effective_band_rows`),
so its config-5 blocks are whole numbers of the whole frame's bands: the
work per band is the same, and what the projection reads beyond
`t_whole / N` is the host's pace over the timed calls. On an H100 it
read 54-132 % over six runs, not monotone in N (root `PERF.md`). Each
measurement also returns its trials' raw times and the caching
allocator's counters over its trials (on the H100 they moved by 0).
Runs on the card.
"""

from __future__ import annotations

import argparse
import sys

import torch

from sphereflake_tpu_torch.bench import N_SMALL, frame_marginal
from sphereflake_tpu_torch.config import (
    RenderConfig,
    default_scene,
    resolve_device,
)

MODES = ("1080p", "config5")
DEVICE_COUNTS = (2, 4, 8)
TRIALS = 2
N_BIG = {"1080p": 22, "config5": 4}  # frames of the long timed call


def _peak_mib(dev):
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 2**20


# The caching allocator's counters that a timed call can move: device
# allocations and frees (`cudaMalloc` / `cudaFree`, each a host sync),
# retries after a failed allocation, and full syncs to free blocks.
ALLOCATOR_COUNTERS = ("num_device_alloc", "num_device_free",
                      "num_alloc_retries", "num_sync_all_streams")


def _allocator(dev):
    """The caching allocator's counters and reserved MiB (None on the
    CPU)."""
    if dev.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(dev)
    out = {k: stats.get(k) for k in ALLOCATOR_COUNTERS}
    out["reserved_mib"] = torch.cuda.memory_reserved(dev) / 2**20
    return out


def configs(mode: str, depth: int = 6, size=None, counts=DEVICE_COUNTS):
    """The mode's frames: (the whole frame, {N: the block or banded frame
    for N devices} for N in `counts`). `size` (width, height) shrinks the
    whole frame (the tests); the blocks follow it."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    width, height = size or (
        (16384, 16384) if mode == "config5" else (1920, 1024)
    )
    base = dict(width=width, max_depth=depth, tile_h=32, tile_w=32,
                algorithm="binned")
    whole = RenderConfig(height=height, **base)
    if mode == "config5":
        blocks = {n: RenderConfig(height=height // n, **base)
                  for n in counts}
    else:
        blocks = {n: RenderConfig(height=height,
                                  band_tile_rows=whole.tiles_y // n, **base)
                  for n in counts}
    return whole, blocks


def project(depth: int = 6, mode: str = "1080p", device="cuda",
            n_small: int = N_SMALL, n_big: int | None = None,
            trials: int = TRIALS) -> dict:
    """Measure `mode` and print the reference's lines. Returns the whole
    frame's ms and, per device count N, the block (or banded) ms and the
    projected efficiency, with each measurement's record (`measure`).
    `n_big` defaults to the reference's count for the mode."""
    whole, blocks = configs(mode, depth)
    dev = resolve_device(device)
    scene = default_scene(dev)
    n_big = n_big or N_BIG[mode]

    def measure(cfg):
        """(seconds a frame, a record of the measurement: its peak MiB,
        each trial's (t(n_small), t(n_big)) in ms, and the allocator's
        counters moved over the trials, past the warm-up calls)."""
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        before = {}
        dt, _, calls = frame_marginal(
            scene, cfg, dev, n_small, n_big, trials, pick=min,
            after_warmup=lambda: before.update(_allocator(dev) or {}),
        )
        after = _allocator(dev)
        moved = None
        if after is not None:
            moved = {k: (after[k] - before[k]
                         if None not in (after[k], before[k]) else None)
                     for k in ALLOCATOR_COUNTERS}
            moved["reserved_mib"] = after["reserved_mib"]
        record = dict(peak_mib=_peak_mib(dev),
                      calls_ms=[(a * 1e3, b * 1e3) for a, b in calls],
                      allocator=moved)
        print(f"  {cfg.width}x{cfg.height}: t({n_small}), t({n_big}) "
              f"{record['calls_ms']} ms; allocator over the trials "
              f"{moved}", file=sys.stderr, flush=True)
        return dt, record

    w, h = whole.width, whole.height
    t_whole, whole_rec = measure(whole)
    if mode == "config5":
        print(f"whole {w}x{h}: {t_whole * 1e3:8.1f} ms "
              f"({w * h / t_whole / 1e6:.0f}M rays/s)", flush=True)
    else:
        print(f"whole-frame {w}x{h}: {t_whole * 1e3:7.2f} ms "
              f"({w * h / t_whole / 1e6:.1f}M rays/s)", flush=True)
    rows = []
    for n, cfg in blocks.items():
        tb, rec = measure(cfg)
        if mode == "config5":
            eff = t_whole / (n * tb)
            print(f"N={n} chips (block {w}x{cfg.height}): per-block "
                  f"{tb * 1e3:8.1f} ms -> projected weak-scaling "
                  f"efficiency {eff * 100:6.1f}%", flush=True)
        else:
            eff = t_whole / tb
            print(f"N={n} blocks (bands of {h // n} rows): sequential "
                  f"{tb * 1e3:7.2f} ms -> projected {n}-chip efficiency "
                  f"{eff * 100:6.1f}%", flush=True)
        rows.append(dict(n=n, ms=tb * 1e3, efficiency=eff, **rec))
    return dict(mode=mode, depth=depth, whole_ms=t_whole * 1e3,
                whole_peak_mib=whole_rec.pop("peak_mib"), whole=whole_rec,
                blocks=rows)


def parse_args(argv) -> tuple[int, str]:
    """(depth, mode) from the reference's argv form `[depth] [mode]`."""
    p = argparse.ArgumentParser(
        prog="python -m sphereflake_tpu_torch.scaling_project",
        description="Projected multi-device scaling from one card",
    )
    p.add_argument("depth", nargs="?", type=int, default=6)
    p.add_argument("mode", nargs="?", choices=MODES, default="1080p")
    a = p.parse_args(argv)
    return a.depth, a.mode


def main(argv=None, *, device="cuda") -> int:
    depth, mode = parse_args(argv)
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev.type} {name} depth={depth} mode={mode}",
          file=sys.stderr)
    project(depth, mode, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
