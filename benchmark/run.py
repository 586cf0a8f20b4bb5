"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or `python3 -m benchmark.run ...`) from the root of a checkout, on a
machine with the cards the cell asks for; the run is given `cuda:0` to
`cuda:{chips - 1}`. It loads the cell's files
(`spec.py`), makes the inputs from the seed and warms up (set-up),
measures whole frames or steps for `--seconds`, and then, with the
program's state freed, checks what the window produced against the
plain reference. It prints an earlier line with the host's launch pace,
each card's clocks and power and the cell's counters, the compared numbers
beside their limits as the last lines of standard error, and one JSON
object as the last line of standard output.

`--trace 0` reports the cell's end-to-end metrics; `--trace 1` its
per-layer metrics, from spans around calls into the program's layers
during the window and a profiler session over whole frames or steps
after it. Without a usable card it prints no result and exits 2.

`device.count` is measured, never copied from the cell: the cards on
which the run allocated memory (whose peak rose above what they held
when it began: 0 in a fresh process) and, in a traced run, on which the
profiler saw an operation. A run that used fewer cards than it was given
says so on standard error.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import check, drivers, spec, spans as spans_mod  # noqa: E402
from benchmark.frozen import device_profile, host_pace, loop  # noqa: E402

# Top-level module names that may not be loaded once the window has
# closed: the JAX stack and the JAX package the program was ported from.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "sphereflake_tpu"})


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (the part before the first
    dot), compared whole, is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


def cards_used(rises, ops=None) -> int:
    """The number of cards on which the run allocated memory (`rises`:
    each card's peak bytes above what it held when the run began) and, in
    a traced run (`ops`: each card's device operations in the profile),
    did work."""
    if ops is None:
        ops = [1] * len(rises)
    return sum(1 for r, n in zip(rises, ops) if r > 0 and n > 0)


def run(torch, cell: dict, seed: int, seconds: float, trace: bool, device,
        t0: float = _T0) -> dict:
    """One run of `cell` on `device` (one device, or the cell's list of
    cards, the home card first); returns the result dict (and the earlier
    line's `notes`, the checks' rows) without printing."""
    devs = drivers.devices(torch, device)
    dev = devs[0]
    cuda = dev.type == "cuda"
    notes = {}
    held = [0] * len(devs)
    if cuda:
        notes["launch_us"] = host_pace.launch_us(torch, dev)
        notes["card_before"] = host_pace.card_state(torch, devs)
        for d in devs:
            torch.cuda.reset_peak_memory_stats(d)
        held = [torch.cuda.memory_allocated(d) for d in devs]
    drv = drivers.make(torch, cell, seed, devs)
    drv.setup()
    drv.sync()
    # What set-up made stays: the collector's passes in the window then
    # walk only what the window makes.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0

    spans = spans_mod.Spans(torch, dev)
    if trace:
        for name, target in cell["traffic"].get("spans", {}).items():
            spans.wrap(name, target)
    window_s, times = loop.window(drv.unit, seconds, drv.sync)
    spans.close()
    span_ms = spans.totals_ms()
    attempted = drv.attempted
    e2e = drv.end_to_end(window_s, times)
    if cuda:
        notes["card_after"] = host_pace.card_state(torch, devs)

    prof, profiled = None, None
    if trace:
        prof, profiled = drv.profile(
            int(cell["workload"]["profile_units"]),
            lambda fn, n: _profile(torch, fn, n, devs))
    peaks = [torch.cuda.max_memory_allocated(d) if cuda else 0 for d in devs]

    drv.release()
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = drv.check()
    notes["check_s"] = time.perf_counter() - t_check
    limits = cell["workload"]["limits"]
    correct, rows = check.judge(numbers, limits)
    failed = 0 if correct else 1
    notes.update(drv.notes)

    if trace:
        ctx = dict(kind=cell["traffic"]["kind"], units=len(times),
                   spans_ms=span_ms, profile=prof,
                   work=drv.work(profiled) if prof is not None else None,
                   notes=notes)
        metrics = {}
        for m in cell["per_layer"]:
            value = spec.reader(m["name"], cell["here"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"] if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}

    if cuda:
        ops = None
        if trace:
            ops = [prof["ops_per_device"].get(d.index, 0) if prof else 0
                   for d in devs]
        count = cards_used([p - h for p, h in zip(peaks, held)], ops)
    else:
        # The CPU keeps no allocator statistics; the tests' runs use it.
        count = len(set(devs))
    if count < len(devs):
        print(f"benchmark: cell {cell['name']} used {count} of {len(devs)} cards",
              file=sys.stderr)
    dev_info = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": count,
        "memory_peak_bytes": max(peaks),
        "memory_peak_bytes_per_device": peaks,
    }
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if trace and prof is not None:
        dev_info["busy_s"] = prof["busy_s"]
        dev_info["busy_s_per_device"] = [prof["busy_s_per_device"].get(d.index, 0.0)
                                         for d in devs]
        dev_info["window_s"] = prof["window_s"]
        result["breakdown"] = {
            "device_ops": device_profile.top(prof["by_name"]),
            "idle_gaps": device_profile.top(prof["idle_gaps"]),
        }
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    notes["window_s"] = window_s
    notes["units"] = len(times)
    return dict(result=result, notes=notes, rows=rows)


def _profile(torch, fn, n, devs):
    if devs[0].type != "cuda":
        return None
    return device_profile.profile(torch, fn, n, devs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = spec.benchmark()
    cell = spec.cell(args.workload, bench)
    import torch

    chips = int(cell["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: cell {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    devices = [f"cuda:{i}" for i in range(chips)]
    names = [torch.cuda.get_device_name(d) for d in devices]
    if len(set(names)) > 1:
        print(f"benchmark: cell {args.workload}'s cards are not all of one kind: "
              f"{names}", file=sys.stderr)
        return 2
    # The program's kernel libraries are built into, and served from, a
    # fixed directory inside the checkout.
    os.environ["SPHEREFLAKE_TORCH_BUILD_DIR"] = os.path.join(
        ROOT, "build", "sphereflake_tpu_torch")
    out = run(torch, cell, args.seed, args.seconds, bool(args.trace), devices)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps({"earlier": out["notes"]}), flush=True)
    for name, v, lim in out["rows"]:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
