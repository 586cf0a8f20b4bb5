"""The controls of the correctness check, and the readings its limits are
set from.

A control is the reference put in the program's place and computed in
the nearest precision below the configuration's (float32 -> bfloat16);
it has to come out as not correct. Each traffic kind has its own
(`kinds/<kind>.py:control`).

    python3 benchmark/controls.py --workload <cell> --seeds 1 2 3 ... \
        --control-seeds 4 5 6 --fault-seeds 7 8 9 --seconds 2

runs the cell's window for `--seconds` on each seed in one process and
prints each run's numbers, then the control's numbers on the control
seeds, then each of the kind's planted faults (`faults.py`) on the
fault seeds, one JSON line each (the lower readings and the upper ones
of every limit). Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

from benchmark import spec  # noqa: E402

def control_numbers(torch, cell: dict, seed: int, device) -> dict:
    """The numbers of the cell's control at `seed` (the `control` of its
    traffic kind), compared as the program's output is."""
    return spec.kind(cell["traffic"]["kind"], cell["here"]).control(
        torch, cell, seed, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch

    from benchmark import faults, run

    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 2
    os.environ["SPHEREFLAKE_TORCH_BUILD_DIR"] = os.path.join(
        spec.ROOT, "build", "sphereflake_tpu_torch")
    cell = spec.cell(args.workload, spec.benchmark())
    for seed in args.seeds:
        out = run.run(torch, cell, seed, args.seconds, False, "cuda:0")
        print(json.dumps({"seed": seed, "program": {k: v["value"] for k, v in
                                                    out["result"]["checks"].items()},
                          "metrics": {k: v["value"] for k, v in
                                      out["result"]["metrics"].items()},
                          "notes": out["notes"]}), flush=True)
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        num = control_numbers(torch, cell, seed, "cuda:0")
        print(json.dumps({"seed": seed, "control_bf16": num}), flush=True)
        torch.cuda.empty_cache()
    plants = spec.kind(cell["traffic"]["kind"]).FAULTS
    for name, plant in plants.items():
        for seed in args.fault_seeds:
            with faults.planted(plant):
                out = run.run(torch, cell, seed, args.seconds, False, "cuda:0")
            print(json.dumps({"seed": seed, "fault": name,
                              "program": {k: v["value"] for k, v in
                                          out["result"]["checks"].items()},
                              "correct": out["result"]["correct"]}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
