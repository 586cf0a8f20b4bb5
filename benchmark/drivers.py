"""The base of the traffic drivers.

A traffic file (`traffic/<mix>.json`) names its `kind`; the driver of a
kind is the `Driver` class of `kinds/<kind>.py`, found by that name
(`spec.kind`), so a new kind of traffic is a new file. A driver's
`setup` makes the inputs from the seed and warms up (set-up time),
`unit` is one frame or step of the window, `end_to_end` takes the
kind's end-to-end metrics from the window, `release` frees the
program's state that the check does not read, `check` compares what the
timed path produced with the reference, `profile` runs whole units
under the profiler after the window, and `work` counts, for the traced
run, the kernels' work on the reference's own candidate pairs.

A driver is given the cell's cards (`devs`, one for each of its
`chips`); `dev`, the first, is the home card, where a kind that runs on
one card does all its work.
"""

from __future__ import annotations

from benchmark import spec


def ref_config(config: dict) -> dict:
    """The reference's render settings of a configuration."""
    r = config["render"]
    return {k: r[k] for k in ("width", "height", "max_depth", "lod_factor",
                              "tile_h", "tile_w")}


def devices(torch, device) -> list:
    """`device` (one device, or a list of them) as a list of
    `torch.device`."""
    if isinstance(device, (list, tuple)):
        return [torch.device(d) for d in device]
    return [torch.device(device)]


def program_config(config: dict):
    from sphereflake_tpu_torch.config import RenderConfig

    return RenderConfig(**config["render"])


class Driver:
    def __init__(self, torch, cell: dict, seed: int, device):
        self.torch = torch
        self.seed = int(seed)
        self.devs = devices(torch, device)
        self.dev = self.devs[0]
        self.traffic = cell["traffic"]
        self.work_spec = cell["workload"]
        self.config = cell["config"]
        self.cfg = program_config(self.config)
        self.ref_cfg = ref_config(self.config)
        self.attempted = 0
        self.notes = {}

    def sync(self):
        """Wait for every card of the cell."""
        for d in self.devs:
            if d.type == "cuda":
                self.torch.cuda.synchronize(d)

    def release(self):
        """Free the program's state that the check does not read."""

    def profile(self, n, profile_fn):
        """(profile of n units run through `profile_fn`, what `work`
        needs of them); the units are not counted as the window's."""
        return profile_fn(self.unit, n), None

    def work(self, profiled):
        return None


def make(torch, cell: dict, seed: int, device) -> Driver:
    return spec.kind(cell["traffic"]["kind"], cell["here"]).Driver(
        torch, cell, seed, device)
