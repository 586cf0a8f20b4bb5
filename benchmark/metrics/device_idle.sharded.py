"""Per-layer metric `device_idle.sharded` (fraction): one less the cards'
mean busy time (each card's the union of its own operations) over the
host-clock length of the profiled whole frames of `animate(mesh=...)`.
Each card's busy time is on the result line (`busy_s_per_device`).

Reads the traced run's context (see `run.py`); returns None where it
finds nothing to read."""

KIND = "orbit_mesh"


def read(ctx):
    prof = ctx["profile"]
    if ctx["kind"] != KIND or prof is None:
        return None
    return 1.0 - prof["busy_s"] / prof["window_s"]
