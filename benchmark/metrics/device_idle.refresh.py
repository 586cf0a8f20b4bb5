"""Per-layer metric `device_idle.refresh` (fraction): one less the device's busy time (the union of its operations)
over the host-clock length of the profiled whole steps.

Reads the traced run's context (see `run.py`); returns None where it
finds nothing to read."""

KIND = "refresh"


def read(ctx):
    prof = ctx["profile"]
    if ctx["kind"] != KIND or prof is None:
        return None
    return 1.0 - prof["busy_s"] / prof["window_s"]
