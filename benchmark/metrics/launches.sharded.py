"""Per-layer metric `launches.sharded` (launches/frame): device operations
in the profile per frame of `animate(mesh=...)`, every card's summed; a
count that repeats exactly whatever the host's pace.

Reads the traced run's context (see `run.py`); returns None where it
finds nothing to read."""

KIND = "orbit_mesh"


def read(ctx):
    prof = ctx["profile"]
    if ctx["kind"] != KIND or prof is None:
        return None
    return prof["ops"] / prof["units"]
