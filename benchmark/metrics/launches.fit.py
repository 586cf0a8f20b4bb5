"""Per-layer metric `launches.fit` (launches/step): device operations in the profile per fit step; a count that
repeats exactly whatever the host's pace.

Reads the traced run's context (see `run.py`); returns None where it
finds nothing to read."""

KIND = "fit"


def read(ctx):
    prof = ctx["profile"]
    if ctx["kind"] != KIND or prof is None:
        return None
    return prof["ops"] / prof["units"]
