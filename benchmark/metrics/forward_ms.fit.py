"""Per-layer metric `forward_ms.fit` (ms): CUDA-event span around each
`fit.gbuffer_loss` call (the step's forward: render and loss), per fit
step of the window; the backward and Adam are the step less this.

Reads the traced run's context (see `run.py`); returns None where it
finds nothing to read."""

KIND = "fit"
SPAN = "forward"


def read(ctx):
    ms = ctx["spans_ms"].get(SPAN)
    if ctx["kind"] != KIND or ms is None or not ctx["units"]:
        return None
    return ms / ctx["units"]
