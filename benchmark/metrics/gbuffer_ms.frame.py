"""Per-layer metric `gbuffer_ms.frame` (ms): CUDA-event span around each `render.render_gbuffer` call,
per frame of the window.

Reads the traced run's context (see `run.py`); returns None where it
finds nothing to read."""

KIND = "orbit"
SPAN = "gbuffer"


def read(ctx):
    ms = ctx["spans_ms"].get(SPAN)
    if ctx["kind"] != KIND or ms is None or not ctx["units"]:
        return None
    return ms / ctx["units"]
