"""Per-layer metric `post_ms.frame` (ms): CUDA-event span around each `ops.post.postprocess` call,
per frame of the window.

Reads the traced run's context (see `run.py`); returns None where it
finds nothing to read."""

KIND = "orbit"
SPAN = "post"


def read(ctx):
    ms = ctx["spans_ms"].get(SPAN)
    if ctx["kind"] != KIND or ms is None or not ctx["units"]:
        return None
    return ms / ctx["units"]
