"""Per-layer metric `pack_ms.refresh` (ms): the span `tiles_step.pack` (the camera
pack: the `camera_vector` call of
`runtime/progressive.py:progressive_tiles_step`), per tile step; the median
over the `tiles_step` units that the program recorded
(`sphereflake_tpu_torch/spans.py`, host clock).

The program's rings also hold set-up's warm-up tile steps and the profiled
ones, a few against the window's many; the median is there because a reader
cannot know the window's bounds. Returns None for another kind, or where the
program records no such span (a program without `spans.py` too).

The pack's upload is from pageable memory and waits for the stream's earlier
work, so the span holds the last step's K2 and scatter on the device as well
as the pack: a change that only moves that wait to another sync point lowers
this metric and not the step. A claim on it comes with the `tiles_step`
unit's own median (the records' `ns`)."""


def read(ctx):
    if ctx["kind"] != "refresh":
        return None
    try:
        from sphereflake_tpu_torch import spans
    except ImportError:
        return None
    return spans.median_ms("tiles_step", "tiles_step.pack")
