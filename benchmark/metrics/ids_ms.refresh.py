"""Per-layer metric `ids_ms.refresh` (ms): the span `tiles_step.ids` (the Sobol
tile ids: the `progressive_tile_ids` call of
`runtime/progressive.py:progressive_tiles_step`), per tile step; the median
over the `tiles_step` units that the program recorded
(`sphereflake_tpu_torch/spans.py`, host clock).

The program's rings also hold set-up's warm-up tile steps and the profiled
ones, a few against the window's many; the median is there because a reader
cannot know the window's bounds. Returns None for another kind, or where the
program records no such span (a program without `spans.py` too)."""


def read(ctx):
    if ctx["kind"] != "refresh":
        return None
    try:
        from sphereflake_tpu_torch import spans
    except ImportError:
        return None
    return spans.median_ms("tiles_step", "tiles_step.ids")
