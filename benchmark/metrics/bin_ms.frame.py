"""Per-layer metric `bin_ms.frame` (ms): the span `gbuffer.bin` (the binning: the
`bin_nodes` call of `ops/binned.py:binned_pairs`), summed over the frame's
bands, per frame; the median over the `frame` units that the program recorded
(`sphereflake_tpu_torch/spans.py`, host clock).

The program's rings also hold set-up's warm-up frames and the profiled ones, a
few against the window's many; the median is there because a reader cannot know
the window's bounds. Returns None for another kind, or where the program
records no such span (a program without `spans.py` too)."""


def read(ctx):
    if ctx["kind"] != "orbit":
        return None
    try:
        from sphereflake_tpu_torch import spans
    except ImportError:
        return None
    return spans.median_ms("frame", "gbuffer.bin")
