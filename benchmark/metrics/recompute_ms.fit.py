"""Per-layer metric `recompute_ms.fit` (ms): the span `gbuffer.recompute`
(in `ops/binned.py:BinnedGBuffer.backward`, a band at a time: the band's front
rebuilt under grad, which is its raygen, root frame, child templates and level
radii, and the launch of the vjp kernel of `ops/recompute_vjp.py`), divided by
the call's counter `fit.steps`, per fit step; the median over the `fit` units
that the program recorded (`sphereflake_tpu_torch/spans.py`, host clock).

The program's rings also hold set-up's warm-up fit calls and the profiled ones,
a few against the window's many; the median is there because a reader cannot
know the window's bounds. Returns None for another kind, or where the program
records no such span (a program without `spans.py` too)."""


def read(ctx):
    if ctx["kind"] != "fit":
        return None
    try:
        from sphereflake_tpu_torch import spans
    except ImportError:
        return None
    return spans.median_ms("fit", "gbuffer.recompute", per="fit.steps")
