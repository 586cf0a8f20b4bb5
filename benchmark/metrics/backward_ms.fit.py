"""Per-layer metric `backward_ms.fit` (ms): the span `fit.backward`
(`torch.autograd.grad` in `fit.py:_value_and_grad`: the recompute and the vjp),
divided by the call's counter `fit.steps`, per fit step; the median over the
`fit` units that the program recorded (`sphereflake_tpu_torch/spans.py`, host
clock).

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
    return spans.median_ms("fit", "fit.backward", per="fit.steps")
