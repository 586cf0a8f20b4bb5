"""Per-layer metric `to_host_ms.frame` (ms): the span `animate.to_host` (the image
copy to the host, `image.cpu().numpy()` in `runtime/animate.py:animate`, with
its wait for the device), per frame; the median over the `frame` units that the
program recorded (`sphereflake_tpu_torch/spans.py`, host clock).

The program's rings also hold set-up's warm-up frames and the profiled ones, a
few against the window's many; the median is there because a reader cannot know
the window's bounds. Returns None for another kind, or where the program
records no such span (a program without `spans.py` too).

The span ends at a host read, so it holds the wait for the stream's earlier
work (the frame's last kernels) as well as the copy: a change that only moves
that wait to another sync point lowers this metric and not the frame. A claim
on it comes with the `frame` unit's own median (the records' `ns`)."""


def read(ctx):
    if ctx["kind"] != "orbit":
        return None
    try:
        from sphereflake_tpu_torch import spans
    except ImportError:
        return None
    return spans.median_ms("frame", "animate.to_host")
