"""Per-layer metric `to_host_ms.sharded` (ms): the span `animate.to_host`
(the whole image copied from the home card to the host in
`runtime/animate.py:animate`, with its wait for the device), per frame of
`animate(mesh=...)`; the median over the `frame` units that the program
recorded (`sphereflake_tpu_torch/spans.py`, host clock).

The span ends at a host read, so it holds the wait for the home card's
earlier work as well as the copy: a claim on it comes with the `frame`
unit's own median (the records' `ns`). Returns None for another kind, or
where the program records no such span."""


def read(ctx):
    if ctx["kind"] != "orbit_mesh":
        return None
    try:
        from sphereflake_tpu_torch import spans
    except ImportError:
        return None
    return spans.median_ms("frame", "animate.to_host")
