"""Per-layer metric `mesh_post_ms.sharded` (ms): the span `mesh.post` of
`sphereflake_tpu_torch/parallel/sharded.py` per frame; the median over the
`frame` units that the program recorded (`sphereflake_tpu_torch/spans.py`,
host clock) under `animate(mesh=...)`.

The program's rings also hold set-up's warm-up frames and the profiled ones, a
few against the window's many; the median is there because a reader cannot know
the window's bounds. Returns None for another kind, or where the program
records no such span."""


def read(ctx):
    if ctx["kind"] != "orbit_mesh":
        return None
    try:
        from sphereflake_tpu_torch import spans
    except ImportError:
        return None
    return spans.median_ms("frame", "mesh.post")
