"""Per-layer metric `peer_gb.sharded` (GB/frame): the counter `mesh.peer_bytes`
of `sphereflake_tpu_torch/parallel/mesh.py` (the bytes the mesh's collectives
bring to one cell from another: each cell's blocks gathered to the home cell,
each home tensor sent to the other cells), in 1e9 bytes a frame; the median
over the `frame` units that the program recorded
(`sphereflake_tpu_torch/spans.py`) under `animate(mesh=...)`.

Returns None for another kind, or where the program records no such
counter."""


def read(ctx):
    if ctx["kind"] != "orbit_mesh":
        return None
    try:
        from sphereflake_tpu_torch import spans
    except ImportError:
        return None
    counts = sorted(r["counts"]["mesh.peer_bytes"] for r in spans.records("frame")
                    if "mesh.peer_bytes" in r["counts"])
    if not counts:
        return None
    mid = len(counts) // 2
    return (counts[mid] if len(counts) % 2 else (counts[mid - 1] + counts[mid]) / 2) / 1e9
