"""Per-layer metric `mesh_gather_ms.sharded` (ms): the device time of the
mesh's copies from one card to another per frame, summed over the cards,
in the profiled frames of `animate(mesh=...)`: the peer copies of
`sphereflake_tpu_torch/parallel/mesh.py` (each cell's blocks gathered to
the home card, each home tensor sent to the other cells; the traffic
`peer_gb.sharded` counts).

A peer copy is queued by the host and runs later, so the host-clock span
`mesh.gather` holds only its launch: the time is the trace's. The copies'
names and device seconds go to the run's notes (`memcpy_s`). Returns None
for another kind, or where the profile holds no peer copy (one card)."""

KIND = "orbit_mesh"
PEER = "Memcpy PtoP"


def read(ctx):
    prof = ctx["profile"]
    if ctx["kind"] != KIND or prof is None:
        return None
    copies = {n: s for n, s in prof["by_name"].items() if n.startswith("Memcpy")}
    ctx["notes"]["memcpy_s"] = copies
    peer_s = sum(s for n, s in copies.items() if n.startswith(PEER))
    if peer_s <= 0:
        return None
    return peer_s * 1e3 / prof["units"]
