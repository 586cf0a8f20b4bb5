"""Per-layer metric `k1_roofline` (%): the pair kernel's full-grid mode
(K1, `csrc/pairs_kernel.cu`: its prologue and walk launches) over the
profiled frames, as the share of its roofline bound in its profiled
device time.

The bound counts the work the benchmark's reference derives for the same
poses (its distinct candidate (tile, node) pairs, every tile of the
padded grid) with the frozen arithmetic of `frozen/roofline.py`: never
the program's own pair table. Returns None where it finds nothing to
read."""

from benchmark.frozen import roofline

KERNELS = ("walk_items_kernel", "item_prologue_kernel")


def read(ctx):
    prof, work = ctx["profile"], ctx["work"]
    if ctx["kind"] != "orbit" or prof is None or not work:
        return None
    kernel_s = sum(v for n, v in prof["by_name"].items()
                   if any(k in n for k in KERNELS))
    frames = len(work["pairs"])
    bytes_moved, ops = roofline.full_grid_work(
        sum(work["pairs"]), work["tiles"] * frames, work["deep"],
        calls=work.get("calls", frames))
    bound_s, by = roofline.bound(bytes_moved, ops)
    ctx["notes"]["k1_bound"] = dict(bound_s=bound_s, by=by, kernel_s=kernel_s,
                                    bytes=bytes_moved, operations=ops)
    if kernel_s <= 0:
        return None
    return 100.0 * bound_s / kernel_s
