"""Per-layer metric `k2_roofline` (%): the pair kernel's subset mode
(K2, `csrc/pairs_kernel.cu`, shade only: its prologue and walk launches)
over the profiled refresh steps, as the share of its roofline bound in
its profiled device time.

The bound counts the work the benchmark's reference derives for the
tiles those steps traced (its distinct candidate (tile, node) pairs of
the view, with no occlusion trim) with the frozen arithmetic of
`frozen/roofline.py`: never the program's trimmed table. Returns None
where it finds nothing to read."""

from benchmark.frozen import roofline

KERNELS = ("walk_items_kernel", "item_prologue_kernel")


def read(ctx):
    prof, work = ctx["profile"], ctx["work"]
    if ctx["kind"] != "refresh" or prof is None or not work:
        return None
    kernel_s = sum(v for n, v in prof["by_name"].items()
                   if any(k in n for k in KERNELS))
    bytes_moved, ops = roofline.subset_work(
        sum(work["pairs"]), sum(work["ids"]), work["deep"],
        calls=len(work["ids"]))
    bound_s, by = roofline.bound(bytes_moved, ops)
    ctx["notes"]["k2_bound"] = dict(bound_s=bound_s, by=by, kernel_s=kernel_s,
                                    bytes=bytes_moved, operations=ops)
    if kernel_s <= 0:
        return None
    return 100.0 * bound_s / kernel_s
