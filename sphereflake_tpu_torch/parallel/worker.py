"""Multi-process worker: a sharded render and a fit step over a global
mesh — the port's copy of the reference's `tools/multihost_worker.py`.

Launched once per process, by `torchrun` or by hand. Each process
contributes its device to the global mesh (row-bands in rank order),
renders its blocks, runs one sharded fit step, and writes its own rows
of min_t plus the (all-reduced) loss and a gradient fingerprint to
`OUTDIR/worker_<rank>.npz`, for the launcher to stitch and to compare
with a single-process render.

    torchrun --nproc-per-node 2 -m sphereflake_tpu_torch.parallel.worker OUT --device cpu
    python -m sphereflake_tpu_torch.parallel.worker OUT --coordinator 127.0.0.1:29500 --nprocs 2 --pid 0 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sphereflake_tpu_torch.parallel.worker")
    p.add_argument("outdir")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    p.add_argument("--nprocs", type=int, default=None)
    p.add_argument("--pid", type=int, default=None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--height-per-device", type=int, default=16)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--tile", default="16x64", metavar="HxW")
    p.add_argument("--algorithm", default="fast")
    p.add_argument("--max-frontier", type=int, default=128)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from sphereflake_tpu_torch.config import RenderConfig, default_scene
    from sphereflake_tpu_torch.ops import binned, pallas_traversal
    from sphereflake_tpu_torch.parallel import (
        fit_step_sharded,
        render_gbuffer_sharded,
    )
    from sphereflake_tpu_torch.parallel.distributed import (
        global_mesh,
        initialize_distributed,
        process_device,
        process_info,
    )
    from sphereflake_tpu_torch.parallel.sharded import _block_cfg

    initialize_distributed(args.coordinator, args.nprocs, args.pid,
                           device=args.device)
    rank, world = process_info()
    if args.nprocs is not None and world != args.nprocs:
        raise RuntimeError(f"process group of {world}, asked for {args.nprocs}")
    dev = process_device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = global_mesh(local_devices=[dev])  # (devices, 1): row-bands
    n_dev = mesh.size
    tile_h, tile_w = (int(v) for v in args.tile.split("x"))
    cfg = RenderConfig(
        width=args.width, height=args.height_per_device * n_dev,
        max_depth=args.depth, tile_h=tile_h, tile_w=tile_w,
        max_frontier=args.max_frontier, algorithm=args.algorithm,
    )
    scene = default_scene(dev)
    launches = lambda: [binned.trace_pairs_fused_soa.launches,
                        binned.trace_pairs_fused_subset.launches,
                        binned.trace_pairs_pallas_soa.launches,
                        pallas_traversal.trace_tiles_pallas_soa.launches]

    t0 = time.perf_counter()
    gb = render_gbuffer_sharded(scene, cfg, mesh)
    render_launches = launches()
    cam = dataclasses.replace(scene.camera, yaw=scene.camera.yaw + 0.01)
    target = render_gbuffer_sharded(
        dataclasses.replace(scene, camera=cam), cfg, mesh
    )
    loss, grads = fit_step_sharded(
        scene, target.position, target.normal, cfg, mesh
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0

    # This process's rows of the stitched min_t.
    bh = _block_cfg(cfg, mesh).height
    rows = {
        f"minrow_{iy * bh}": gb.min_t[iy * bh:(iy + 1) * bh].cpu().numpy()
        for (iy, _ix), _d in mesh.local_cells()
    }
    fingerprint = np.array(
        [float(torch.sum(torch.abs(g))) for g in grads.leaves()]
    )
    np.savez(
        f"{args.outdir}/worker_{rank}.npz",
        loss=np.float32(float(loss)),
        grad_fingerprint=fingerprint,
        overflow=np.int32(int(gb.metrics.overflow)),
        render_launches=np.asarray(render_launches),
        launches=np.asarray(launches()),
        seconds=np.float64(seconds),
        **rows,
    )
    print(f"worker {rank}/{world}: ok, loss={float(loss):.6f}", flush=True)
    if world > 1:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
