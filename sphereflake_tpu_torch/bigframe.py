"""Large frames on one card, up to the reference's documented maximum of
16384x16384: the counterpart of the reference's `tools/bigframe.py`.

    python -m sphereflake_tpu_torch.bigframe [dN] [sizes...]

Sizes default to 4096 8192 16384, the depth to 6 (`d8` sets 8). Below
16384 a size renders through the banded `render_gbuffer` (the full
G-buffer in device memory). 16384^2 (268M rays; its position and normal
planes alone would take 6.4 GB, its kernel rows 7.5 GB) runs
`lean_bands`: the same bands (`render.band_layout`), each reduced to
`min_t`, the hit mask and an 8x downsampled normal preview before the
next band runs. Its preview is
written as a PNG to the temporary directory (`bigframe_16384.png`).

Per size it prints the reference's line (wall time of the first call,
bands, hits, closest distance, overflow, a rays/s lower bound), then
the time of a second, warm call (CUDA events) and the peak device
memory. Runs on the card; `lean_bands` also runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch

from sphereflake_tpu_torch.config import (
    RenderConfig,
    default_scene,
    resolve_device,
)
from sphereflake_tpu_torch.render import _BIG, band_layout, render_gbuffer
from sphereflake_tpu_torch.utils.image import write_png

DS = 8  # preview downsample
SIZES = (4096, 8192, 16384)
LEAN_FROM = 16384  # sizes from here on run `lean_bands`


def big_config(size: int, depth: int = 6) -> RenderConfig:
    """The reference's big frame (`tools/bigframe.py:89-90`): square,
    32x32 tiles, binned, auto-banded."""
    return RenderConfig(width=size, height=size, max_depth=depth, tile_h=32,
                        tile_w=32, algorithm="binned")


def n_bands(cfg: RenderConfig) -> int:
    rows = cfg.effective_band_rows
    return cfg.tiles_y // rows if rows else 1


def lean_bands(scene, cfg: RenderConfig, ds: int = DS) -> dict:
    """The frame band by band (`render.band_layout`, the bands
    `render_gbuffer` renders, each band's front made alone), keeping
    only `min_t` [H, W], the hit mask (uint8) [H, W] and the normal
    preview `normal[::ds, ::ds]` (zeros at sky); each band's kernel outputs are reduced to those before the
    next band runs, so no full-frame plane of kernel rows ever exists.
    Also the summed `nodes` and `overflow` (pair/compaction and kernel
    drops) as host ints, and the number of `bands`. On the scene's
    device; `ds` must divide the band height in pixels."""
    bands = n_bands(cfg)
    band_px = cfg.tiles_y // bands * cfg.tile_h
    if band_px % ds:
        raise ValueError(f"preview step {ds} does not divide bands of "
                         f"{band_px} rows")
    pw = cfg.padded_width
    dev = scene.device
    min_t = torch.empty((cfg.padded_height, pw), dtype=torch.float32,
                        device=dev)
    hit = torch.empty((cfg.padded_height, pw), dtype=torch.uint8, device=dev)
    preview = torch.empty((cfg.padded_height // ds, pw // ds, 3),
                          dtype=torch.float32, device=dev)
    nodes = torch.zeros((), dtype=torch.int64, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)

    def untile(bcfg, flat):
        x = flat.reshape(bcfg.tiles_y, bcfg.tiles_x, cfg.tile_h, cfg.tile_w)
        return torch.movedim(x, 2, 1).reshape(band_px, pw)

    def keep(bcfg, y_off, mt, _px, _py, _pz, nx, ny, nz, _hitf, _lo, _hi,
             m, povf):
        y0 = int(y_off)
        band_t = untile(bcfg, mt)
        min_t[y0:y0 + band_px] = band_t
        hit[y0:y0 + band_px] = band_t < _BIG
        p0 = y0 // ds
        for c, n in enumerate((nx, ny, nz)):
            preview[p0:p0 + band_px // ds, :, c] = untile(bcfg, n)[::ds, ::ds]
        nodes.add_(m[..., 0].sum())
        overflow.add_(m[..., 1].sum() + povf)

    from sphereflake_tpu_torch.ops.binned import band_fronts, binned_gbuffer

    fw, fh = cfg.width, cfg.height
    bcfg, offsets = band_layout(cfg, (fw, fh, 0.0, 0.0))
    with torch.no_grad():
        for y_off in offsets:  # each band's front alone: one pair table held
            (front,) = band_fronts(scene, bcfg, fw, fh, 0.0, [y_off])
            outs = binned_gbuffer(bcfg, fw, fh, scene, (0.0, y_off), front)
            del front
            keep(bcfg, y_off, *outs)
            del outs  # free the band's outputs before the next band runs
    return dict(
        min_t=min_t[: cfg.height, : cfg.width],
        hit=hit[: cfg.height, : cfg.width],
        preview=preview[: -(-cfg.height // ds), : -(-cfg.width // ds)],
        nodes=int(nodes), overflow=int(overflow), bands=bands,
    )


def render_size(scene, cfg: RenderConfig) -> dict:
    """One frame of `cfg` the way `main` renders its size: `lean_bands`
    from `LEAN_FROM` on, else `render_gbuffer`. Host numbers (hits,
    closest, overflow) and, for a lean frame, the preview image."""
    dev = scene.device
    if cfg.width >= LEAN_FROM:
        out = lean_bands(scene, cfg)
        hits = int(out["hit"].sum(dtype=torch.int64))
        return dict(hits=hits, overflow=out["overflow"],
                    closest=float(out["min_t"].min()),
                    preview=out["preview"], hit=out["hit"])
    with torch.no_grad():
        gb = render_gbuffer(scene, cfg, device=dev)
    return dict(hits=int(gb.hit.sum(dtype=torch.int64)),
                overflow=int(gb.metrics.overflow),
                closest=float(gb.metrics.closest_distance))


def warm_ms(fn, dev) -> float:
    """Milliseconds of `fn()` by CUDA events (host clock on the CPU)."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end)


def parse_args(argv) -> tuple[list[int], int]:
    """(sizes, depth) from the reference's argv form `[dN] [sizes...]`."""
    p = argparse.ArgumentParser(
        prog="python -m sphereflake_tpu_torch.bigframe",
        description="Large binned frames on one card",
    )
    p.add_argument("args", nargs="*", metavar="[dN] size",
                   help="optional depth dN (default d6), then sizes "
                   "(default 4096 8192 16384)")
    args = p.parse_args(argv).args
    depth = 6
    if args and args[0].startswith("d"):
        depth = int(args[0][1:])
        args = args[1:]
    return [int(a) for a in args] or list(SIZES), depth


def main(argv=None, *, device="cuda") -> int:
    sizes, depth = parse_args(argv)
    dev = resolve_device(device)
    scene = default_scene(dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev.type} {name} depth={depth}", file=sys.stderr)
    for size in sizes:
        cfg = big_config(size, depth)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = render_size(scene, cfg)
        dt = time.perf_counter() - t0
        if "preview" in res:
            img = (res["preview"] * 0.5 + 0.5) * res["hit"][::DS, ::DS, None]
            path = os.path.join(tempfile.gettempdir(), f"bigframe_{size}.png")
            write_png(path, img)
        rays = size * size
        print(
            f"{size}x{size}: {dt:.2f}s wall (incl. kernel build + read), "
            f"{n_bands(cfg)} bands, hits {res['hits']} "
            f"({res['hits'] / rays * 100:.1f}%), closest "
            f"{res['closest']:.3f}, overflow {res['overflow']} -> "
            f"{rays / dt / 1e6:.0f}M rays/s lower bound",
            flush=True,
        )
        ms = warm_ms(lambda: render_size(scene, cfg), dev)
        clock = "CUDA events" if dev.type == "cuda" else "host clock"
        peak = (f", peak {torch.cuda.max_memory_allocated(dev) / 2**20:.0f} "
                "MiB allocated" if dev.type == "cuda" else "")
        print(f"{size}x{size}: warm call {ms:.1f} ms ({clock}) -> "
              f"{rays / ms / 1e3:.0f}M rays/s{peak}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
