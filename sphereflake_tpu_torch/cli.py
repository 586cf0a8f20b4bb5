"""Command-line entry point of the port — the full-frame branch.

Mirrors the reference package's CLI (`--width/--height`, camera pose,
depth/LOD knobs) for the modes ported so far: one full frame (or
`--frames N` timed frames) to a PNG, optionally the G-buffer to an NPZ.
Headless: the C++ app's 1 Hz title-bar metrics line
(`main.cpp:271-294`) becomes a printed metrics line.

Runs on the GPU unless `--device cpu` is given; `--device cuda` on a
machine without one is an error, never a silent CPU run.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sphereflake-tpu-torch",
        description="PyTorch/CUDA port of the sphereflake raytracer",
    )
    p.add_argument("--width", type=int, default=1280)  # main.cpp:49
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--depth", type=int, default=4, help="max fractal level")
    p.add_argument("--lod", type=float, default=70.0,
                   help="LOD factor (C++ app: 70 AVX / 60 SSE)")
    p.add_argument(
        "--algorithm",
        choices=("auto", "binned"),
        default="auto",
        help="traversal implementation; auto = binned (global expansion "
        "+ screen binning + the fused CUDA ray kernel), the only one "
        "ported so far",
    )
    p.add_argument("--tile", type=str, default=None,
                   help="tile HxW (default: 32x32)")
    p.add_argument("--global-cap", type=int, default=None,
                   help="live-node cap per fractal level (default: "
                   "RenderConfig's 9*8192; doubled on overflow)")
    p.add_argument("--output", "-o", type=str, default="sphereflake.png")
    p.add_argument("--gbuffer", type=str, default=None,
                   help="also save G-buffer NPZ")
    p.add_argument(
        "--mode",
        choices=("composite", "normals", "ao"),
        default="composite",
        help="composite = full SSAO pipeline; normals/ao = debug planes",
    )
    # camera pose (defaults = the C++ app's startup pose, main.cpp:93-96)
    p.add_argument("--camera-pos", type=str, default="-5.4098,-7.2139,1.19006")
    p.add_argument("--yaw", type=float, default=0.921999)
    p.add_argument("--pitch", type=float, default=-1.371)
    p.add_argument("--roll", type=float, default=0.0)
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--frames", type=int, default=1,
                   help="frames to render (timing)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from sphereflake_tpu_torch.config import (
        CameraParams,
        FractalParams,
        RenderConfig,
        SSAOParams,
        SceneParams,
        resolve_device,
    )
    from sphereflake_tpu_torch.render import (
        grow_capacity,
        render_frame,
        render_gbuffer,
    )
    from sphereflake_tpu_torch.utils.image import (
        shade_normals,
        write_gbuffer_npz,
        write_png,
    )

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    tile_h, tile_w = (int(v) for v in (args.tile or "32x32").split("x"))
    try:
        cfg = RenderConfig(
            width=args.width,
            height=args.height,
            max_depth=args.depth,
            lod_factor=args.lod,
            tile_h=tile_h,
            tile_w=tile_w,
            algorithm="binned",  # auto and binned both
            **(
                {"global_cap": args.global_cap}
                if args.global_cap is not None
                else {}
            ),
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    pos = [float(v) for v in args.camera_pos.split(",")]
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    scene = SceneParams(
        camera=CameraParams(
            position=f32(pos),
            yaw=f32(args.yaw),
            pitch=f32(args.pitch),
            roll=f32(args.roll),
            fov=f32(args.fov),
        ),
        fractal=FractalParams.reference_default(device),
        ssao=SSAOParams.reference_default(device),
    )

    name = (
        torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    )
    print(
        f"sphereflake-tpu-torch: {cfg.width}x{cfg.height} "
        f"depth={cfg.max_depth} lod={cfg.lod_factor} "
        f"tiles={cfg.tiles_y}x{cfg.tiles_x} device={device.type} ({name})"
    )

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def one_frame(i):
        # Vary an inconsequential input so every timed frame does its
        # full work.
        cam = dataclasses.replace(scene.camera, yaw=scene.camera.yaw + 1e-7 * i)
        sc = dataclasses.replace(scene, camera=cam)
        if args.mode == "composite":
            return render_frame(sc, cfg, device=device)
        return None, render_gbuffer(sc, cfg, device=device)

    image, gb = one_frame(0)  # warm-up: builds and loads the kernel
    sync()
    # Enqueue the timed frames back to back and wait once: the frame
    # path reads nothing back to the host.
    t0 = time.perf_counter()
    for i in range(args.frames):
        image, gb = one_frame(1 + i)
    sync()
    dt_total = time.perf_counter() - t0

    # Overflow means dropped geometry: retry with doubled capacity until
    # clean (capacity may cost speed, never correctness — the C++ app's
    # recursion visits every LOD-passing node, `Sphereflake.h:165-172`).
    retries = 0
    while int(gb.metrics.overflow) and retries < 6:
        cfg = grow_capacity(cfg)
        print(
            f"capacity overflow ({int(gb.metrics.overflow)} nodes "
            f"dropped); retrying with global_cap={cfg.global_cap} "
            f"bands={cfg.effective_band_rows}",
            file=sys.stderr,
        )
        image, gb = one_frame(0)
        sync()
        retries += 1

    m = gb.metrics
    dt = dt_total / args.frames
    rays = cfg.width * cfg.height
    # The C++ app's 1 Hz title line (main.cpp:271-294):
    print(
        f"FPS: {1.0 / max(dt, 1e-9):.1f} Depth: {int(m.max_depth_reached)} "
        f"Rays per second: {rays / max(dt, 1e-9) / 1e3:.0f}k "
        f"Closest sphere: {float(m.closest_distance):.4f}"
    )
    if int(m.overflow):
        print(f"warning: capacity overflow dropped {int(m.overflow)} nodes "
              f"(raise --global-cap)", file=sys.stderr)

    if args.mode == "composite":
        out = image
    elif args.mode == "normals":
        out = shade_normals(gb.normal, gb.hit)
    else:  # ao
        from sphereflake_tpu_torch.ops.noise import ssao_noise_texture
        from sphereflake_tpu_torch.ops.post import ssao_pass

        with torch.no_grad():
            ao = ssao_pass(
                gb.position, gb.normal,
                torch.from_numpy(ssao_noise_texture(cfg.noise_size)).to(device),
                scene.ssao,
                scene.ssao.radius_multiplier * m.closest_distance,
                cfg.height // cfg.ssao_downscale,
                cfg.width // cfg.ssao_downscale,
            )
        out = np.repeat(ao.cpu().numpy()[..., None], 3, axis=-1)

    write_png(args.output, out)
    if args.gbuffer:
        write_gbuffer_npz(
            args.gbuffer, gb.position, gb.normal, gb.min_t,
            image=image if args.mode == "composite" else None,
        )
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
