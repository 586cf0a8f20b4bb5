"""Command-line entry point of the port.

Mirrors the reference package's CLI (`--width/--height`, camera pose,
depth/LOD knobs):

- one full frame (or `--frames N` timed frames) to a PNG, optionally
  the G-buffer to an NPZ; `--profile DIR` writes a `torch.profiler`
  trace of the timed frames (a Chrome trace, `DIR/trace.json`) and, in
  every mode, the run's stage spans (`DIR/spans.json`, see `spans.py`);
- `--progressive STEPS`: frameless Sobol accumulation with a static
  camera, by whole tiles (`--progressive-unit tile`, the default;
  binned only) or by single pixels (`sample`);
- `--animate FRAMES`: a camera path (orbit or approach), one full
  frame per step, each to `{stem}_{i:04d}{ext}`; with `--frameless`
  the camera moves while one buffer keeps accumulating (binned only);
- `--fit TARGET_NPZ`: gradient-descent fitting of the camera, the SSAO
  uniforms or every parameter (`--fit-params`) to a target written by
  `--gbuffer`, on the G-buffer or the composite image (`--fit-loss`),
  Adam with a cosine-decayed rate (`--fit-steps`, `--fit-lr`);
- `--checkpoint PATH` / `--resume PATH`: the fit's parameters and
  optimizer state, or the frameless state of either progressive unit,
  in the reference package's file format (files pass both ways).

`--algorithm` picks the traversal: `binned` (what `auto` means: the
port's default device is the GPU), `pallas` (the per-tile traversal
kernel), `fast` (plain ops, cone-culled), `strict` or `loose` (the
parity traversal in plain ops; `--loose-lod` gates per node instead of
per ray, whichever of the two names is given).

Headless: the C++ app's 1 Hz title-bar metrics line
(`main.cpp:271-294`) becomes a printed metrics line.

Multi-device, like the C++ app's hardware_concurrency worker pool
(`Sphereflake.cpp:69`): on the GPU the frame, the fit, the camera path
and the tile-granular frameless refresh shard over a 2D mesh of every
local card (`--devices N` uses N, 1 opts out; `--mesh RxC` pins the
shape); `--frame-parallel` renders a different orbit frame on each
device instead. On the CPU a mesh is built only when asked for
(`--mesh`, `--devices`): its cells are repeated `cpu` devices, as many
as the machine has cores.

Runs on the GPU unless `--device cpu` (or `--platform cpu`) is given;
`--device cuda` on a machine without one is an error, never a silent
CPU run.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
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
        choices=("auto", "binned", "pallas", "fast", "strict", "loose"),
        default="auto",
        help="traversal implementation; auto = binned, the production "
        "path (global expansion + screen binning + the fused CUDA ray "
        "kernel); pallas = the per-tile traversal kernel; fast = the "
        "plain-op cone-culled traversal; strict/loose = the plain-op "
        "parity traversal",
    )
    p.add_argument("--tile", type=str, default=None,
                   help="tile HxW (default: 32x32 for binned/pallas, "
                   "64x128 otherwise)")
    p.add_argument("--max-frontier", type=int, default=1024,
                   help="per-tile paths: cap on live spheres per tile and "
                   "level (doubled on overflow)")
    p.add_argument("--global-cap", type=int, default=None,
                   help="binned path: live-node cap per fractal level "
                   "(default: RenderConfig's 9*8192; doubled on overflow)")
    p.add_argument("--tile-batch", type=int, default=16,
                   help="per-tile paths: tiles traced concurrently by the "
                   "plain-op traversals")
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
    # frameless progressive mode (the C++ app's default behaviour)
    p.add_argument("--progressive", type=int, default=0, metavar="STEPS",
                   help="frameless Sobol accumulation for N steps instead "
                   "of a full frame")
    p.add_argument("--batch", type=int, default=65536,
                   help="samples per progressive step")
    p.add_argument("--progressive-unit", choices=("tile", "sample"),
                   default="tile",
                   help="frameless refresh granularity: 'tile' traces "
                   "whole Sobol-chosen 1024-ray tiles through the fused "
                   "kernel; 'sample' scatters individual Sobol pixels "
                   "like the C++ app's packets (its exact sampling law, "
                   "at a higher per-sample cost)")
    p.add_argument("--snapshot-every", type=int, default=0, metavar="K",
                   help="frameless tile mode: write a snapshot of the "
                   "in-flight buffer every K steps (with --mode "
                   "composite the full SSAO->blur->composite chain "
                   "runs over it, like the C++ app's display loop "
                   "every vsync, main.cpp:301-335)")
    p.add_argument("--no-trim-prepared", action="store_true",
                   help="frameless tile mode: keep the full candidate "
                   "table instead of the occlusion/frustum-trimmed one "
                   "(the trim renders one frame at prepare time and "
                   "drops candidates PROVABLY unable to win any pixel — "
                   "output is bit-identical; disable only to skip the "
                   "prepare-time render)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--frames", type=int, default=1,
                   help="frames to render (timing)")
    p.add_argument("--loose-lod", action="store_true",
                   help="node-level LOD gating (faster, packet-like "
                   "semantics) for the strict/loose traversal")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler trace of the timed frames "
                   "(DIR/trace.json, Chrome trace format) and, in every "
                   "mode, the run's stage spans (DIR/spans.json, every "
                   "unit's record: frames, tile steps, fit calls; each "
                   "span's median ms a unit is printed); "
                   "SPHEREFLAKE_TORCH_SPANS=0 turns the spans off")
    # camera-path animation (the C++ app's navigation, main.cpp:206-257)
    p.add_argument("--animate", type=int, default=0, metavar="FRAMES",
                   help="render a camera-path frame sequence")
    p.add_argument("--animate-mode", choices=("orbit", "approach"),
                   default="orbit")
    p.add_argument("--speed-factor", type=float, default=0.05,
                   help="approach step as a fraction of the closest-sphere "
                   "distance (the C++ app's speed law, main.cpp:213)")
    p.add_argument("--frameless", action="store_true",
                   help="animate with FRAMELESS accumulation: the "
                   "camera moves while tiles keep refreshing into one "
                   "persistent buffer (stale tiles from the previous "
                   "view get overwritten — the C++ app's SetView "
                   "mid-flight, main.cpp:304); --batch sets the samples "
                   "refreshed per camera step")
    # gradient-descent fitting (BASELINE config 4)
    p.add_argument("--fit", type=str, default=None, metavar="TARGET_NPZ",
                   help="fit scene params to a target G-buffer NPZ "
                   "(from --gbuffer) instead of rendering")
    p.add_argument("--fit-steps", type=int, default=100)
    p.add_argument("--fit-lr", type=float, default=2e-3)
    p.add_argument("--fit-params", choices=("camera", "ssao", "all"),
                   default="camera")
    p.add_argument("--fit-loss", choices=("gbuffer", "image"),
                   default="gbuffer",
                   help="'image' fits against the target NPZ's "
                   "composited frame through the FULL post chain "
                   "(SSAO/blur/composite) — required to put gradient "
                   "on --fit-params ssao; save targets with --gbuffer "
                   "in --mode composite")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="save fitted params/opt state (or progressive "
                   "state) to this NPZ")
    p.add_argument("--resume", type=str, default=None,
                   help="resume fit/progressive state from a checkpoint NPZ")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--platform", choices=("auto", "cpu"), default="auto",
                   help="cpu = --device cpu; auto = --device (the card "
                   "by default)")
    # Multi-device operation: like the C++ app's hardware_concurrency
    # worker pool (`Sphereflake.cpp:69`), the one executable uses every
    # available card by default, sharding the screen over a 2D mesh.
    p.add_argument("--devices", type=int, default=None,
                   help="local devices to use (default: every card; on the "
                   "CPU 1; 1 disables sharding)")
    p.add_argument("--mesh", type=str, default=None, metavar="RxC",
                   help="explicit 2D device mesh shape (rows x cols of "
                   "screen blocks; default: auto factorization)")
    p.add_argument("--frame-parallel", action="store_true",
                   help="animate (orbit) with FRAME data parallelism: "
                   "each device renders a different full frame per "
                   "batch — the shape for small frames (tile-sharding "
                   "one small frame pays its fixed costs per block)")
    return p


def _auto_mesh_shape(n: int, cfg) -> tuple[int, int]:
    """Pick a (rows, cols) factorization of <= n devices that wastes
    the least padding for this frame (blocks are tile-aligned,
    ceil-divided — `parallel.sharded._block_cfg`), preferring square-ish
    meshes on ties. Every factorization works; this is just the
    cheapest one."""
    best = (1, 1)
    best_cost = None
    for my in range(1, n + 1):
        mx = n // my
        if mx < 1:
            continue
        bh = -(-cfg.height // (my * cfg.tile_h)) * cfg.tile_h
        bw = -(-cfg.width // (mx * cfg.tile_w)) * cfg.tile_w
        cost = (my * bh * mx * bw, abs(my - mx))
        if best_cost is None or cost < best_cost:
            best_cost, best = cost, (my, mx)
    return best


def _device_mesh(args, cfg, device):
    """(mesh or None, available device count) over the cards of this
    machine, or repeated CPU devices up to its core count (used only when
    a mesh is asked for). Raises ValueError on a `--mesh` it cannot
    build."""
    import torch

    from sphereflake_tpu_torch.parallel import make_mesh

    if device.type == "cuda":
        n_avail = torch.cuda.device_count()
        pool = [torch.device("cuda", i) for i in range(n_avail)]
        default_n = n_avail
    else:
        n_avail = os.cpu_count() or 1
        pool = [device] * n_avail
        default_n = 1
    if args.mesh is not None:
        try:
            my, mx = (int(v) for v in args.mesh.lower().split("x"))
        except ValueError:
            raise ValueError(f"--mesh {args.mesh!r} is not of the form RxC "
                             "(e.g. 2x4)") from None
        if my < 1 or mx < 1:
            raise ValueError(f"--mesh {args.mesh} must have positive dims")
        if my * mx > n_avail:
            raise ValueError(f"--mesh {args.mesh} needs {my * mx} devices, "
                             f"have {n_avail}")
    else:
        n = min(args.devices or default_n, n_avail)
        my, mx = _auto_mesh_shape(n, cfg)
    if my * mx == 1:
        return None, n_avail
    return make_mesh(pool[: my * mx], shape=(my, mx)), n_avail


def _run_fit(args, scene, cfg, device, mesh, render_frame_) -> int:
    """`--fit TARGET_NPZ`: Adam with a cosine-decayed rate on the chosen
    parameters, then one composite frame of the best iterate."""
    import torch

    from sphereflake_tpu_torch.fit import (
        adam,
        adam_init,
        camera_only,
        fit,
        ssao_only,
    )
    from sphereflake_tpu_torch.runtime.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from sphereflake_tpu_torch.utils.image import write_png

    data = np.load(args.fit)
    as_tensor = lambda a: torch.tensor(np.asarray(a), device=device)
    tgt_pos = as_tensor(data["position"])
    tgt_nrm = as_tensor(data["normal"])
    tgt_img = None
    if args.fit_loss == "image":
        if "image" not in data:
            print(
                f"error: {args.fit} has no 'image' plane — save the "
                "target with --gbuffer in --mode composite",
                file=sys.stderr,
            )
            return 2
        tgt_img = as_tensor(data["image"])
    if args.fit_params == "ssao" and args.fit_loss != "image":
        print(
            "error: --fit-params ssao needs --fit-loss image (the "
            "G-buffer carries no SSAO signal)", file=sys.stderr,
        )
        return 2
    opt_state = None
    if args.resume:
        loaded = load_checkpoint(
            args.resume,
            {"scene": scene, "opt_state": adam_init(scene, schedule=True)},
        )
        scene, opt_state = loaded["scene"], loaded["opt_state"]
    filters = {"camera": camera_only, "ssao": ssao_only}
    res = fit(
        scene, tgt_pos, tgt_nrm, cfg,
        steps=args.fit_steps,
        optimizer=adam(args.fit_lr, args.fit_steps),
        opt_state=opt_state,
        mesh=mesh,
        param_filter=filters.get(args.fit_params),
        log_every=max(1, args.fit_steps // 10),
        loss=args.fit_loss, target_image=tgt_img,
        device=device,
    )
    print(
        f"fit: loss {res.losses[0]:.6f} -> best "
        f"{min(res.losses):.6f} over {args.fit_steps} steps"
    )
    if args.checkpoint:
        save_checkpoint(
            args.checkpoint, scene=res.scene, opt_state=res.opt_state
        )
        print(f"wrote {args.checkpoint}")
    image, _ = render_frame_(res.scene, cfg)
    write_png(args.output, image)
    print(f"wrote {args.output}")
    return 0


def _run_animate(args, scene, cfg, device, mesh) -> int:
    """`--animate N`: one full frame per camera step, one PNG each
    (sharded over `mesh`, or one frame per device with
    `--frame-parallel`)."""
    from sphereflake_tpu_torch.runtime.animate import (
        animate,
        animate_frames_dp,
    )
    from sphereflake_tpu_torch.utils.image import write_png

    stem, ext = os.path.splitext(args.output)
    ext = ext or ".png"
    t0 = time.perf_counter()
    if args.frame_parallel:
        if args.animate_mode != "orbit":
            print("error: --frame-parallel needs --animate-mode "
                  "orbit (approach is sequentially dependent via "
                  "the speed law)", file=sys.stderr)
            return 2
        devices = list(mesh.devices.flat) if mesh is not None else [device]
        frames_it = animate_frames_dp(scene, cfg, args.animate, devices)
    else:
        frames_it = animate(
            scene, cfg, args.animate, mode=args.animate_mode,
            speed_factor=args.speed_factor,
            composite=args.mode == "composite", mesh=mesh, device=device,
        )
    for i, (image, _) in enumerate(frames_it):
        write_png(f"{stem}_{i:04d}{ext}", image)
    dt = time.perf_counter() - t0
    print(
        f"animate: {args.animate} frames ({args.animate_mode}) in "
        f"{dt:.1f}s -> {stem}_0000{ext}..{stem}_{args.animate - 1:04d}{ext}"
    )
    return 0


def _run_frameless_animate(args, scene, cfg, device, sync) -> int:
    """`--animate N --frameless`: one PNG per camera step."""
    from sphereflake_tpu_torch.runtime.animate import frameless_animate
    from sphereflake_tpu_torch.runtime.progressive import (
        FramelessCapacityError,
    )
    from sphereflake_tpu_torch.utils.image import write_png

    steps_per_frame = 8
    tiles_per_step = max(1, args.batch // 1024 // steps_per_frame)
    stem, ext = os.path.splitext(args.output)
    ext = ext or ".png"
    t0 = time.perf_counter()
    n_rays = 0
    frames_it = frameless_animate(
        scene, cfg, args.animate,
        steps_per_frame=steps_per_frame,
        tiles_per_step=tiles_per_step,
        mode=args.animate_mode,
        speed_factor=args.speed_factor,
        seed=args.seed,
        composite=args.mode == "composite",
        device=device,
    )
    try:
        for i, (image, _sc, stats) in enumerate(frames_it):
            write_png(f"{stem}_{i:04d}{ext}", image)
            if i == 0:
                t0 = time.perf_counter()  # after the kernel build
            else:
                n_rays += steps_per_frame * tiles_per_step * 1024
            print(
                f"frameless frame {i}: closest "
                f"{stats['closest']:.4f}, buffer covered "
                f"{stats['covered'] * 100:.0f}%, refresh/frame "
                f"{stats['refresh_fraction'] * 100:.0f}%"
            )
    except FramelessCapacityError as e:
        # The frameless capacity ladder ends in a clean error.
        print(f"error: {e}", file=sys.stderr)
        return 1
    sync()
    dt = time.perf_counter() - t0
    if n_rays:
        print(
            f"frameless animate: steady-state "
            f"{n_rays / max(dt, 1e-9) / 1e6:.1f}M rays/s "
            f"(re-binned per camera step, snapshots included)"
        )
    return 0


def _run_progressive(args, scene, cfg, device, sync, mesh) -> int:
    """`--progressive STEPS`: static-camera frameless accumulation."""
    import torch

    from sphereflake_tpu_torch.runtime.progressive import (
        FramelessCapacityError,
        grow_frameless_capacity,
        progressive_init,
        progressive_prepare,
        progressive_prepare_trimmed,
        progressive_step,
        progressive_tiles_init,
        progressive_tiles_step,
        tile_progressive_composite,
        tile_progressive_gbuffer,
    )
    from sphereflake_tpu_torch.runtime.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from sphereflake_tpu_torch.utils.image import (
        shade_normals,
        write_gbuffer_npz,
        write_png,
    )

    binned = cfg.algorithm == "binned"
    use_tiles = args.progressive_unit == "tile" and binned
    if args.progressive_unit == "tile" and not binned:
        print(
            "note: the tile-granular frameless mode needs the binned "
            f"algorithm; --algorithm {cfg.algorithm} accumulates by "
            "single pixels (--progressive-unit sample)",
            file=sys.stderr,
        )
    if args.snapshot_every and not use_tiles:
        print(
            "note: --snapshot-every only runs in the tile-granular "
            "frameless mode (binned algorithm, --progressive-unit "
            "tile); no in-flight snapshots will be written",
            file=sys.stderr,
        )
    if not use_tiles and cfg.algorithm != "fast" and args.batch % 1024:
        print(
            f"error: --progressive-unit sample needs --batch to be a "
            f"multiple of 1024, got {args.batch}", file=sys.stderr,
        )
        return 2
    # Static camera: bin the frame once, reuse across every step. A
    # pair-table overflow in the prepared table would silently drop
    # geometry from EVERY step, so grow capacity before accumulating —
    # via the FRAMELESS ladder, which ends cleanly at the global_cap
    # ceiling (banding, the full-frame ladder's next rung, cannot help
    # a pair table that spans the frame). The sample unit takes the
    # untrimmed table: its bundle spans need neighbouring tiles'
    # segments adjacent.
    prep_fn = (
        progressive_prepare
        if (args.no_trim_prepared or not use_tiles)
        else progressive_prepare_trimmed
    )
    prepared = None
    while binned:
        prepared = prep_fn(scene, cfg, device=device)
        dropped = int(prepared[3])
        if not dropped:
            break
        try:
            cfg = grow_frameless_capacity(cfg)
        except FramelessCapacityError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        print(
            f"pair-table overflow ({dropped} pairs dropped) in frameless "
            f"prepare; retrying with global_cap={cfg.global_cap}",
            file=sys.stderr,
        )

    if use_tiles:
        stem, ext = os.path.splitext(args.output)
        ext = ext or ".png"

        def write_snapshot(path, st):
            # The display read of the frameless loop: the full post
            # chain over the in-flight buffer (composite mode,
            # `main.cpp:301-335`) or the debug normal shading.
            if args.mode == "composite":
                write_png(path, tile_progressive_composite(st, scene, cfg))
            else:
                _p, nrm, _mt, hit = tile_progressive_gbuffer(st, cfg)
                write_png(path, shade_normals(nrm, hit))

        tiles_per_step = max(1, args.batch // 1024)
        # Multi-device: every cell refines ONE frameless buffer,
        # refreshing Sobol-chosen tiles of its own block — the C++ app's
        # worker pool sharing one G-buffer (`Sphereflake.cpp:67-74`).
        frameless_mesh = None
        if mesh is not None:
            from sphereflake_tpu_torch.parallel.frameless import (
                _block_tiles,
                sharded_tiles_as_single,
                sharded_tiles_init,
                sharded_tiles_step,
            )

            try:
                _block_tiles(cfg, mesh)
                frameless_mesh = mesh
            except ValueError as e:
                print(f"note: frameless runs single-device ({e})",
                      file=sys.stderr)
        if frameless_mesh is not None:
            tiles_per_device = max(1, tiles_per_step // mesh.size)
            tiles_per_step = tiles_per_device * mesh.size
            state = sharded_tiles_init(cfg, mesh, seed=args.seed)

            def step_state(st):
                return sharded_tiles_step(
                    st, scene, cfg, mesh, tiles_per_device=tiles_per_device,
                    prepared=prepared,
                )

            as_plain = sharded_tiles_as_single
            ckpt_key = "progressive_tiles_sharded"
        else:
            state = progressive_tiles_init(cfg, seed=args.seed, device=device)

            def step_state(st):
                return progressive_tiles_step(
                    st, scene, cfg, tiles_per_step=tiles_per_step,
                    prepared=prepared,
                )

            as_plain = lambda st: st
            ckpt_key = "progressive_tiles"
        if args.resume:
            state = load_checkpoint(args.resume, {ckpt_key: state})[ckpt_key]
        t0 = time.perf_counter()
        for step in range(args.progressive):
            state = step_state(state)
            if step == 0:
                sync()  # the first step builds and loads the kernel
                t0 = time.perf_counter()
            if args.snapshot_every and (
                (step + 1) % args.snapshot_every == 0
                and step + 1 < args.progressive
            ):
                write_snapshot(f"{stem}_s{step + 1:05d}{ext}",
                               as_plain(state))
        sync()
        dt = time.perf_counter() - t0
        if args.snapshot_every:
            n_snaps = (args.progressive - 1) // args.snapshot_every
            print(
                f"wrote {n_snaps} in-flight snapshots "
                f"({stem}_sNNNNN{ext})"
            )
        rays = max(1, args.progressive - 1) * tiles_per_step * 1024
        position, normal, min_t, _hit = tile_progressive_gbuffer(
            as_plain(state), cfg
        )
        print(
            f"progressive[tile]: {state.samples_traced} samples "
            f"({int(state.covered.sum())}/{cfg.tiles_y * cfg.tiles_x} "
            f"tiles covered), {rays / max(dt, 1e-9) / 1e6:.1f}M "
            f"rays/s, closest sphere: "
            f"{float(state.closest_distance):.4f}"
        )
        if int(state.overflow):
            print(
                f"warning: {int(state.overflow)} pair/kernel drops "
                "accumulated across steps — the image is missing "
                "geometry (raise --global-cap)",
                file=sys.stderr,
            )
    else:
        state = progressive_init(cfg, seed=args.seed, device=device)
        if args.resume:
            state = load_checkpoint(args.resume, {"progressive": state})[
                "progressive"
            ]
        t0 = time.perf_counter()
        for step in range(args.progressive):
            state = progressive_step(
                state, scene, cfg, batch_size=args.batch, prepared=prepared,
            )
            if step == 0:
                sync()  # the first step builds and loads the kernel
                t0 = time.perf_counter()
        sync()
        dt = time.perf_counter() - t0
        rays = max(1, args.progressive - 1) * args.batch
        position, normal, min_t = state.position, state.normal, state.min_t
        print(
            f"progressive: {state.samples_traced} samples, "
            f"{rays / max(dt, 1e-9) / 1e6:.1f}M rays/s, "
            f"closest sphere: {float(state.closest_distance):.4f}"
        )
        if int(state.overflow):
            print(
                f"warning: {int(state.overflow)} dropped nodes "
                "accumulated across steps — the image is missing "
                "geometry (raise --max-frontier / --global-cap)",
                file=sys.stderr,
            )
    if args.mode == "composite":
        # The full display pipeline over the final accumulated buffer
        # (`main.cpp:301-335`); at full coverage this equals
        # `render_frame` of the same scene.
        if use_tiles:
            img = tile_progressive_composite(as_plain(state), scene, cfg)
        else:
            from sphereflake_tpu_torch.ops.noise import ssao_noise_texture
            from sphereflake_tpu_torch.ops.post import postprocess

            with torch.no_grad():
                img = postprocess(
                    position, normal, torch.min(min_t), scene, cfg,
                    torch.from_numpy(
                        ssao_noise_texture(cfg.noise_size)
                    ).to(device),
                )
    else:
        img = shade_normals(normal)
    write_png(args.output, img)
    if args.gbuffer:
        # In composite mode the NPZ carries the composited frame too, so
        # a progressive run's target works for image-loss fitting
        # exactly like a full-frame one.
        write_gbuffer_npz(
            args.gbuffer, position, normal, min_t,
            image=img if args.mode == "composite" else None,
        )
    if args.checkpoint:
        key = ckpt_key if use_tiles else "progressive"
        save_checkpoint(args.checkpoint, **{key: state})
        print(f"wrote {args.checkpoint}")
    print(f"wrote {args.output}")
    return 0


def _write_spans(path: str) -> None:
    """Every unit record of the process's stage spans to `path` (JSON),
    and each span's median milliseconds a unit and each counter's total
    to stdout."""
    from sphereflake_tpu_torch import spans

    recs = {name: list(spans.records(name)) for name in spans.units()}
    with open(path, "w") as f:
        json.dump(recs, f)
    print(f"wrote stage spans {path}")
    for name, rs in recs.items():
        print(f"spans: {len(rs)} {name} units, median "
              f"{statistics.median(r['ns'] for r in rs) * 1e-6:.3f} ms")
        for s in sorted({s for r in rs for s in r["spans"]}):
            print(f"spans:   {s} {spans.median_ms(name, s):.3f} ms a {name}")
        for c in sorted({c for r in rs for c in r["counts"]}):
            print(f"spans:   {c} {sum(r['counts'].get(c, 0) for r in rs)} "
                  f"over the {len(rs)} {name} units")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    rc = _main(args)
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        _write_spans(os.path.join(args.profile, "spans.json"))
    return rc


def _main(args) -> int:
    import torch

    from sphereflake_tpu_torch import spans
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
        device = resolve_device(
            "cpu" if args.platform == "cpu" else args.device
        )
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    # auto = binned: the one executable runs its production path (the
    # port's default device is the GPU).
    algorithm = "binned" if args.algorithm == "auto" else args.algorithm
    tile = args.tile or (
        "32x32" if algorithm in ("pallas", "binned") else "64x128"
    )
    tile_h, tile_w = (int(v) for v in tile.split("x"))
    if algorithm == "pallas" and args.depth > 7:
        # `trace_tiles_pallas_soa`'s bound, reported before any work.
        print(
            "error: pallas path supports max_depth <= 7 (f32 path-code "
            "exactness); use an XLA algorithm for deeper", file=sys.stderr,
        )
        return 2
    try:
        cfg = RenderConfig(
            width=args.width,
            height=args.height,
            max_depth=args.depth,
            lod_factor=args.lod,
            tile_h=tile_h,
            tile_w=tile_w,
            max_frontier=args.max_frontier,
            tile_batch=args.tile_batch,
            algorithm=algorithm,
            strict_lod=not args.loose_lod,
            **(
                {"global_cap": args.global_cap}
                if args.global_cap is not None
                else {}
            ),
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    try:
        mesh, n_avail = _device_mesh(args, cfg, device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if mesh is not None:
        from sphereflake_tpu_torch.parallel import (
            render_frame_sharded,
            render_gbuffer_sharded,
        )

        render_frame_ = lambda s, c: render_frame_sharded(s, c, mesh)
        render_gbuffer_ = lambda s, c: render_gbuffer_sharded(s, c, mesh)
    else:
        render_frame_ = lambda s, c: render_frame(s, c, device=device)
        render_gbuffer_ = lambda s, c: render_gbuffer(s, c, device=device)

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
    mesh_str = (
        f" mesh={mesh.shape[0]}x{mesh.shape[1]} of {n_avail}"
        if mesh is not None else ""
    )
    print(
        f"sphereflake-tpu-torch: {cfg.width}x{cfg.height} "
        f"depth={cfg.max_depth} lod={cfg.lod_factor} "
        f"tiles={cfg.tiles_y}x{cfg.tiles_x} device={device.type} ({name})"
        f"{mesh_str}"
    )

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if args.animate:
        if not args.frameless:
            return _run_animate(args, scene, cfg, device, mesh)
        if cfg.algorithm != "binned":
            print("error: --frameless needs the binned path "
                  "(--algorithm binned)", file=sys.stderr)
            return 2
        return _run_frameless_animate(args, scene, cfg, device, sync)
    if args.fit:
        return _run_fit(args, scene, cfg, device, mesh, render_frame_)
    if args.progressive:
        return _run_progressive(args, scene, cfg, device, sync, mesh)

    def one_frame(i):
        # Vary an inconsequential input so every timed frame does its
        # full work.
        cam = dataclasses.replace(scene.camera, yaw=scene.camera.yaw + 1e-7 * i)
        sc = dataclasses.replace(scene, camera=cam)
        if args.mode == "composite":
            return render_frame_(sc, cfg)
        return None, render_gbuffer_(sc, cfg)

    image, gb = one_frame(0)  # warm-up: builds and loads the kernel
    sync()
    profile_ctx = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profile_ctx = profile(activities=activities)
    # Enqueue the timed frames back to back and wait once: the frame
    # path reads nothing back to the host.
    with profile_ctx as prof:
        t0 = time.perf_counter()
        for i in range(args.frames):
            with spans.unit("frame"):
                image, gb = one_frame(1 + i)
        sync()
        dt_total = time.perf_counter() - t0
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(trace)
        print(f"wrote profiler trace {trace}")

    # Overflow means dropped geometry: retry with doubled capacity until
    # clean (capacity may cost speed, never correctness — the C++ app's
    # recursion visits every LOD-passing node, `Sphereflake.h:165-172`).
    retries = 0
    while int(gb.metrics.overflow) and retries < 6:
        # Grow global_cap (binned) / max_frontier (per-tile), then fall
        # back to bands.
        cfg = grow_capacity(cfg)
        print(
            f"capacity overflow ({int(gb.metrics.overflow)} nodes "
            f"dropped); retrying with global_cap={cfg.global_cap} "
            f"bands={cfg.effective_band_rows} "
            f"max_frontier={cfg.max_frontier}",
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
              f"(raise --global-cap / --max-frontier)", file=sys.stderr)

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
                (scene.ssao.radius_multiplier, m.closest_distance),
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
