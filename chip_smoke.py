#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on a GPU.

Run from the repository root on a machine with one NVIDIA Hopper card,
a CUDA toolkit (`nvcc`) and PyTorch built for CUDA:

    python3 chip_smoke.py            # all phases, about a minute
    python3 chip_smoke.py --ptxas    # also print registers / shared memory

It drives the port's main path — `render_frame` at 1920x1080, depth 6,
the call `python -m sphereflake_tpu_torch` makes — and holds every
hand-written kernel against its plain torch version on the card.
Phases, each printing one JSON line:

1. device: card name and power limit, versions, kernel build seconds;
2. kernels vs plain: the fused pairs kernel at the main path's shapes
   (the 1080p depth-6 pair table) and its deep variant on a depth-8
   dive pose;
3. main path: the CLI's full-frame run to a PNG, then a few
   `render_frame` calls with the camera moving; launch counts are set
   to 0 just before and read just after; the same frame with the plain
   version substituted must agree;
4. times (CUDA events): ms/frame, the stage split, kernel vs plain vs
   bound; and a `torch.profiler` view of one frame (device busy time,
   idle share, launches per frame, top kernels);
5. the `kernels` line, the card line, and the final `ok` line.

Any failed check exits non-zero. Without a CUDA device, or outside the
repository (no `sphereflake_tpu_torch` package beside it), it exits 1
and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

# Published peaks of one H100 SXM (NVIDIA data sheet): the bound is
# stated against these, with the card's power limit printed beside it.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# f32 operations of one ray-sphere test in the kernel's loop (5 for the
# dot product, 2 for disc, 5 for the LOD gate, 3 compares + 2 ands,
# 3 for ts, 2 compares + 2 logic for the tie rule, 1 select group).
OPS_PER_TEST = 25
# Per ray outside the loop: raygen (~30) and the shading epilogue (~30).
OPS_PER_RAY = 60

WIDTH, HEIGHT, DEPTH = 1920, 1080, 6
FRAMES = 3  # render_frame calls whose result is checked
CLI_FRAMES = 2  # timed frames of the CLI run (plus its warm-up frame)
# Kernel vs plain, on identical inputs, both without FMA contraction:
# codes and hit masks must agree on at least this fraction of rays, and
# min_t / position / normal on common hits within this absolute error.
AGREE_MIN = 0.9999
ABS_ERR_MAX = 1e-4
# Whole frame, kernel vs plain substituted (the stated main-path bar).
FRAME_HIT_MIN = 0.999


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def event_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of `fn()` over `reps` runs, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_device(torch, fn, reps: int):
    """Device-side view of `fn()` from `torch.profiler`: busy
    milliseconds and kernel launches per call, and the kernels that
    take most of the device time. None where the profiler reports no
    device time (then only the CUDA-event times stand)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [
        e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
    ]
    dev_us = lambda e: getattr(
        e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)
    )
    busy_us = sum(dev_us(e) for e in kernels)
    if not busy_us:
        return None
    top = sorted(kernels, key=dev_us, reverse=True)[:6]
    return dict(
        busy_ms=busy_us / 1e3 / reps,
        launches=sum(e.count for e in kernels) / reps,
        top=[
            dict(name=e.key[:70], ms=dev_us(e) / 1e3 / reps,
                 launches=e.count / reps)
            for e in top
        ],
    )


def dive_scene(torch, device, hover: float = 0.002):
    """Camera hovering `hover` above the limit point of the nested
    child-0 chain, looking at it: geometry at every level sits within
    reach, so the LOD cut alone decides the depth reached (past 7, where
    the kernel's hi code lane carries real codes)."""
    import numpy as np

    from sphereflake_tpu_torch.config import (
        CameraParams,
        FractalParams,
        SSAOParams,
        SceneParams,
    )
    from sphereflake_tpu_torch.models.sphereflake import (
        child_templates,
        root_frame,
    )

    fractal = FractalParams.reference_default(device)
    templates = child_templates(fractal).cpu().numpy().astype(np.float64)
    frame = root_frame(torch.zeros(3, device=device)).cpu().numpy()
    frame = frame.astype(np.float64)
    radius, centers = 1.0, []
    for _ in range(14):
        tm = templates[0].copy()
        tm[:, 3] *= (1.0 + 1.0 / 3.0) * radius
        frame = np.concatenate(
            [frame[:, :3] @ tm[:, :3],
             (frame[:, :3] @ tm[:, 3] + frame[:, 3])[:, None]],
            axis=1,
        )
        centers.append(frame[:, 3].copy())
        radius /= 3.0
    up = centers[-1] - centers[-3]
    up = up / np.linalg.norm(up)
    pos = centers[-1] + hover * up
    d = -up
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    return SceneParams(
        camera=CameraParams(
            position=f32(pos),
            yaw=f32(np.arcsin(np.clip(d[1], -1, 1))),
            pitch=f32(np.arctan2(-d[0], -d[2])),
            roll=f32(0.0),
            fov=f32(60.0),
        ),
        fractal=fractal,
        ssao=SSAOParams.reference_default(device),
    )


def kernel_inputs(scene, cfg):
    """(cam, pairs, starts, lens, n_pairs, overflow) of one frame, by
    the port's own front end."""
    from sphereflake_tpu_torch.models.sphereflake import (
        child_templates,
        root_frame,
    )
    from sphereflake_tpu_torch.ops.binned import binned_pairs, camera_vector

    root = root_frame(scene.camera.position)
    templates = child_templates(scene.fractal)
    pairs, starts, lens, (n_pairs, ovf) = binned_pairs(
        scene, cfg, root, templates
    )
    return camera_vector(scene, cfg), pairs, starts, lens, n_pairs, ovf


def compare_rows(torch, out_k, out_p, deep: bool):
    """Agreement of kernel rows with plain rows [T, C, 8, 128]."""
    n_code = 2 if deep else 1
    code_k, code_p = out_k[:, 1:1 + n_code], out_p[:, 1:1 + n_code]
    hit_k = (code_k >= 1.0).any(dim=1)
    hit_p = (code_p >= 1.0).any(dim=1)
    same_code = (code_k == code_p).all(dim=1)
    both = hit_k & hit_p & same_code
    rest = [0] + list(range(1 + n_code, out_k.shape[1]))
    diff = (out_k[:, rest] - out_p[:, rest]).abs()
    diff = torch.where(both[:, None], diff, torch.zeros_like(diff))
    return dict(
        rays=int(hit_k.numel()),
        hit_fraction=float(hit_k.float().mean()),
        hit_agree=float((hit_k == hit_p).float().mean()),
        code_agree=float(same_code.float().mean()),
        max_abs_err=float(diff.max()),
        max_abs_err_min_t=float(diff[:, 0].max()),
    )


def main(argv) -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one GPU")

    from sphereflake_tpu_torch import kernels
    from sphereflake_tpu_torch.cli import main as cli_main
    from sphereflake_tpu_torch.config import RenderConfig, default_scene
    from sphereflake_tpu_torch.ops import binned
    from sphereflake_tpu_torch.ops.binned import (
        trace_pairs_fused_plain,
        trace_pairs_fused_soa,
    )
    from sphereflake_tpu_torch.render import (
        _untile_rows,
        render_frame,
        render_gbuffer,
    )

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- phase 1: device and build --------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = kernels.build()
    build_s = time.perf_counter() - t0
    if "--ptxas" in argv:
        kernels.build(extra_flags=("-Xptxas", "-v"), verbose=True)
    emit(
        "device", card=card, torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0],
        build_seconds=round(build_s, 2), libraries=sorted(libs),
    )

    # ---- phase 2: kernels vs plain --------------------------------
    cfg = RenderConfig(
        width=WIDTH, height=HEIGHT, max_depth=DEPTH, tile_h=32, tile_w=32,
        algorithm="binned",
    )
    scene = default_scene(dev)
    with torch.no_grad():
        cam, pairs, starts, lens, n_pairs, ovf = kernel_inputs(scene, cfg)
        out_k, m_k = trace_pairs_fused_soa(cam, pairs, starts, lens, cfg)
        torch.cuda.synchronize()
        out_p, m_p = trace_pairs_fused_plain(cam, pairs, starts, lens, cfg)
        torch.cuda.synchronize()
    if not out_k.is_cuda or out_k.shape != (cfg.tiles_x * cfg.tiles_y, 8, 8, 128):
        fail(f"kernel output {tuple(out_k.shape)} on {out_k.device}")
    shallow = compare_rows(torch, out_k, out_p, deep=False)
    n_tiles = cfg.tiles_x * cfg.tiles_y
    lens_sum = int(lens.sum())
    emit(
        "kernel_vs_plain", kernel="pairs_kernel", variant="shallow",
        shape=dict(tiles=n_tiles, pair_cap=cfg.pair_cap,
                   pair_rows=int(pairs.shape[0]), n_pairs=int(n_pairs),
                   pairs_per_tile=round(lens_sum / n_tiles, 2),
                   max_segment=int(lens.max()), overflow=int(ovf)),
        metrics_equal=bool((m_k == m_p).all()),
        limits=dict(agree_min=AGREE_MIN, abs_err_max=ABS_ERR_MAX),
        **shallow,
    )
    if not bool((m_k == m_p).all()):
        fail("kernel metrics differ from the plain version's")
    if (min(shallow["hit_agree"], shallow["code_agree"]) < AGREE_MIN
            or shallow["max_abs_err"] > ABS_ERR_MAX):
        fail(f"pairs_kernel (shallow) disagrees with its plain version: {shallow}")

    dcfg = RenderConfig(
        width=256, height=128, max_depth=8, tile_h=32, tile_w=32,
        algorithm="binned", global_cap=1 << 15,
    )
    dscene = dive_scene(torch, dev)
    with torch.no_grad():
        dcam, dpairs, dstarts, dlens, dn, dovf = kernel_inputs(dscene, dcfg)
        dout_k, dm_k = trace_pairs_fused_soa(dcam, dpairs, dstarts, dlens, dcfg)
        torch.cuda.synchronize()
        dout_p, dm_p = trace_pairs_fused_plain(dcam, dpairs, dstarts, dlens, dcfg)
    deep = compare_rows(torch, dout_k, dout_p, deep=True)
    hi_hits = float((dout_k[:, 2] >= 1.0).float().mean())
    emit(
        "kernel_vs_plain", kernel="pairs_kernel", variant="deep",
        shape=dict(tiles=dcfg.tiles_x * dcfg.tiles_y, pair_cap=dcfg.pair_cap,
                   pair_rows=int(dpairs.shape[0]), n_pairs=int(dn),
                   max_segment=int(dlens.max())),
        hi_lane_hit_fraction=hi_hits,
        metrics_equal=bool((dm_k == dm_p).all()),
        limits=dict(agree_min=AGREE_MIN, abs_err_max=ABS_ERR_MAX),
        **deep,
    )
    if dout_k.shape[1] != 9 or hi_hits <= 0.0:
        fail("deep variant did not produce hi-lane hits")
    if (min(deep["hit_agree"], deep["code_agree"]) < AGREE_MIN
            or deep["max_abs_err"] > ABS_ERR_MAX
            or not bool((dm_k == dm_p).all())):
        fail(f"pairs_kernel (deep) disagrees with its plain version: {deep}")

    # ---- phase 3: the main path ------------------------------------
    def frame(i):
        camera = dataclasses.replace(
            scene.camera, yaw=scene.camera.yaw + 1e-7 * i
        )
        return render_frame(
            dataclasses.replace(scene, camera=camera), cfg, device=dev
        )

    trace_pairs_fused_soa.launches = 0
    # The README's first usage line, through the CLI: one warm-up frame
    # plus CLI_FRAMES timed ones, written to a PNG.
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "frame.png")
        rc = cli_main([
            "--width", str(WIDTH), "--height", str(HEIGHT), "--depth",
            str(DEPTH), "--frames", str(CLI_FRAMES), "-o", png,
        ])
        png_bytes = os.path.getsize(png) if os.path.exists(png) else 0
    # The same entry point the CLI calls, kept here to look at the result.
    frames = [frame(i) for i in range(FRAMES)]
    torch.cuda.synchronize()
    launches = trace_pairs_fused_soa.launches
    frames_rendered = FRAMES + CLI_FRAMES + 1
    if rc != 0 or png_bytes < 10000:
        fail(f"CLI run failed: rc={rc}, png of {png_bytes} bytes")
    image, gb = frames[-1]
    m = gb.metrics
    hit_fraction = float(gb.hit.float().mean())
    main_path = dict(
        frames=frames_rendered, launches=launches, cli_png_bytes=png_bytes,
        overflow=int(m.overflow), max_depth_reached=int(m.max_depth_reached),
        nodes_visited=int(m.nodes_visited),
        closest_distance=float(m.closest_distance),
        hit_fraction=hit_fraction,
        image_shape=list(image.shape), image_device=str(image.device),
        image_min=float(image.min()), image_max=float(image.max()),
        image_mean=float(image.mean()),
    )
    # The same frame with the plain version substituted for the kernel.
    kernel_wrapper = binned.trace_pairs_fused_soa
    binned.trace_pairs_fused_soa = trace_pairs_fused_plain
    try:
        gb_plain = render_gbuffer(scene, cfg, device=dev)
    finally:
        binned.trace_pairs_fused_soa = kernel_wrapper
    gb_kernel = render_gbuffer(scene, cfg, device=dev)
    hit_agree = float((gb_kernel.hit == gb_plain.hit).float().mean())
    both = gb_kernel.hit & gb_plain.hit
    close = torch.isclose(
        gb_kernel.min_t, gb_plain.min_t, rtol=1e-4, atol=1e-4
    )
    min_t_agree = float(close[both].float().mean())
    main_path.update(plain_hit_agree=hit_agree, plain_min_t_agree=min_t_agree)
    emit("main_path", **main_path)
    if launches != frames_rendered:
        fail(f"pairs_kernel launched {launches} times for "
             f"{frames_rendered} frames")
    if int(m.overflow) != 0 or int(m.max_depth_reached) != 5:
        fail(f"scene properties off: {main_path}")
    if not (image.is_cuda and gb.min_t.is_cuda
            and tuple(image.shape) == (HEIGHT, WIDTH, 3)):
        fail("outputs are not [1080, 1920, 3] tensors on the card")
    if not bool(torch.isfinite(image).all()) or float(image.max()) <= float(image.min()):
        fail("image is not finite or is constant")
    if not 0.05 < hit_fraction < 0.95:
        fail(f"hit fraction {hit_fraction} is implausible")
    if hit_agree < FRAME_HIT_MIN or min_t_agree < FRAME_HIT_MIN:
        fail(f"frame with the plain version disagrees: {hit_agree}, {min_t_agree}")

    # ---- phase 4: times --------------------------------------------
    from sphereflake_tpu_torch.camera import corner_rays, tile_frustum_planes
    from sphereflake_tpu_torch.models.sphereflake import (
        child_templates,
        root_frame,
    )
    from sphereflake_tpu_torch.ops.binned import (
        bin_nodes,
        corner_basis,
        expand_global,
    )
    from sphereflake_tpu_torch.ops.noise import ssao_noise_texture
    from sphereflake_tpu_torch.ops.post import postprocess

    counter = iter(range(1000, 100000))
    with torch.no_grad():
        frame_ms = event_ms(torch, lambda: frame(next(counter)), 5)
        gbuffer_ms = event_ms(
            torch, lambda: render_gbuffer(scene, cfg, device=dev), 5
        )
        root = root_frame(scene.camera.position)
        templates = child_templates(scene.fractal)
        planes = tile_frustum_planes(
            scene.camera, cfg.width, cfg.height, cfg.padded_height,
            cfg.padded_width, block_h=cfg.padded_height,
            block_w=cfg.padded_width,
        )[0]
        expand_ms = event_ms(
            torch,
            lambda: expand_global(root, templates, scene.fractal, cfg, planes),
            5,
        )
        nodes, _ = expand_global(root, templates, scene.fractal, cfg, planes)
        minv = corner_basis(scene.camera, cfg.width, cfg.height)
        origin, tl, tr, bl = corner_rays(scene.camera, cfg.width / cfg.height)
        corners = torch.stack([
            (tl - origin) + u * (tr - tl) + v * (bl - tl)
            for u in (0.0, cfg.padded_width / cfg.width)
            for v in (0.0, cfg.padded_height / cfg.height)
        ])
        bin_ms = event_ms(
            torch, lambda: bin_nodes(nodes, minv, cfg, corners=corners), 5
        )
        kernel_ms = event_ms(
            torch,
            lambda: trace_pairs_fused_soa(cam, pairs, starts, lens, cfg), 50,
        )
        plain_ms = event_ms(
            torch,
            lambda: trace_pairs_fused_plain(cam, pairs, starts, lens, cfg), 1,
        )
        rows7 = torch.cat([out_k[:, :1], out_k[:, 2:]], dim=1).contiguous()

        def untile():
            imgs = _untile_rows(rows7, cfg)
            return (torch.stack(imgs[1:4], dim=-1),
                    torch.stack(imgs[4:7], dim=-1), imgs[0] < 3.0e38)

        untile_ms = event_ms(torch, untile, 5)
        noise = torch.from_numpy(ssao_noise_texture(cfg.noise_size)).to(dev)
        post_ms = event_ms(
            torch,
            lambda: postprocess(
                gb.position, gb.normal, gb.metrics.closest_distance, scene,
                cfg, noise,
            ),
            5,
        )
        prof = profile_device(torch, lambda: frame(next(counter)), 3)
    if prof is not None:
        prof["idle_share"] = 1.0 - prof["busy_ms"] / frame_ms
    emit("device_profile", what="render_frame 1080p d6", **(prof or {
        "busy_ms": None, "note": "torch.profiler reported no device time"
    }))

    # The least time the card could take for the kernel's work on THIS
    # run's data: every input read once, every output written once; the
    # tests this pair table needs (sum of segment lengths x 1024 rays).
    bytes_moved = (
        out_k.numel() * 4 + m_k.numel() * 4            # outputs
        + lens_sum * pairs.shape[0] * 4                # pair columns in segments
        + starts.numel() * 4 + lens.numel() * 4 + cam.numel() * 4
    )
    ops = lens_sum * 1024 * OPS_PER_TEST + n_tiles * 1024 * OPS_PER_RAY
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    emit(
        "times", card=card, width=WIDTH, height=HEIGHT, depth=DEPTH,
        frame_ms=frame_ms, gbuffer_ms=gbuffer_ms,
        rays_per_second=WIDTH * HEIGHT / (frame_ms * 1e-3),
        stages_ms=dict(expand=expand_ms, bin=bin_ms, kernel=kernel_ms,
                       untile=untile_ms, post=post_ms),
        kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, bytes_ms=bytes_ms, ops_ms=ops_ms,
        bytes_moved=bytes_moved, operations=ops,
        launches_per_frame=launches / frames_rendered,
        node_slots=int(nodes["cx"].numel()),
        peak_memory_mb=torch.cuda.max_memory_allocated() / 2**20,
    )

    # ---- phase 5: the kernels line, the card, the verdict ----------
    print(json.dumps({"kernels": [{
        "name": "pairs_kernel",
        "route": "cuda",
        "source": "sphereflake_tpu_torch/csrc/pairs_kernel.cu",
        "replaces": "sphereflake_tpu/ops/binned.py:1064",
        "launches": launches,
        "max_abs_err": max(shallow["max_abs_err"], deep["max_abs_err"]),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
