#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on a GPU.

Run from the repository root on a machine with one NVIDIA Hopper card,
a CUDA toolkit (`nvcc`) and PyTorch built for CUDA:

    python3 chip_smoke.py            # all phases, two or three minutes
    python3 chip_smoke.py --ptxas    # also print registers / shared memory
                                     # and SASS branch / select counts

It drives the port's main paths at 1920x1080, depth 6 — `render_frame`
(the call `python -m sphereflake_tpu_torch` makes), the frameless
refresh (`--progressive`, `--animate --frameless`), the per-tile
traversal path (`--algorithm pallas`, full frame and sample unit), the
parity traversal (`--algorithm strict|loose`), the camera path
(`--animate`) and `--profile` — and
holds every hand-written kernel against its plain torch version on the
card. Phases, each printing one or more JSON lines:

1. device: card name and power limit, versions, kernel build seconds;
   then the post chain's kernels: SSAO, the horizontal blur and the
   vertical blur fused with the composite, each against its plain
   version on the same inputs, bit for bit, on the G-buffers of a 1080p
   depth-6 and a 4K depth-8 frame, on one 8192^2 block of a 16384^2
   depth-8 frame at (8192, 8192) and at `ssao_downscale` 2, with each
   pass's ms beside its byte bound and its plain version's ms; a
   1080p `render_frame` that launches the three and counts them; and
   the same frame with the SSAO uniforms requiring grad, which takes the
   plain passes (no launch) and gives the kernels' image bit for bit;
2. kernels vs plain: the pairs kernel in its three launch modes at the
   main paths' shapes — full grid (the 1080p depth-6 pair table), tile
   subset (`shade_only` and coded, on the trimmed table with the Sobol
   ids of step 0) and ray bundles (one 65,536-sample batch of
   `progressive_step`) — and their deep variants on a depth-8 dive pose;
   the full grid bit for bit, and the subset rows equal to the full-grid
   rows gathered at the ids; all three modes bit for bit on constructed
   spans (exact ties across work items, spans of one item and one pair
   more, empty, repeated ids); then the traversal kernel on the bundles
   of a 1080p depth-6 pallas frame, on the 64 Sobol bundles of a
   65,536-sample step, at a depth-7 dive, in a constructed overflow case,
   at wider frontiers, and on a constructed exact tie that straddles a
   work item's boundary (codes, hit masks, all 8 metrics and t equal bit
   for bit);
3. main paths, each with the launch counts set to 0 just before and read
   just after: the CLI's full-frame run to a PNG and a few
   `render_frame` calls with the camera moving (the same frame with the
   plain version substituted must agree); then the frameless path:
   trimmed prepare + 24 tile steps of 1,024 tiles, held against the full
   render, and the same through the CLI (`--progressive` both units,
   `--animate --frameless`); then the per-tile path: `render_frame`
   and the CLI with `--algorithm pallas` (one traversal launch per
   frame, none of the pair kernel; held against the binned frame), the
   CLI's sample unit on it, and the `fast` fallback once at 512x256
   depth 4 against `pallas`;
4. times (CUDA events): ms/frame and ms/step with their splits, kernels
   vs plain vs bound (each kernel timed queued behind a spin kernel, and
   at the host's pace); and `torch.profiler` views of one frame, one tile
   step and one sample step (device busy time, idle share, launches,
   top kernels); the pallas frame and its split, the traversal kernel's
   node and ray launches apart, the pallas sample step;
5. gradients and fitting: the 4K depth-8 fit of BASELINE config 4
   (target, 4 Adam steps from a perturbed yaw and radius ratio, one
   more step timed forward and backward; 4 bands, K1 launches counted
   per band), the 1080p depth-6 leaf gradients of the G-buffer loss on
   `binned` and `pallas` equal bit for bit with K1 / K4 replaced by
   their plain versions, and the 1080p gradient's time and profiler
   view;
6. the paths without a kernel of their own and what they launch: the
   parity traversal (`--algorithm strict`, plain torch) at 1080p depth
   6 up the capacity ladder, held against the port's golden tracer on a
   strided pixel subset and against the binned frame, timed, and
   rendered again with per-node gating (`loose`); the pallas-vs-strict
   gradient check (one traversal launch); the CLI's full-frame
   `--animate` (orbit, approach; one pair-kernel launch a render) and an
   approach from an all-sky pose, which must hold the camera; the
   CLI's `--profile`, whose trace must name the pair kernel's walk;
7. the reference's measurement programs: the headline bench
   (`python -m sphereflake_tpu_torch.bench`, in-process, with its gates
   and launches), large frames (4096^2 `lean_bands` == `render_gbuffer`
   bit for bit, 8192^2, 16384^2 at depths 6 and 8; warm times, peak
   memory) and the one-card scaling projection (both modes, loops cut);
8. the `kernels` line, the card line, and the final `ok` line.

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
import math
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
# The wrappers whose launches every main-path run counts, in this order.
KERNEL_NAMES = ("pairs_kernel", "pairs_kernel_subset", "pairs_kernel_dirs",
                "traverse_kernel")
# The fitting user's operating point (BASELINE config 4,
# tools/fit4k_probe.py:37-64): 4K, depth 8, auto-banded (4 bands).
FIT_WIDTH, FIT_HEIGHT, FIT_DEPTH, FIT_STEPS = 3840, 2160, 8, 4
# The backward's recompute of a band against K1's rows of that band: on
# the kernel's hits, min_t and position within these tolerances on at
# least RECOMPUTE_CLOSE_MIN of them (the CPU test's bar,
# tests/test_torch_grad.py::test_depth7_recompute_resolves_the_hi_lane).
# The normal, (p - c) / r, is printed and not gated: at level 5 a 1e-4
# relative t error is a good part of r (r = 3^-5), so it differs by up
# to ~0.2 where min_t agrees.
RECOMPUTE_RTOL, RECOMPUTE_ATOL, RECOMPUTE_CLOSE_MIN = 1e-4, 1e-5, 0.995
# The backward's kernel (`csrc/recompute_vjp.cu`) against its plain version
# on each band of the 4K fit: every gradient bit for bit (the plain version
# keeps the kernel's reduction order), within VJP_RTOL of the plain
# version's elementwise plus VJP_ATOL of its largest magnitude (the CPU
# test's bar against autograd, tests/test_torch_recompute_vjp.py), and every
# leaf gradient's sign equal where it is above that floor.
VJP_RTOL, VJP_ATOL = 1e-4, 1e-4
# Its f32 operations: per hit ray outside the levels (distance, shading and
# their backward, the root terms) and per level a ray takes (the frame step,
# u's and w's steps, the 13 terms added).
OPS_PER_VJP_RAY, OPS_PER_VJP_LEVEL = 150, 137
VJP_TIMED_REPS = 20
FRAMES = 3  # render_frame calls whose result is checked
CLI_FRAMES = 2  # timed frames of the CLI run (plus its warm-up frame)
# Kernel vs plain, on identical inputs, both without FMA contraction:
# codes and hit masks must agree on at least this fraction of rays, and
# min_t / position / normal on common hits within this absolute error.
AGREE_MIN = 0.9999
ABS_ERR_MAX = 1e-4
# Whole frame, kernel vs plain substituted (the stated main-path bar).
FRAME_HIT_MIN = 0.999
# The frameless operating point: 1,024 Sobol tiles per step on the
# trimmed pair table, 24 steps to full coverage, seed 1; the accumulated
# min_t plane must match the full render (rtol = atol = 1e-4) on at
# least FRAME_HIT_MIN of the pixels, and the composite over the fully
# covered buffer must match `render_frame`'s image within this.
TILES_PER_STEP = 1024
GATE_STEPS = 24
COMPOSITE_ERR_MAX = 1e-5
SAMPLE_BATCH = 65536
# Operations of one ray-sphere test without the code select, and per ray
# of the ray-bundle mode (no raygen, no shading: loads and stores only).
OPS_PER_TEST_SHADE_ONLY = OPS_PER_TEST - 1
OPS_PER_RAY_DIRS = 5
# The traversal kernel. One ray test against a queued node: 5 for the dot
# product, 2 for d2, 1 for c1, 5 for the LOD gate (compare, square,
# 4r^2 - d2, compare, or), 4 for ok (2 compares, 2 ands), 4 for ts
# (subtract, max, sqrt, subtract), 2 for the strict compare and its and,
# 2 selects (t, code).
OPS_PER_TRAVERSE_TEST = 25
# One child examined by the expansion: 18 for its centre (3 x (3 multiplies
# + 3 adds)), 5 for |c|^2, 1 LOD compare, 4 x 7 for the planes (3 multiplies,
# 2 adds, compare, and), 1 for the parent's validity, 2 for its code. (The
# 45 of a survivor's rotation are left out: most children are culled.)
OPS_PER_CHILD = 55
# The pallas frame against the binned frame of the same scene: the two
# paths cull and round differently at tangents, so hit masks agree on at
# least CROSS_HIT_MIN of the pixels. Their min_t differ where f32 gives
# out: t = tca - sqrt(r^2 - d2) with d2 = |c|^2 - tca^2 rounded to about
# 1e-5 at |c| = 8, against r^2 = 1.7e-5 at level 5 (the deepest level the
# LOD cut lets through at this pose) — the same winner, its sqrt term
# uncertain by a good part of its radius, on either path. So min_t must be
# within rtol = atol = 1e-4 on CROSS_T_CLOSE_MIN of the common hits (levels
# 0 to 4 hold 0.99 each, level 5 two thirds) and within one radius of the
# deepest level reached on CROSS_T_LEAF_MIN of them.
CROSS_HIT_MIN = 0.999
CROSS_T_CLOSE_MIN = 0.93
CROSS_T_LEAF_MIN = 0.98


# Cycles of the spin kernel that `event_ms(queued=True)` lines launches up
# behind: some 20 ms at the card's 1.7 to 2 GHz.
SPIN_CYCLES = 40_000_000


_T0 = time.perf_counter()


def emit(phase: str, **kw):
    """One JSON line; `t` = seconds since the script started."""
    t = round(time.perf_counter() - _T0, 1)
    print(json.dumps({"phase": phase, **kw, "t": t}), flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def event_ms(torch, fn, reps: int, queued: bool = False) -> float:
    """Mean milliseconds of `fn()` over `reps` runs, by CUDA events.
    With `queued` the runs wait behind a spin kernel (some 20 ms) while
    the host enqueues them all: the time is then the device's alone,
    also where one run is shorter than the host takes to enqueue it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_device(torch, fn, reps: int, cuda_only: bool = False):
    """Device-side view of `fn()` from `torch.profiler`: busy
    milliseconds and kernel launches per call, and the kernels that
    take most of the device time. None where the profiler reports no
    device time (then only the CUDA-event times stand). `cuda_only`
    records no host events: for a call of a few hundred thousand
    launches, whose host events would take the profiler longer to
    gather than the call takes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if not cuda_only:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
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


def bits_equal(torch, a, b) -> bool:
    """Two float tensors equal bit for bit (the sign of a zero too)."""
    return a.shape == b.shape and bool(torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    ))


def compare_shaded(torch, out_k, out_p):
    """Agreement of `shade_only` kernel rows with plain rows
    [K, 7, 8, 128] (min_t, pos3, nrm3): a hit is min_t < BIG / 2."""
    hit_k, hit_p = out_k[:, 0] < 1.5e38, out_p[:, 0] < 1.5e38
    both = hit_k & hit_p
    diff = (out_k - out_p).abs()
    diff = torch.where(both[:, None], diff, torch.zeros_like(diff))
    sky_equal = bool((out_k[:, 0][~hit_k] == out_p[:, 0][~hit_k]).all())
    return dict(
        rays=int(hit_k.numel()),
        hit_fraction=float(hit_k.float().mean()),
        hit_agree=float((hit_k == hit_p).float().mean()),
        code_agree=1.0 if sky_equal else 0.0,  # no codes: sky min_t instead
        max_abs_err=float(diff.max()),
        max_abs_err_min_t=float(diff[:, 0].max()),
    )


def check_agreement(what, result, metrics_equal=True):
    if (min(result["hit_agree"], result["code_agree"]) < AGREE_MIN
            or result["max_abs_err"] > ABS_ERR_MAX or not metrics_equal):
        fail(f"{what} disagrees with its plain version: {result}")


def record_launches(module, name, step):
    """Run `step()` and return the arguments of every call it made to
    the launch function `module.name`, by wrapping that function for
    the duration of the call."""
    calls = []
    launch = getattr(module, name)

    def recorder(*args):
        calls.append(args)
        return launch(*args)

    setattr(module, name, recorder)
    try:
        result = step()
    finally:
        setattr(module, name, launch)
    return result, calls


def record_bundles(binned, step):
    """The arguments of every ray-bundle kernel launch of `step()`
    (dirs_k, pairs, starts, lens, cfg)."""
    return record_launches(binned, "_launch_dirs_kernel", step)


def item_tables(torch, dev, item_pairs: int, deep: bool):
    """A constructed pair table for the item modes of the pair kernel
    (spans cut into items of `item_pairs` pairs): a 64x32 frame of two
    32x32 tiles, camera at the origin looking down -z, so that pixel
    column 32 (tile 1, column 0) has dx == 0 exactly. Two unit spheres
    mirrored about x = 0 sit, under different codes, at span positions
    whose k mod 8 runs against k across the items: 7 (-x, chain 7), 9
    (+x, chain 1), C + 2 (-x, chain 2), 2C + 8 (+x, chain 0: the winner
    on the tie column, in the third item) and 2C + 15 (-x, chain 7); the
    columns between hold seeded small spheres. Returns (cam, pairs, cfg,
    spans): `spans` maps a name to (starts, lens) of length 2 — the tie
    span on both tiles, spans of exactly C and C + 1, an empty span and
    a span of one pair."""
    import numpy as np

    from sphereflake_tpu_torch.config import RenderConfig

    C = item_pairs
    n_rows = 8 if deep else 7
    r_lodr, r_rc4 = (6, 7) if deep else (5, 6)
    first, span = 3, 2 * C + 16
    cap = first + span + 5
    rng = np.random.default_rng(C + deep)
    # Small spheres in front, none of them over the tie column (|x| >= 0.2).
    c = np.stack([rng.uniform(0.2, 1.2, cap) * rng.choice([-1.0, 1.0], cap),
                  rng.uniform(-0.6, 0.6, cap),
                  rng.uniform(-4.5, -3.0, cap)]).astype(np.float32)
    r = rng.uniform(0.02, 0.1, cap).astype(np.float32)
    for i, k in enumerate((7, 9, C + 2, 2 * C + 8, 2 * C + 15)):
        c[:, first + k] = (0.75 if i % 2 else -0.75, 0.0, -5.0)
        r[first + k] = 1.0
    cc = (c * c).sum(0, dtype=np.float32)
    pairs = np.zeros((n_rows, cap), np.float32)
    pairs[0:3] = c
    pairs[3] = r * r - cc
    pairs[4] = np.arange(1, cap + 1, dtype=np.float32)
    if deep:
        pairs[5] = np.arange(cap, 0, -1, dtype=np.float32)
    pairs[r_lodr] = np.float32(4900.0) * r
    pairs[r_rc4] = np.float32(4.0) * r * r - cc
    cam = np.asarray(
        [-1.0, 0.5, -1.0, 2.0, 0.0, 0.0, 0.0, -1.0, 0.0, 0.0, 0.0, 0.0,
         0.0, 0.0, 64.0, 32.0], np.float32,
    )
    cfg = RenderConfig(width=64, height=32, tile_h=32, tile_w=32,
                       algorithm="binned", max_depth=7 if deep else 3)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)
    spans = {
        "ties across items": (i32(first, first), i32(span, span)),
        "C and C + 1": (i32(5, C + 2), i32(C, C + 1)),
        "empty and one pair": (i32(10, first + 2 * C + 8), i32(0, 1)),
    }
    return (torch.from_numpy(cam).to(dev), torch.from_numpy(pairs).to(dev),
            cfg, spans)


def item_cases(torch, binned, dev):
    """Hold the three modes of the pair kernel against their plain
    versions on `item_tables`, bit for bit: every span (as the two
    tiles' segments) under the full grid, under the subset mode with ids
    that repeat and under the ray-bundle mode, shallow and deep. Returns
    one result per mode; any difference is listed in its `unequal`."""
    bits = lambda x: x.contiguous().view(torch.int32)
    C = binned.ITEM_PAIRS
    results = {m: dict(item_pairs=C, cases=0, unequal=[], tie_column_code=[])
               for m in ("pairs_kernel", "pairs_kernel_subset",
                         "pairs_kernel_dirs")}
    ids = torch.tensor([1, 0, 1, 1, 0], dtype=torch.int32, device=dev)
    # A copy's code is its column's number + 1 (first = 3). On the tie
    # column (row 0 is tile 1; its pixel column 0) the +x copy at 2C + 8
    # must be the only copy that wins.
    copy_codes = {float(3 + k + 1) for k in (7, 9, C + 2, 2 * C + 8, 2 * C + 15)}
    winner_code = float(3 + 2 * C + 8 + 1)

    def tie_column_codes(rows, tile_row=0):
        col = rows[tile_row, 1].reshape(32, 32)[:, 0]
        return sorted(copy_codes & set(col.tolist()))

    for deep in (False, True):
        cam, pairs, cfg, spans = item_tables(torch, dev, C, deep)
        dx, dy, dz = binned._tile_raygen(cam, ids, cfg)
        dirs_k = torch.stack([dx, dy, dz], dim=1).reshape(-1, 3, 8, 128)
        for name, (starts, lens) in spans.items():
            label = f"{name}{', deep' if deep else ''}"
            got, got_m = binned.trace_pairs_fused_soa(cam, pairs, starts, lens,
                                                      cfg)
            torch.cuda.synchronize()
            want, want_m = binned.trace_pairs_fused_plain(cam, pairs, starts,
                                                          lens, cfg)
            res = results["pairs_kernel"]
            res["cases"] += 1
            if not (torch.equal(bits(got), bits(want))
                    and torch.equal(got_m, want_m)):
                res["unequal"].append(label)
            if name == "ties across items":
                res["tie_column_code"].append(tie_column_codes(got, 1))
            for shade_only in (True, False):
                args = (cam, pairs, starts, lens, ids, cfg)
                got, got_m = binned.trace_pairs_fused_subset(
                    *args, shade_only=shade_only)
                torch.cuda.synchronize()
                want, want_m = binned.trace_pairs_fused_subset_plain(
                    *args, shade_only=shade_only)
                res = results["pairs_kernel_subset"]
                res["cases"] += 1
                if not (torch.equal(bits(got), bits(want))
                        and torch.equal(got_m, want_m)):
                    res["unequal"].append(
                        f"{label}, {'shade_only' if shade_only else 'coded'}")
                if name == "ties across items" and not shade_only:
                    res["tie_column_code"].append(tie_column_codes(got))
            b_starts, b_lens = starts[ids.long()], lens[ids.long()]
            got, got_m = binned.trace_pairs_pallas_soa(
                dirs_k, pairs, b_starts.contiguous(), b_lens.contiguous(), cfg)
            torch.cuda.synchronize()
            want, want_m = binned.trace_pairs_pallas_soa_plain(
                dirs_k, pairs, b_starts, b_lens, cfg)
            res = results["pairs_kernel_dirs"]
            res["cases"] += 1
            if not (torch.equal(bits(got), bits(want))
                    and torch.equal(got_m, want_m)):
                res["unequal"].append(label)
            if name == "ties across items":
                res["tie_column_code"].append(tie_column_codes(got))
    for res in results.values():
        res["tie_winner_code"] = winner_code
        if any(codes != [winner_code] for codes in res["tie_column_code"]):
            res["unequal"].append("tie column: wrong winner")
    return results


def straddle_inputs(torch, dev):
    """The traversal kernel's arguments for one all-pass depth-2 bundle
    (identity rotations) whose nine level-1 nodes all survive, so that
    level-2 node (j, p) sits at queue position 10 + 9j + p: (5, 8) at 63
    and (6, 0) at 64, in two work items of 64. The two are mirrored in
    the plane x = 0 that holds every ray and every other node lies out
    of the rays' way, so wherever a ray hits one it hits the other at
    exactly the same t: the first in queue order, code 9 * (9 + 8) + 5 =
    158, must win over code 9 * 9 + 6 = 87."""
    import numpy as np

    from sphereflake_tpu_torch.config import FractalParams, RenderConfig

    templates = np.zeros((9, 3, 4), np.float32)
    templates[:, :, :3] = np.eye(3, dtype=np.float32)
    for j in range(9):
        templates[j, :, 3] = (0.1 * (j - 5), -0.9, 0.0)
    templates[0, :, 3], templates[8, :, 3] = (0.3, 0.9, 0.0), (-0.3, 0.9, 0.0)
    templates[6, :, 3], templates[5, :, 3] = (-0.8, 0.9, 0.0), (0.8, 0.9, 0.0)
    root = np.zeros((3, 4), np.float32)
    root[:, :3] = np.eye(3, dtype=np.float32)
    root[:, 3] = (0.0, 0.0, -5.0)
    y = np.linspace(1.45, 1.75, 1024, dtype=np.float32)
    d = np.stack([np.zeros_like(y), y, np.full_like(y, -5.0)])
    d = (d / np.sqrt((d * d).sum(axis=0, keepdims=True))).astype(np.float32)
    on = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    cfg = RenderConfig(width=32, height=32, max_depth=2, max_frontier=128,
                       tile_h=32, tile_w=32, algorithm="pallas")
    return (on(d.reshape(1, 3, 8, 128)), on(np.zeros((1, 4, 3), np.float32)),
            on(root), on(templates), FractalParams.reference_default(dev),
            cfg)


def item_stats(lens, item_pairs: int):
    """How a launch's spans cut into work items of `item_pairs` pairs:
    an empty span is one item."""
    n = ((lens + item_pairs - 1) // item_pairs).clamp(min=1)
    return dict(
        item_pairs=item_pairs, items=int(n.sum()),
        longest_item=int(lens.clamp(max=item_pairs).max()),
        rows=int(lens.numel()), rows_of_one_item=int((n == 1).sum()),
        most_items_in_a_row=int(n.max()),
    )


def walk_demand(torch, dx, dy, dz, pairs, row_start, row_len):
    """What a launch's data asks of the item walk (shallow table),
    counted in plain ops: of the (warp, pair) tests — a warp is 16 x 8
    pixels of a tile, or the 128 rays of a bundle in that layout — the
    share in which some ray has disc >= 0, so that the warp goes past
    the early out to the LOD gate and the square root; and of the (ray,
    pair) tests the share that passes `ok`."""
    n_rows, n_cols = dx.shape[0], pairs.shape[1]
    starts_l = row_start.long()
    warp_pass = torch.zeros((), dtype=torch.int64, device=dx.device)
    ray_ok = torch.zeros_like(warp_pass)
    for k in range(int(row_len.max())):
        cols = pairs[:, torch.clamp_max(starts_l + k, n_cols - 1)]
        tca = dx * cols[0][:, None] + dy * cols[1][:, None] + dz * cols[2][:, None]
        t2 = tca * tca
        reach = (k < row_len)[:, None] & (t2 + cols[3][:, None] >= 0.0)
        c1p = torch.clamp_min(tca - cols[5][:, None], 0.0)
        ray_ok += (reach & (tca >= 0.0)
                   & (c1p * c1p < t2 + cols[6][:, None])).sum()
        warp_pass += reach.reshape(n_rows, 4, 8, 2, 16).any(4).any(2).sum()
    walked = int(row_len.sum())
    return dict(warp_pass_share=int(warp_pass) / (8 * walked),
                ray_ok_share=int(ray_ok) / (1024 * walked))


def queue_demand(torch, ptrav, dirs, pool, metrics, level_tab, cfg):
    """What a traversal launch's data asks of its ray launch, counted in
    plain ops on the node launch's own queues: of the (warp, node) tests
    — a warp is 16 x 8 rays of a bundle, as in `walk_demand` — the share
    in which some ray has d2 <= r^2, so that the warp goes past the early
    out to the LOD gate and the square root."""
    n = dirs.shape[0]
    q_rows = pool.reshape(n, 5, -1)
    qlen = metrics[:, 0, 0].long()
    d = dirs.reshape(n, 3, 1024)
    warp_pass = torch.zeros((), dtype=torch.int64, device=dirs.device)
    for q in range(int(qlen.max())):
        cx, cy, cz, cc, code = (q_rows[:, r, q, None] for r in range(5))
        queued = (q < qlen)[:, None]
        # Past a bundle's queue the pool holds whatever the allocator left
        # there: its code must not index the level table.
        code = torch.where(queued, code, torch.zeros_like(code))
        r2 = level_tab[1][ptrav._code_level(code)]
        tca = d[:, 0] * cx + d[:, 1] * cy + d[:, 2] * cz
        reach = queued & (cc - tca * tca <= r2)
        warp_pass += reach.reshape(n, 4, 8, 2, 16).any(4).any(2).sum()
    return dict(warp_pass_share=int(warp_pass) / (8 * int(qlen.sum())))


def compare_traversal(torch, out_k, m_k, out_p, m_p):
    """Agreement of traversal-kernel outputs [T, 2, 8, 128] (t, code)
    and metrics [T, 1, 8] with the plain version's."""
    code_k, code_p = out_k[:, 1], out_p[:, 1]
    hit_k, hit_p = code_k >= 1.0, code_p >= 1.0
    diff = (out_k[:, 0] - out_p[:, 0]).abs()
    diff = torch.where(hit_k & hit_p, diff, torch.zeros_like(diff))
    m = m_k[:, 0].long()
    return dict(
        rays=int(hit_k.numel()),
        hit_fraction=float(hit_k.float().mean()),
        hit_equal=bool(torch.equal(hit_k, hit_p)),
        codes_equal=bool(torch.equal(code_k, code_p)),
        metrics_equal=bool(torch.equal(m_k, m_p)),
        miss_t_equal=bool(torch.equal(out_k[:, 0][~hit_k], out_p[:, 0][~hit_k])),
        t_bits_equal=bits_equal(torch, out_k[:, 0], out_p[:, 0]),
        max_abs_err=float(diff.max()),
        queue_nodes=int(m[:, 0].sum()), longest_queue=int(m[:, 0].max()),
        overflow=int(m[:, 1].sum()), deepest_level=int(m[:, 2].max()),
        last_level_live=int(m[:, 3].sum()),
    )


def sass_summary(lib: str, nvcc: str):
    """Instruction counts of every kernel in a built library, from
    `cuobjdump -sass`: all, branches, selects, shared-memory loads
    (how the compiler treated the loop's conditional update)."""
    import re
    from collections import Counter

    exe = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    text = subprocess.run(
        [exe, "-sass", lib], capture_output=True, text=True, check=True
    ).stdout
    out = {}
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        name = fn.split("\n")[0].strip()
        args = re.search(r"ILi(\d)ELb(\d)ELb(\d)E", name)
        if args:
            name = "mode={} deep={} shade_only={}".format(*args.groups())
        ops = Counter(
            m.group(1).split(".")[0] for m in re.finditer(
                r"^\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_.]+)",
                fn, re.M,
            )
        )
        out[name] = dict(
            total=sum(ops.values()), BRA=ops["BRA"],
            SEL=ops["SEL"] + ops["FSEL"], LDS=ops["LDS"],
        )
    return out


def bound(bytes_moved, ops):
    """(bound_ms, bound_by, bytes_ms, ops_ms) of work that moves
    `bytes_moved` bytes and does `ops` f32 operations."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOP_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", bytes_ms, ops_ms)


def detached_call(torch, fn):
    """`fn` with every tensor argument (and every leaf of a dataclass
    argument) detached, as the launch wrappers detach theirs."""
    def call(*args):
        def detach(x):
            if isinstance(x, torch.Tensor):
                return x.detach()
            if dataclasses.is_dataclass(x) and not isinstance(x, type):
                return dataclasses.replace(x, **{
                    f.name: detach(getattr(x, f.name))
                    for f in dataclasses.fields(x)
                })
            return x
        return fn(*(detach(a) for a in args))
    return call


def leaf_grads(torch, scene, cfg, target, dev):
    """(loss, leaf gradients) of the G-buffer loss against `target`'s
    planes: one forward with the graph, one backward."""
    from sphereflake_tpu_torch.config import SceneParams
    from sphereflake_tpu_torch.fit import gbuffer_loss

    leaves = [x.detach().clone().requires_grad_(True) for x in scene.leaves()]
    loss = gbuffer_loss(SceneParams.from_leaves(leaves), target.position,
                        target.normal, cfg, device=dev)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), list(grads)


def perturbed(scene, dyaw, dratio=0.0):
    return dataclasses.replace(
        scene,
        camera=dataclasses.replace(scene.camera, yaw=scene.camera.yaw + dyaw),
        fractal=dataclasses.replace(
            scene.fractal, radius_ratio=scene.fractal.radius_ratio + dratio
        ),
    )


def band_vs_plain(torch, scene, cfg, band: int = -1):
    """K1 against its plain version on band `band` of cfg's banded frame,
    as `render.band_layout` cuts it (the last band by default: the
    largest y offset), on the port's own front end for that band
    (`band_fronts` of its offset alone): rows and metrics bit for bit,
    the rows' agreement and the band's shape."""
    from sphereflake_tpu_torch.ops import binned
    from sphereflake_tpu_torch.render import band_layout

    bcfg, offsets = band_layout(cfg, (cfg.width, cfg.height, 0.0, 0.0))
    frame = (cfg.width, cfg.height, 0.0, offsets[band])
    with torch.no_grad():
        (pairs, starts, lens, (n_pairs, ovf), cam), = binned.band_fronts(
            scene, bcfg, cfg.width, cfg.height, 0.0, [offsets[band]])
        out_k, m_k = binned.trace_pairs_fused_soa(cam, pairs, starts, lens,
                                                  bcfg)
        torch.cuda.synchronize()
        out_p, m_p = binned.trace_pairs_fused_plain(cam, pairs, starts, lens,
                                                    bcfg)
    result = compare_rows(torch, out_k, out_p, deep=bcfg.max_depth >= 7)
    result.update(
        bits_equal=bits_equal(torch, out_k, out_p),
        metrics_equal=bool(torch.equal(m_k, m_p)),
        rows=int(out_k.shape[1]),
        shape=dict(tiles=int(out_k.shape[0]), frame_width=cfg.width,
                   frame_height=cfg.height, depth=cfg.max_depth,
                   band=band % len(offsets), bands=len(offsets),
                   y_off=frame[3], camera_offsets=cam[12:14].tolist(),
                   pair_rows=int(pairs.shape[0]), n_pairs=int(n_pairs),
                   max_segment=int(lens.max()), overflow=int(ovf)),
    )
    return result


def band_checks(torch, scene, cfg):
    """The banded frame of `cfg` band by band, as `render.band_layout`
    cuts it: K1 against its plain version on the last band (the largest
    y offset), and on every band the backward's recompute
    (`_gbuffer_recompute`, fed K1's codes) against K1's own rows: the
    same hits, and min_t and position close on the hits (the normal is
    reported).
    Returns (K1 vs plain of the last band, per-band recompute stats)."""
    from sphereflake_tpu_torch.ops import binned
    from sphereflake_tpu_torch.render import band_layout

    bcfg, offsets = band_layout(cfg, (cfg.width, cfg.height, 0.0, 0.0))
    fronts = binned.band_fronts(scene, bcfg, cfg.width, cfg.height, 0.0,
                                offsets)
    per_band = []
    with torch.no_grad():
        for y_off, band_front in zip(offsets, fronts):
            offs = (0.0, y_off)
            outs = binned._gbuffer_primal(bcfg, band_front)
            rec = binned._gbuffer_recompute(bcfg, cfg.width, cfg.height,
                                            scene, offs, outs[8], outs[9])
            hit = outs[7] > 0.0
            close = [torch.isclose(a, k, rtol=RECOMPUTE_RTOL,
                                   atol=RECOMPUTE_ATOL)[hit]
                     for a, k in zip(rec, outs[:7])]
            per_band.append(dict(
                y_off=offs[1], rays=int(hit.numel()), hits=int(hit.sum()),
                sky_equal=bool((rec[0][~hit] >= 1.5e38).all()),
                min_t_close=float(close[0].float().mean()),
                position_close=float(
                    torch.stack(close[1:4]).all(dim=0).float().mean()),
                normal_close=float(
                    torch.stack(close[4:7]).all(dim=0).float().mean()),
                max_abs_err_position=float(max(
                    (a - k).abs()[hit].max() for a, k in zip(rec[1:4], outs[1:4])
                )),
                max_abs_err_normal=float(max(
                    (a - k).abs()[hit].max() for a, k in zip(rec[4:7], outs[4:7])
                )),
            ))
    return band_vs_plain(torch, scene, cfg), per_band


def vjp_band_checks(torch, scene, cfg):
    """The backward's kernel (`ops/recompute_vjp.py`) on every band of
    cfg's banded frame, at K1's codes: its forward mode against the plain
    chain (`_shade_codes`) bit for bit, its gradients under seeded
    upstream gradients against the plain version bit for bit (and within
    VJP_RTOL, VJP_ATOL), every leaf gradient's sign, two calls bit for
    bit, its time queued behind the spin kernel, its bound and its
    launches. Emits one `kernel_vs_plain` line a band; returns the last
    band's numbers for the `kernels` line."""
    from sphereflake_tpu_torch.config import SceneParams
    from sphereflake_tpu_torch.models.sphereflake import (
        child_templates,
        root_frame,
    )
    from sphereflake_tpu_torch.ops import binned
    from sphereflake_tpu_torch.ops import recompute_vjp as rv
    from sphereflake_tpu_torch.render import band_layout

    bcfg, offsets = band_layout(cfg, (cfg.width, cfg.height, 0.0, 0.0))
    depth = bcfg.max_depth
    names = ("dx", "dy", "dz", "root", "templates", "ratio", "radius0",
             "rhit")
    fronts = binned.band_fronts(scene, bcfg, cfg.width, cfg.height, 0.0,
                                offsets)
    last = None
    for b, y_off in enumerate(offsets):
        offs = (0.0, y_off)
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in scene.leaves()]
        s = SceneParams.from_leaves(leaves)
        with torch.no_grad():
            outs = binned._gbuffer_primal(bcfg, fronts[b])
        lo, hi = outs[8], outs[9]
        front = (*binned._band_rays(bcfg, cfg.width, cfg.height, s, offs),
                 root_frame(s.camera.position), child_templates(s.fractal),
                 s.fractal.radius_ratio, s.fractal.root_radius,
                 rv.level_radii(s.fractal, depth))
        x = [f.detach() for f in front]
        n = lo.shape[0]
        gen = torch.Generator(device=lo.device).manual_seed(17 + b)
        grads = [torch.rand(n, generator=gen, device=lo.device) - 0.5
                 for _ in range(7)]
        with torch.no_grad():
            fk = rv.recompute_forward(*x[:3], lo, hi, x[3], x[4], s.fractal,
                                      bcfg)
            fp = torch.stack(binned._shade_codes(*x[:3], lo, hi, x[3], x[4],
                                                 s.fractal, bcfg))
        args = (*x[:3], lo, hi, grads, *x[3:])
        before = rv.recompute_vjp.launches
        gk = rv.recompute_vjp(*args, depth=depth)
        gk2 = rv.recompute_vjp(*args, depth=depth)
        launches = rv.recompute_vjp.launches - before
        torch.cuda.synchronize()
        gp = rv.recompute_vjp_plain(*args, depth=depth)
        close = {
            name: bool(torch.allclose(a, p, rtol=VJP_RTOL,
                                      atol=VJP_ATOL * float(p.abs().max())))
            for name, a, p in zip(names, gk, gp)
        }
        rel_err = {
            name: float((a - p).abs().max()) / max(float(p.abs().max()),
                                                   1e-30)
            for name, a, p in zip(names, gk, gp)
        }
        leaf_k = torch.autograd.grad(front, leaves, gk, retain_graph=True,
                                     allow_unused=True)
        leaf_p = torch.autograd.grad(front, leaves, gp, allow_unused=True)
        signs = []
        for a, p in zip(leaf_k, leaf_p):
            if p is None:
                signs.append(a is None)
                continue
            floor = VJP_ATOL * float(p.abs().max())
            signs.append(bool(((torch.sign(a) == torch.sign(p))
                               | (p.abs() <= floor)).all()))
        level, _digits = rv._decode(lo, hi, depth)
        hit = outs[7] > 0.0
        hits, taken = int(hit.sum()), int(level[hit].sum())
        bytes_moved = n * (5 + 3) * 4 + hits * 7 * 4
        ops = hits * OPS_PER_VJP_RAY + taken * OPS_PER_VJP_LEVEL
        bound_ms, bound_by, bytes_ms, ops_ms = bound(bytes_moved, ops)
        ms = event_ms(torch, lambda: rv.recompute_vjp(*args, depth=depth),
                      VJP_TIMED_REPS, queued=True)
        result = dict(
            rays=n, hits=hits, levels_taken=taken, depth=depth,
            forward_bits_equal=bool(torch.equal(fk, fp)),
            forward_mismatches=int((fk != fp).sum()),
            bits_equal=all(bits_equal(torch, a, p) for a, p in zip(gk, gp)),
            repeat_bits_equal=all(bits_equal(torch, a, c)
                                  for a, c in zip(gk, gk2)),
            close=close, max_rel_err=rel_err, leaf_signs_equal=signs,
            max_abs_err=max(float((a - p).abs().max()) for a, p in zip(gk, gp)),
            ms=ms, bound_ms=bound_ms, bound_by=bound_by, bytes_ms=bytes_ms,
            ops_ms=ops_ms, share_of_bound=bound_ms / ms, launches=launches,
        )
        if b == len(offsets) - 1:
            result["plain_ms"] = event_ms(
                torch, lambda: rv.recompute_vjp_plain(*args, depth=depth), 1)
        emit("kernel_vs_plain", kernel="recompute_vjp",
             variant=f"4K band {b} of {len(offsets)}",
             limits=dict(rtol=VJP_RTOL, atol=VJP_ATOL), **result)
        if not (result["forward_bits_equal"] and result["bits_equal"]
                and all(close.values()) and all(signs)
                and result["repeat_bits_equal"] and launches == 2):
            fail(f"recompute_vjp (4K band {b}) disagrees with its plain "
                 f"version: {result}")
        last = result
    return last


def gradient_phase(torch, dev, scene, cfg, card, reset_counts, read_counts):
    """The trainer side: the 4K depth-8 fit (`fit_path`), the leaf
    gradients with each kernel and with its plain version (bit for bit,
    `grad_vs_plain`), and the 1080p gradient's time (`grad_times`).
    Returns the pair and traversal kernels' launches on these paths."""
    from sphereflake_tpu_torch.config import RenderConfig
    from sphereflake_tpu_torch.fit import fit, gbuffer_loss
    from sphereflake_tpu_torch.ops import binned
    from sphereflake_tpu_torch.ops import pallas_traversal as ptrav
    from sphereflake_tpu_torch.ops.recompute_vjp import recompute_vjp
    from sphereflake_tpu_torch.render import render_gbuffer

    # -- fit_path: config 4 at full width (tools/fit4k_probe.py:37-64) --
    fcfg = RenderConfig(width=FIT_WIDTH, height=FIT_HEIGHT,
                        max_depth=FIT_DEPTH, tile_h=32, tile_w=32,
                        algorithm="binned")
    bands = fcfg.tiles_y // fcfg.effective_band_rows
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()
    reset_counts()
    with torch.no_grad():
        target = render_gbuffer(scene, fcfg, device=dev)
    target_counts = read_counts()
    overflow = int(target.metrics.overflow)
    depth_reached = int(target.metrics.max_depth_reached)
    start = perturbed(scene, 0.004, 0.004)
    reset_counts()
    t0 = time.perf_counter()
    res = fit(start, target.position, target.normal, fcfg, steps=FIT_STEPS,
              learning_rate=2e-3, device=dev)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = read_counts()
    fit_vjp = recompute_vjp.launches
    # One more step from the same start, timed apart (CUDA events): its
    # gradients are the fit's step-0 gradients.
    reset_counts()
    from sphereflake_tpu_torch.config import SceneParams

    leaves = [x.detach().clone().requires_grad_(True) for x in start.leaves()]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    loss0 = gbuffer_loss(SceneParams.from_leaves(leaves), target.position,
                         target.normal, fcfg, device=dev)
    ev[1].record()
    grads0 = torch.autograd.grad(loss0, leaves, allow_unused=True)
    ev[2].record()
    torch.cuda.synchronize()
    split_counts = read_counts()
    split_vjp = recompute_vjp.launches
    peak_mib = (torch.cuda.max_memory_allocated() - mem_before) / 2**20
    finite = all(bool(torch.isfinite(g).all()) for g in grads0 if g is not None)
    finite = finite and all(math.isfinite(v) for v in res.losses)
    fit_path = dict(
        width=FIT_WIDTH, height=FIT_HEIGHT, depth=FIT_DEPTH, bands=bands,
        band_tile_rows=fcfg.effective_band_rows, overflow=overflow,
        max_depth_reached=depth_reached, steps=FIT_STEPS, losses=res.losses,
        step_ms=fit_s * 1e3 / FIT_STEPS,
        split_step_ms=dict(forward=ev[0].elapsed_time(ev[1]),
                           backward=ev[1].elapsed_time(ev[2])),
        step0_grad=dict(yaw=float(grads0[1]), radius_ratio=float(grads0[5])),
        grads_finite=finite,
        pairs_kernel_launches=dict(target=target_counts[0],
                                   fit=fit_counts[0],
                                   timed_step=split_counts[0]),
        recompute_vjp_launches=dict(fit=fit_vjp, timed_step=split_vjp),
        peak_memory_mib=peak_mib,
        peak_memory_process_mib=torch.cuda.max_memory_allocated() / 2**20,
        card=card,
    )
    emit("fit_path", **fit_path)
    counts_ok = (
        target_counts == [bands, 0, 0, 0]
        and fit_counts == [bands * FIT_STEPS, 0, 0, 0]
        and split_counts == [bands, 0, 0, 0]
        and fit_vjp == bands * FIT_STEPS and split_vjp == bands
    )
    if overflow != 0 or not finite or not counts_ok:
        fail(f"the 4K depth-8 fit went wrong: {fit_path}")
    if not min(res.losses) < res.losses[0]:
        fail(f"the 4K depth-8 fit does not descend: {res.losses}")
    del target, res, leaves, grads0, loss0

    # -- the fit's bands, at its step-0 scene: deep K1 vs plain on the
    # last band, the backward's recompute vs K1 on every band ----------
    last, per_band = band_checks(torch, start, fcfg)
    emit("kernel_vs_plain", kernel="pairs_kernel",
         variant=f"deep, 4K band {bands - 1} of {bands}",
         limits=dict(agree_min=AGREE_MIN, abs_err_max=ABS_ERR_MAX), **last)
    if (last["rows"] != 9 or not last["bits_equal"]
            or not last["metrics_equal"]):
        fail(f"pairs_kernel (deep, 4K band) disagrees with its plain "
             f"version: {last}")
    check_agreement("pairs_kernel (deep, 4K band)", last)
    emit("fit_bands_recompute", bands=per_band,
         limits=dict(rtol=RECOMPUTE_RTOL, atol=RECOMPUTE_ATOL,
                     close_min=RECOMPUTE_CLOSE_MIN))
    for b, band in enumerate(per_band):
        if not band["sky_equal"] or min(
            band["min_t_close"], band["position_close"]
        ) < RECOMPUTE_CLOSE_MIN:
            fail(f"the recompute of 4K band {b} departs from the kernel's "
                 f"rows: {band}")

    vjp = vjp_band_checks(torch, start, fcfg)

    # -- grad_vs_plain: 1080p depth 6, kernel vs its plain version ------
    pcfg = dataclasses.replace(cfg, algorithm="pallas")
    path_launches = [0, 0]
    gtarget = None
    for alg, c, module, name, plain, slot in (
        ("binned", cfg, binned, "trace_pairs_fused_soa",
         binned.trace_pairs_fused_plain, 0),
        ("pallas", pcfg, ptrav, "trace_tiles_pallas_soa",
         ptrav.trace_tiles_pallas_soa_plain, 3),
    ):
        with torch.no_grad():
            tgt = render_gbuffer(perturbed(scene, 0.004), c, device=dev)
        if alg == "binned":
            gtarget = tgt
        reset_counts()
        loss_k, g_k = leaf_grads(torch, scene, c, tgt, dev)
        counts = read_counts()
        wrapper = getattr(module, name)
        setattr(module, name, detached_call(torch, plain))
        try:
            loss_p, g_p = leaf_grads(torch, scene, c, tgt, dev)
        finally:
            setattr(module, name, wrapper)
        equal = [
            (a is None and b is None)
            or (a is not None and b is not None and torch.equal(a, b))
            for a, b in zip(g_k, g_p)
        ]
        expected = [0, 0, 0, 0]
        expected[slot] = 1
        emit("grad_vs_plain", algorithm=alg, kernel=name,
             width=c.width, height=c.height, depth=c.max_depth,
             loss=float(loss_k), loss_plain=float(loss_p),
             loss_bits_equal=bool(torch.equal(loss_k, loss_p)),
             leaves_bits_equal=all(equal), leaves_equal=equal,
             launches=counts,
             yaw_grad=float(g_k[1]), radius_ratio_grad=float(g_k[5]))
        if not all(equal) or counts != expected:
            fail(f"{alg} gradients differ with the plain version or "
                 f"launched {counts}")
        if not all(torch.isfinite(g).all() for g in g_k if g is not None):
            fail(f"{alg} gradients are not finite")
        path_launches[0 if slot == 0 else 1] += 1

    # -- grad_times: 1080p depth 6 binned ------------------------------
    def grad_step():
        leaf_grads(torch, scene, cfg, gtarget, dev)

    def forward_only():
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in scene.leaves()]
        return gbuffer_loss(SceneParams.from_leaves(leaves),
                            gtarget.position, gtarget.normal, cfg, device=dev)

    grad_step()
    grad_ms = event_ms(torch, grad_step, 5)
    forward_ms = event_ms(torch, forward_only, 5)
    prof = profile_device(torch, grad_step, 3)
    emit(
        "grad_times", card=card, width=cfg.width, height=cfg.height,
        depth=cfg.max_depth, algorithm="binned", grad_ms=grad_ms,
        split_ms=dict(forward=forward_ms, backward=grad_ms - forward_ms),
        device_profile=(dict(
            **prof, idle_share=1.0 - prof["busy_ms"] / grad_ms
        ) if prof else "profiler reported no device time"),
        peak_memory_mb=torch.cuda.max_memory_allocated() / 2**20,
    )
    return dict(
        fit_pairs_kernel=target_counts[0] + fit_counts[0] + split_counts[0],
        fit_recompute_vjp=fit_vjp + split_vjp,
        pairs_kernel=path_launches[0], traverse_kernel=path_launches[1],
        vjp=vjp,
    )


# ---- the parity traversal, the camera path, the profiler -----------
# The strict frame: 1080p depth 6 at the reference pose in 24x32 tiles
# (a per-tile XLA path needs a tile that divides the frame; neither its
# default 64x128 nor 32x32 divides 1080), 16 tiles a batch, from
# max_frontier 1024 up the capacity ladder until nothing overflows.
STRICT_TILE = (24, 32)
STRICT_TILE_BATCH = 16
STRICT_START_FRONTIER = 1024
STRICT_MAX_RUNGS = 4
STRICT_TIMED_FRAMES = 1
# The port's golden tracer (float64, per ray) on every 17th row and
# column of the strict frame (7,232 rays at 1080p): hit masks agree on
# at least GOLDEN_HIT_MIN of the pixels; on the common hits t is within
# atol + rtol |t| on at least GOLDEN_T_CLOSE_MIN of them, with a median
# error below GOLDEN_T_MEDIAN_MAX. These are the reference's own
# tolerances (tests/test_traversal.py:13-50) but not its fractions (0.998
# and 0.99, for depth <= 4): at depth 6, f32 cannot resolve a level-5
# silhouette (r^2 = 1.7e-5 against ulp(|c|^2 ~ 64) = 7.6e-6), and on
# these pixels the reference's own strict path reaches 0.9971 and 0.9525
# (tests/test_torch_strict.py::test_full_hd_strided_pixels, on the CPU).
GOLDEN_STRIDE = 17
GOLDEN_HIT_MIN = 0.996
GOLDEN_T_ATOL = GOLDEN_T_RTOL = 1e-3
GOLDEN_T_CLOSE_MIN = 0.945
GOLDEN_T_MEDIAN_MAX = 1e-3
# The strict frame against the binned frame of the same scene: they
# gate differently (per ray against the tile-binned pair table) and
# round differently at level 5, as the pallas frame does (CROSS_*
# above). The limits sit below what the same test measures on the
# strided subset on the CPU (hit 0.9986, min_t within 1e-4 on 0.9207
# and within a level-5 radius on 0.9748 of 2,624 common hits) and, for
# min_t within 1e-4, below the card's whole frame (0.8983 on an H100:
# the strided estimate ran high).
STRICT_BINNED_HIT_MIN = 0.997
STRICT_BINNED_T_CLOSE_MIN = 0.88
STRICT_BINNED_T_LEAF_MIN = 0.96
# The pallas-vs-strict gradient check (tests/test_grad.py:154-191) on a
# frame small enough for strict's autograd graph: (width, height, depth).
GRAD_CHECK_SIZE = (256, 128, 3)
# Frames of each full-frame `--animate` run.
ANIMATE_FRAMES = 3


# ---- PR-7 paths: the parity traversal, the camera path, the profiler ----
def strict_phase(torch, dev, scene, gb_binned, reset_counts, read_counts,
                 size=(WIDTH, HEIGHT, DEPTH), tile=STRICT_TILE):
    """`render_gbuffer` with algorithm "strict" up the capacity ladder
    until nothing overflows (`strict_rung` lines), held against the port's
    golden tracer on a strided pixel subset and against the binned frame
    `gb_binned`; its time and profiler view; then the same frame with
    per-node gating ("loose") against it. No kernel may launch."""
    import numpy as np

    from sphereflake_tpu_torch.config import RenderConfig
    from sphereflake_tpu_torch.models.golden import camera_rays, golden_trace
    from sphereflake_tpu_torch.render import grow_capacity, render_gbuffer

    t_phase = time.perf_counter()
    width, height, depth = size
    scfg = RenderConfig(
        width=width, height=height, max_depth=depth, tile_h=tile[0],
        tile_w=tile[1], tile_batch=STRICT_TILE_BATCH,
        max_frontier=STRICT_START_FRONTIER, algorithm="strict",
    )

    def ladder(cfg):
        rungs = []
        reset_counts()
        while True:
            t0 = time.perf_counter()
            gb = render_gbuffer(scene, cfg, device=dev)
            overflow = int(gb.metrics.overflow)
            rungs.append(dict(max_frontier=cfg.max_frontier,
                              overflow=overflow,
                              seconds=time.perf_counter() - t0))
            emit("strict_rung", algorithm=cfg.algorithm,
                 strict_lod=cfg.strict_lod, **rungs[-1])
            if not overflow:
                return cfg, gb, rungs, read_counts()
            if len(rungs) == STRICT_MAX_RUNGS:
                fail(f"{cfg.algorithm} still overflows after {rungs}")
            cfg = grow_capacity(cfg)

    scfg, sgb, rungs, counts = ladder(scfg)
    m = sgb.metrics

    # The golden tracer (float64, per ray) on the strided subset.
    cam = scene.camera
    cam_pos = cam.position.detach().cpu().double().numpy()
    dirs64 = camera_rays(
        cam_pos, float(cam.yaw), float(cam.pitch), float(cam.roll),
        float(cam.fov), width, height,
    )[::GOLDEN_STRIDE, ::GOLDEN_STRIDE]
    t0 = time.perf_counter()
    gold = golden_trace(dirs64, cam_pos, max_depth=depth,
                        lod_factor=scfg.lod_factor)
    golden_s = time.perf_counter() - t0
    sub = lambda x: x[::GOLDEN_STRIDE, ::GOLDEN_STRIDE].cpu().numpy()
    hit, min_t = sub(sgb.hit), sub(sgb.min_t)
    ghit = np.isfinite(gold.min_t)
    both = hit & ghit
    t_err = np.abs(min_t[both] - gold.min_t[both])
    t_tol = GOLDEN_T_ATOL + GOLDEN_T_RTOL * np.abs(gold.min_t[both])
    golden = dict(
        rays=int(hit.size), stride=GOLDEN_STRIDE, seconds=golden_s,
        hit_agree=float((hit == ghit).mean()),
        hit_fraction=float(ghit.mean()), common_hits=int(both.sum()),
        t_close=float((t_err <= t_tol).mean()),
        t_median_err=float(np.median(t_err)),
        golden_max_depth_reached=gold.max_depth_reached,
        golden_nodes_visited=gold.nodes_visited,
        limits=dict(hit_agree_min=GOLDEN_HIT_MIN, t_atol=GOLDEN_T_ATOL,
                    t_rtol=GOLDEN_T_RTOL, t_close_min=GOLDEN_T_CLOSE_MIN,
                    t_median_max=GOLDEN_T_MEDIAN_MAX),
    )

    # Against the binned frame of the same scene.
    bboth = sgb.hit & gb_binned.hit
    leaf_radius = 3.0 ** -int(m.max_depth_reached)
    binned_cmp = dict(
        hit_agree=float((sgb.hit == gb_binned.hit).float().mean()),
        min_t_close=float(torch.isclose(
            sgb.min_t, gb_binned.min_t, rtol=1e-4, atol=1e-4
        )[bboth].float().mean()),
        min_t_within_leaf_radius=float(
            ((sgb.min_t - gb_binned.min_t).abs() <= leaf_radius)[bboth]
            .float().mean()),
        leaf_radius=leaf_radius,
        strided_min_t_close=float(torch.isclose(
            sgb.min_t, gb_binned.min_t, rtol=1e-4, atol=1e-4
        )[::GOLDEN_STRIDE, ::GOLDEN_STRIDE][
            bboth[::GOLDEN_STRIDE, ::GOLDEN_STRIDE]].float().mean()),
        limits=dict(hit_agree_min=STRICT_BINNED_HIT_MIN,
                    min_t_close_min=STRICT_BINNED_T_CLOSE_MIN,
                    min_t_within_leaf_radius_min=STRICT_BINNED_T_LEAF_MIN),
    )

    frame_call = lambda: render_gbuffer(scene, scfg, device=dev)
    strict_frame_ms = event_ms(torch, frame_call, STRICT_TIMED_FRAMES)
    prof = profile_device(torch, frame_call, 1, cuda_only=True)
    if prof is not None:
        prof["idle_share"] = 1.0 - prof["busy_ms"] / strict_frame_ms

    # Per-node gating ("loose", strict_lod off) from the strict frame's
    # last rung up.
    lcfg, lgb, l_rungs, l_counts = ladder(
        dataclasses.replace(scfg, algorithm="loose", strict_lod=False)
    )
    lboth = lgb.hit & sgb.hit
    loose = dict(
        max_frontier=lcfg.max_frontier, rungs=l_rungs, launches=l_counts,
        overflow=int(lgb.metrics.overflow),
        max_depth_reached=int(lgb.metrics.max_depth_reached),
        nodes_visited=int(lgb.metrics.nodes_visited),
        hit_agree_with_strict=float((lgb.hit == sgb.hit).float().mean()),
        min_t_equal_to_strict=float(
            (lgb.min_t == sgb.min_t)[lboth].float().mean()),
        min_t_close_to_strict=float(torch.isclose(
            lgb.min_t, sgb.min_t, rtol=1e-4, atol=1e-4
        )[lboth].float().mean()),
    )
    out = dict(
        width=width, height=height, depth=depth, tile=list(tile),
        tile_batch=STRICT_TILE_BATCH, tiles=scfg.tiles_y * scfg.tiles_x,
        rungs=rungs, max_frontier=scfg.max_frontier,
        launches=dict(zip(KERNEL_NAMES, counts)),
        overflow=int(m.overflow), max_depth_reached=int(m.max_depth_reached),
        binned_max_depth_reached=int(gb_binned.metrics.max_depth_reached),
        nodes_visited=int(m.nodes_visited),
        closest_distance=float(m.closest_distance),
        hit_fraction=float(sgb.hit.float().mean()),
        golden=golden, vs_binned=binned_cmp,
        strict_frame_ms=strict_frame_ms,
        profile_device=prof or {
            "busy_ms": None, "note": "torch.profiler reported no device time"
        },
        loose=loose, seconds=time.perf_counter() - t_phase,
    )
    emit("strict_path", **out)
    if (int(m.overflow) or int(m.max_depth_reached) != int(
            gb_binned.metrics.max_depth_reached) or any(counts)
            or any(l_counts)):
        fail(f"strict frame properties off: {out}")
    if (golden["hit_agree"] < GOLDEN_HIT_MIN
            or golden["t_close"] < GOLDEN_T_CLOSE_MIN
            or golden["t_median_err"] >= GOLDEN_T_MEDIAN_MAX):
        fail(f"the strict frame diverges from the golden tracer: {golden}")
    if (binned_cmp["hit_agree"] < STRICT_BINNED_HIT_MIN
            or binned_cmp["min_t_close"] < STRICT_BINNED_T_CLOSE_MIN
            or binned_cmp["min_t_within_leaf_radius"]
            < STRICT_BINNED_T_LEAF_MIN):
        fail(f"the strict frame diverges from the binned frame: {binned_cmp}")
    if loose["overflow"] or not bool(torch.isfinite(lgb.min_t).all()):
        fail(f"the loose frame is off: {loose}")
    return out


def strict_grad_phase(torch, dev, scene, reset_counts, read_counts):
    """The pallas-vs-strict gradient check of the reference
    (`tests/test_grad.py:154-191`) on the card: where both paths hit with
    `min_t` within rtol 1e-4, the 15 leaf gradients of the weighted
    position loss agree within rtol 1e-2, atol 1e-4; the pallas gradient
    launches the traversal kernel once, the strict one nothing."""
    from sphereflake_tpu_torch.config import RenderConfig, SceneParams
    from sphereflake_tpu_torch.render import render_gbuffer

    t_phase = time.perf_counter()
    kw = dict(width=GRAD_CHECK_SIZE[0], height=GRAD_CHECK_SIZE[1],
              max_depth=GRAD_CHECK_SIZE[2], max_frontier=1024)
    cfg_s = RenderConfig(**kw, tile_h=64, tile_w=128, algorithm="strict")
    cfg_p = RenderConfig(**kw, tile_h=32, tile_w=32, algorithm="pallas")
    g_s = render_gbuffer(scene, cfg_s, device=dev)
    g_p = render_gbuffer(scene, cfg_p, device=dev)
    mask = (g_s.hit & g_p.hit & torch.isclose(
        g_s.min_t, g_p.min_t, rtol=1e-4, atol=0.0))[..., None]
    weights = torch.tensor([1.0, 1.1, 1.2], device=dev) * mask / (
        cfg_s.width * cfg_s.height)

    def grads(cfg):
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in scene.leaves()]
        gb = render_gbuffer(SceneParams.from_leaves(leaves), cfg, device=dev)
        loss = torch.sum(gb.position * weights)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
        return [torch.zeros_like(x) if g is None else g
                for g, x in zip(got, leaves)]

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    gs = grads(cfg_s)
    s_counts = read_counts()
    strict_grad_s = time.perf_counter() - t0
    strict_peak = torch.cuda.max_memory_allocated()
    reset_counts()
    gp = grads(cfg_p)
    p_counts = read_counts()
    ratios = [
        float(((a - b).abs() / (1e-4 + 1e-2 * b.abs())).max())
        for a, b in zip(gs, gp)
    ]
    out = dict(
        width=cfg_s.width, height=cfg_s.height, depth=cfg_s.max_depth,
        strict_tile=[cfg_s.tile_h, cfg_s.tile_w], mask_pixels=int(mask.sum()),
        overflow=[int(g_s.metrics.overflow), int(g_p.metrics.overflow)],
        launches=dict(strict=s_counts, pallas=p_counts),
        leaf_bar_ratios=ratios, max_bar_ratio=max(ratios),
        strict_grad_seconds=strict_grad_s,
        strict_grad_peak_memory_mib=(strict_peak - held) / 2**20,
        grads_finite=all(bool(torch.isfinite(g).all()) for g in gs + gp),
        limits=dict(rtol=1e-2, atol=1e-4),
        seconds=time.perf_counter() - t_phase,
    )
    emit("strict_grad", **out)
    if s_counts != [0, 0, 0, 0] or p_counts != [0, 0, 0, 1]:
        fail(f"strict_grad launched {out['launches']}: expected none for "
             "strict and one traversal launch for pallas")
    if any(out["overflow"]) or out["mask_pixels"] < 1000:
        fail(f"strict_grad frame off: {out}")
    if out["max_bar_ratio"] > 1.0 or not out["grads_finite"]:
        fail(f"pallas and strict leaf gradients disagree: {out}")
    if max(float(g.abs().max()) for g in gs) <= 0.0:
        fail("the strict gradient is zero")
    return p_counts[3]


def animate_phase(torch, dev, scene, cfg, cli_main, reset_counts,
                  read_counts, size_args):
    """The CLI's full-frame `--animate` (orbit, then approach) on the
    binned path, and an approach from an all-sky pose through `animate`.
    Every `render_frame` call is counted (re-renders of an overflowing
    frame included) and must equal the pair kernel's launches. Returns
    those launches."""
    import hashlib

    import numpy as np

    from sphereflake_tpu_torch import render
    from sphereflake_tpu_torch.ops.post import post_kernel
    from sphereflake_tpu_torch.runtime.animate import animate

    t_phase = time.perf_counter()
    renders = []
    real = render.render_frame

    def counted(s, c, *args, **kwargs):
        renders.append(s.camera.position.detach().cpu().numpy().copy())
        return real(s, c, *args, **kwargs)

    runs = {}
    render.render_frame = counted
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for mode in ("orbit", "approach"):
                renders.clear()
                reset_counts()
                t0 = time.perf_counter()
                rc = cli_main(size_args + [
                    "--animate", str(ANIMATE_FRAMES), "--animate-mode", mode,
                    "-o", os.path.join(tmp, f"{mode}.png"),
                ])
                seconds = time.perf_counter() - t0
                counts = read_counts()
                pngs = [os.path.join(tmp, f"{mode}_{i:04d}.png")
                        for i in range(ANIMATE_FRAMES)]
                blobs = [open(p, "rb").read() if os.path.exists(p) else b""
                         for p in pngs]
                runs[mode] = dict(
                    rc=rc, renders=len(renders), launches=counts,
                    post_launches=post_kernel.launches,
                    png_bytes=[len(b) for b in blobs],
                    distinct_pngs=len({hashlib.sha256(b).hexdigest()
                                       for b in blobs}),
                    distance_to_origin=[float(np.linalg.norm(p))
                                        for p in renders],
                    ms_per_frame=seconds * 1e3 / ANIMATE_FRAMES,
                )
            cam = scene.camera
            f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
            sky = dataclasses.replace(scene, camera=dataclasses.replace(
                cam, position=f32([0.0, 0.0, 20.0]), yaw=f32(0.0),
                pitch=f32(math.pi)))
            renders.clear()
            reset_counts()
            frames = list(animate(sky, cfg, 2, mode="approach", device=dev))
            sky_counts = read_counts()
            start = sky.camera.position.cpu().numpy()
            positions = [sc.camera.position.cpu().numpy() for _, sc in frames]
            runs["approach_all_sky"] = dict(
                renders=len(renders), launches=sky_counts,
                post_launches=post_kernel.launches,
                positions=[p.tolist() for p in positions],
                held=all(bool(np.array_equal(p, start)) for p in positions),
                finite=all(bool(np.isfinite(p).all()) for p in positions),
                image_max=[float(img.max()) for img, _ in frames],
            )
    finally:
        render.render_frame = real
    out = dict(frames=ANIMATE_FRAMES, width=cfg.width, height=cfg.height,
               depth=cfg.max_depth, animate_ms_per_frame=runs["orbit"][
                   "ms_per_frame"], **runs,
               seconds=time.perf_counter() - t_phase)
    emit("animate_path", **out)
    for mode in ("orbit", "approach"):
        run = runs[mode]
        if run["rc"] != 0 or min(run["png_bytes"]) < 10000:
            fail(f"CLI --animate ({mode}) failed: {run}")
        if run["launches"] != [run["renders"], 0, 0, 0] or run[
                "renders"] < ANIMATE_FRAMES:
            fail(f"CLI --animate ({mode}): launches {run['launches']} for "
                 f"{run['renders']} renders")
    if runs["orbit"]["distinct_pngs"] != ANIMATE_FRAMES:
        fail("the orbit frames are not all different")
    dist = [d for i, d in enumerate(runs["approach"]["distance_to_origin"])
            if i == 0 or d != runs["approach"]["distance_to_origin"][i - 1]]
    if len(dist) != ANIMATE_FRAMES or not all(
            a > b for a, b in zip(dist, dist[1:])):
        fail(f"the approach did not move toward the fractal: {dist}")
    sky_run = runs["approach_all_sky"]
    if not (sky_run["held"] and sky_run["finite"]) or sky_run[
            "launches"] != [sky_run["renders"], 0, 0, 0]:
        fail(f"the all-sky approach moved the camera: {sky_run}")
    for name, run in runs.items():
        if run["post_launches"] != 3 * run["renders"]:
            fail(f"{name}: post_kernel launched {run['post_launches']} "
                 f"times for {run['renders']} renders")
    return sum(r["launches"][0] for r in runs.values())


def profile_phase(cli_main, reset_counts, read_counts, size_args):
    """`--frames 2 --profile DIR`: the directory holds a Chrome trace
    whose device events name the pair kernel's walk. Returns the pair
    kernel's launches (the warm-up frame and the two timed ones; the
    post kernel's, three a frame, are gated)."""
    from sphereflake_tpu_torch.ops.post import post_kernel

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        prof_dir = os.path.join(tmp, "profile")
        reset_counts()
        rc = cli_main(size_args + ["--frames", "2", "--profile", prof_dir,
                                   "-o", os.path.join(tmp, "frame.png")])
        counts = read_counts()
        post_launches = post_kernel.launches
        files = sorted(os.listdir(prof_dir)) if os.path.isdir(prof_dir) else []
        events = []
        if "trace.json" in files:
            with open(os.path.join(prof_dir, "trace.json")) as f:
                events = json.load(f).get("traceEvents", [])
            trace_bytes = os.path.getsize(os.path.join(prof_dir, "trace.json"))
        else:
            trace_bytes = 0
    kernels = [e for e in events if e.get("cat") == "kernel"]
    walks = [e for e in kernels if "walk_items_kernel" in e.get("name", "")]
    out = dict(
        rc=rc, files=files, trace_bytes=trace_bytes, events=len(events),
        kernel_events=len(kernels), walk_items_kernel_events=len(walks),
        walk_items_kernel_us=sum(float(e.get("dur", 0)) for e in walks),
        launches=counts, post_launches=post_launches,
        seconds=time.perf_counter() - t_phase,
    )
    emit("profile_cli", **out)
    if (rc != 0 or not files or not walks or counts != [3, 0, 0, 0]
            or post_launches != 9):
        fail(f"--profile: {out}")
    return counts[0]


# The multi-device operating points: the 1080p depth-6 frame over
# a 2x2 mesh of the one card (`[cuda:0] * 4`).
MESH_SHAPE = (2, 2)
# The per-block path, forced: bands of 17 tile rows = one band per
# 544-row block, so one K1 launch a block.
BLOCK_BAND_ROWS = 17
# The per-block binned frame against the single-device one: the
# reference's own bars (tests/test_sharded.py:117-124) — hit masks
# differ on at most SHARD_HIT_MISMATCH_MAX of the pixels, min_t within
# rtol = atol = 1e-4 on more than SHARD_T_CLOSE_MIN of the common hits.
# The pallas mesh traces directions computed AoS (`ray_directions` at
# global pixel coordinates, as the reference's per-block path does): it
# must equal the full frame traced through the same AoS pipeline
# (`render._render_gbuffer_tiles`) bit for bit. Against the single-device
# pallas frame, whose directions are computed SoA (`_soa_raygen`), the
# rays differ by ulps and at level 5 the f32 hit test is
# rounding-decided: held to the bars of two f32 raygens of one frame,
# STRICT_BINNED_* (on the H100 the mesh measured hit 0.99858, min_t
# close 0.9413, within a leaf radius 0.9732: under the CROSS_* bars of
# two traversals, 0.999 and 0.98).
SHARD_HIT_MISMATCH_MAX = 1e-3
SHARD_T_CLOSE_MIN = 0.995
# The sharded frameless refresh: 256 tiles a cell a step on the trimmed
# table, stepped until every tile is covered (at most this many steps).
SHARD_TILES_PER_DEVICE = 256
SHARD_MAX_STEPS = 12
# Sharded fit step vs single-device fit step (the blocks' gradients are
# summed in another order): loss within rtol 1e-5, every leaf gradient
# within rtol 1e-3 + atol 1e-6.
FIT_LOSS_RTOL, FIT_GRAD_RTOL, FIT_GRAD_ATOL = 1e-5, 1e-3, 1e-6
# Frame data parallelism: orbit frames, one per cell of a 1D mesh.
DP_FRAMES = 4
WORKER_TIMEOUT = 300


def sharded_phase(torch, dev, scene, cfg, card, reset_counts, read_counts):
    """`sharded_path`: the 1080p depth-6 frame over a 2x2 mesh of the one
    card — the shared bin (K2 coded, one launch a block; bit for bit
    `render_gbuffer`), the per-block path (K1 a block) and the pallas
    mesh (K4 a block) against their single-device frames, the sharded
    `render_frame` against `render_frame` (its post three kernel passes a
    cell: `post.kernel` 12), and each sharded frame's time beside the
    single-device one. Returns the launches [K1, K2, K3, K4]."""
    from sphereflake_tpu_torch import spans
    from sphereflake_tpu_torch.ops.post import post_kernel
    from sphereflake_tpu_torch.parallel import (
        make_mesh,
        render_frame_sharded,
        render_gbuffer_sharded,
        shared_bin_supported,
    )
    from sphereflake_tpu_torch.render import (
        _render_gbuffer_tiles,
        render_frame,
        render_gbuffer,
    )

    t_phase = time.perf_counter()
    mesh = make_mesh([dev] * (MESH_SHAPE[0] * MESH_SHAPE[1]),
                     shape=MESH_SHAPE)
    total = [0, 0, 0, 0]

    def counted(fn):
        reset_counts()
        out = fn()
        counts = read_counts()
        for i, c in enumerate(counts):
            total[i] += c
        return out, counts

    def versus(got, want):
        hit_mismatch = float((got.hit != want.hit).float().mean())
        both = got.hit & want.hit
        close = torch.isclose(got.min_t, want.min_t, rtol=1e-4, atol=1e-4)
        leaf = 3.0 ** -int(want.metrics.max_depth_reached)
        return dict(
            hit_mismatch=hit_mismatch,
            min_t_close=float(close[both].float().mean()),
            min_t_within_leaf_radius=float(
                ((got.min_t - want.min_t).abs() <= leaf)[both].float().mean()),
        )

    with torch.no_grad():
        single = render_gbuffer(scene, cfg, device=dev)
        supported = shared_bin_supported(cfg, mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        shared, shared_counts = counted(
            lambda: render_gbuffer_sharded(scene, cfg, mesh))
        # What the sharded frame adds to what the process holds.
        peak_mib = (torch.cuda.max_memory_allocated() - held) / 2**20
        planes_equal = {k: bool(torch.equal(getattr(shared, k),
                                            getattr(single, k)))
                        for k in ("min_t", "position", "normal", "hit")}
        metrics_equal = {
            f.name: bool(torch.equal(getattr(shared.metrics, f.name),
                                     getattr(single.metrics, f.name)))
            for f in dataclasses.fields(single.metrics)
        }
        bcfg = dataclasses.replace(cfg, band_tile_rows=BLOCK_BAND_ROWS)
        blocks, block_counts = counted(
            lambda: render_gbuffer_sharded(scene, bcfg, mesh))
        pcfg = dataclasses.replace(cfg, algorithm="pallas")
        p_single = render_gbuffer(scene, pcfg, device=dev)
        p_aos = _render_gbuffer_tiles(scene, pcfg)
        p_mesh, pallas_counts = counted(
            lambda: render_gbuffer_sharded(scene, pcfg, mesh))
        aos_equal = {k: bool(torch.equal(getattr(p_mesh, k),
                                         getattr(p_aos, k)))
                     for k in ("min_t", "position", "normal", "hit")}
        img_1, _ = render_frame(scene, cfg, device=dev)
        with spans.unit("sharded_frame_check"):
            (img_s, _), frame_counts = counted(
                lambda: render_frame_sharded(scene, cfg, mesh))
        post_launches = post_kernel.launches
        post_passes = spans.records("sharded_frame_check")[-1]["counts"].get(
            "post.kernel")
        frame_err = float((img_s - img_1).abs().max())
        frame_bits = bool(torch.equal(img_s, img_1))
        times = dict(
            frame_ms=event_ms(torch, lambda: render_frame(
                scene, cfg, device=dev), 3),
            sharded_frame_ms=event_ms(torch, lambda: render_frame_sharded(
                scene, cfg, mesh), 3),
            gbuffer_ms=event_ms(torch, lambda: render_gbuffer(
                scene, cfg, device=dev), 3),
            shared_bin_gbuffer_ms=event_ms(torch, lambda: (
                render_gbuffer_sharded(scene, cfg, mesh)), 3),
            per_block_gbuffer_ms=event_ms(torch, lambda: (
                render_gbuffer_sharded(scene, bcfg, mesh)), 3),
            pallas_gbuffer_ms=event_ms(torch, lambda: render_gbuffer(
                scene, pcfg, device=dev), 3),
            pallas_mesh_gbuffer_ms=event_ms(torch, lambda: (
                render_gbuffer_sharded(scene, pcfg, mesh)), 3),
        )
    out = dict(
        width=cfg.width, height=cfg.height, depth=cfg.max_depth,
        mesh=list(MESH_SHAPE), shared_bin_supported=supported,
        pair_cap=cfg.pair_cap, tiles=[cfg.tiles_y, cfg.tiles_x],
        shared_bin=dict(launches=shared_counts, planes_equal=planes_equal,
                        metrics_equal=metrics_equal,
                        overflow=int(shared.metrics.overflow),
                        peak_memory_mib=peak_mib),
        per_block=dict(band_tile_rows=BLOCK_BAND_ROWS, launches=block_counts,
                       overflow=int(blocks.metrics.overflow),
                       **versus(blocks, single)),
        pallas=dict(launches=pallas_counts,
                    overflow=int(p_mesh.metrics.overflow),
                    equals_aos_frame=aos_equal,
                    **versus(p_mesh, p_single)),
        render_frame=dict(launches=frame_counts, max_abs_err=frame_err,
                          bits_equal=frame_bits, post_kernel=post_passes,
                          post_launches=post_launches,
                          limit=dict(max_abs_err=COMPOSITE_ERR_MAX)),
        limits=dict(per_block=dict(hit_mismatch_max=SHARD_HIT_MISMATCH_MAX,
                                   min_t_close_min=SHARD_T_CLOSE_MIN),
                    pallas=dict(hit_agree_min=STRICT_BINNED_HIT_MIN,
                                min_t_close_min=STRICT_BINNED_T_CLOSE_MIN,
                                min_t_within_leaf_radius_min=(
                                    STRICT_BINNED_T_LEAF_MIN))),
        times=times, card=card, seconds=time.perf_counter() - t_phase,
    )
    emit("sharded_path", **out)
    n = MESH_SHAPE[0] * MESH_SHAPE[1]
    if not supported or not all(planes_equal.values()) or not all(
            metrics_equal.values()) or shared_counts != [0, n, 0, 0]:
        fail(f"the shared bin is not the single-device frame: {out}")
    block, pallas = out["per_block"], out["pallas"]
    if (block["launches"] != [n, 0, 0, 0] or block["overflow"] != 0
            or block["hit_mismatch"] > SHARD_HIT_MISMATCH_MAX
            or block["min_t_close"] <= SHARD_T_CLOSE_MIN):
        fail(f"the per-block frame disagrees with the single-device one: "
             f"{block}")
    if (pallas["launches"] != [0, 0, 0, n] or pallas["overflow"] != 0
            or not all(aos_equal.values())
            or 1.0 - pallas["hit_mismatch"] < STRICT_BINNED_HIT_MIN
            or pallas["min_t_close"] < STRICT_BINNED_T_CLOSE_MIN
            or pallas["min_t_within_leaf_radius"] < STRICT_BINNED_T_LEAF_MIN):
        fail(f"the pallas mesh disagrees with the single-device pallas "
             f"frame: {pallas}")
    if (frame_counts != [0, n, 0, 0] or frame_err > COMPOSITE_ERR_MAX
            or post_passes != 3 * n or post_launches != 3 * n):
        fail(f"render_frame_sharded disagrees with render_frame: {out}")
    return total


def sharded_frameless_phase(torch, dev, scene, cfg, card, reset_counts,
                            read_counts):
    """`sharded_frameless`: every cell of the 2x2 mesh refreshes 256
    Sobol tiles of its own block a step (K2 `shade_only`, one launch a
    cell) on the trimmed table until all 2,040 tiles are covered; the
    state must equal the single-device frameless state tile for tile, bit
    for bit. A cursor started at 2^32 - 256 carries into its hi word.
    Returns the launches."""
    from sphereflake_tpu_torch.parallel import (
        make_mesh,
        sharded_tiles_as_single,
        sharded_tiles_init,
        sharded_tiles_step,
    )
    from sphereflake_tpu_torch.runtime.progressive import (
        progressive_prepare_trimmed,
        progressive_tiles_init,
        progressive_tiles_step,
    )

    t_phase = time.perf_counter()
    mesh = make_mesh([dev] * (MESH_SHAPE[0] * MESH_SHAPE[1]),
                     shape=MESH_SHAPE)
    n = mesh.size
    n_tiles = cfg.tiles_x * cfg.tiles_y
    reset_counts()
    prepared = progressive_prepare_trimmed(scene, cfg, device=dev)
    prep_counts = read_counts()
    reset_counts()
    st = sharded_tiles_init(cfg, mesh, seed=1)
    steps = 0
    while steps < SHARD_MAX_STEPS and int(st.covered.sum()) < n_tiles:
        st = sharded_tiles_step(st, scene, cfg, mesh,
                                tiles_per_device=SHARD_TILES_PER_DEVICE,
                                prepared=prepared)
        steps += 1
    step_counts = read_counts()
    covered = int(st.covered.sum())
    one = progressive_tiles_init(cfg, seed=1, device=dev)
    for _ in range(GATE_STEPS):
        one = progressive_tiles_step(one, scene, cfg,
                                     tiles_per_step=TILES_PER_STEP,
                                     prepared=prepared)
    view = sharded_tiles_as_single(st)
    rows_equal = bool(torch.equal(view.rows, one.rows))
    # The hi-word carry: every cell's cursor at 2^32 - 256.
    wrap = sharded_tiles_init(cfg, mesh, seed=1)
    wrap.sample_lo.fill_(2**32 - SHARD_TILES_PER_DEVICE)
    reset_counts()
    wrap = sharded_tiles_step(wrap, scene, cfg, mesh,
                              tiles_per_device=SHARD_TILES_PER_DEVICE,
                              prepared=prepared)
    wrap_counts = read_counts()
    carried = (wrap.sample_lo.tolist(), wrap.sample_hi.tolist())

    def sharded_step():
        sharded_tiles_step(st, scene, cfg, mesh,
                           tiles_per_device=SHARD_TILES_PER_DEVICE,
                           prepared=prepared)

    def single_step():
        progressive_tiles_step(one, scene, cfg, tiles_per_step=TILES_PER_STEP,
                               prepared=prepared)

    out = dict(
        tiles_per_device=SHARD_TILES_PER_DEVICE, mesh=list(MESH_SHAPE),
        steps=steps, covered=covered, tiles=n_tiles,
        overflow=int(st.overflow), prepare_launches=prep_counts,
        launches=step_counts, equals_single_device=rows_equal,
        single_device_steps=GATE_STEPS, samples_traced=st.samples_traced,
        wrap=dict(start_lo=2**32 - SHARD_TILES_PER_DEVICE,
                  sample_lo=carried[0], sample_hi=carried[1],
                  launches=wrap_counts),
        sharded_step_ms=event_ms(torch, sharded_step, 10),
        single_step_ms=event_ms(torch, single_step, 10),
        card=card, seconds=time.perf_counter() - t_phase,
    )
    emit("sharded_frameless", **out)
    if (covered != n_tiles or int(st.overflow) or not rows_equal
            or step_counts != [0, n * steps, 0, 0]):
        fail(f"the sharded frameless state is off: {out}")
    my, mx = MESH_SHAPE
    if carried != ([[0] * mx] * my, [[1] * mx] * my) or wrap_counts != [
            0, n, 0, 0]:
        fail(f"the cursor did not carry into its hi word: {out['wrap']}")
    return [a + b + c for a, b, c in zip(prep_counts, step_counts,
                                         wrap_counts)]


def frames_dp_phase(torch, dev, scene, cfg, card, reset_counts, read_counts):
    """`frames_dp`: four orbit cameras rendered by `render_frames_dp` over
    a 1D mesh of the card, equal to four sequential `render_frame` calls
    bit for bit; one K1 launch a frame. Returns the launches."""
    from sphereflake_tpu_torch.ops.post import post_kernel
    from sphereflake_tpu_torch.parallel import (
        make_frame_mesh,
        render_frames_dp,
    )
    from sphereflake_tpu_torch.render import render_frame
    from sphereflake_tpu_torch.runtime.animate import _orbit_scene

    t_phase = time.perf_counter()
    mesh = make_frame_mesh([dev] * DP_FRAMES)
    radius = float(torch.linalg.vector_norm(scene.camera.position))
    scenes = [_orbit_scene(scene, scene.camera, radius, i, DP_FRAMES)
              for i in range(DP_FRAMES)]
    with torch.no_grad():
        reset_counts()
        images, ovf = render_frames_dp(scenes, cfg, mesh)
        counts = read_counts()
        post_launches = post_kernel.launches
        seq = [render_frame(s, cfg, device=dev)[0] for s in scenes]
        equal = [bool(torch.equal(images[i], seq[i]))
                 for i in range(DP_FRAMES)]
        dp_ms = event_ms(torch, lambda: render_frames_dp(scenes, cfg, mesh), 2)
        seq_ms = event_ms(torch, lambda: [
            render_frame(s, cfg, device=dev) for s in scenes], 2)
    out = dict(frames=DP_FRAMES, launches=counts,
               post_launches=post_launches, overflow=ovf.tolist(),
               equal_to_sequential=equal,
               distinct=bool(float((images[0] - images[1]).abs().max()) > 0),
               dp_ms=dp_ms, sequential_ms=seq_ms, card=card,
               seconds=time.perf_counter() - t_phase)
    emit("frames_dp", **out)
    if (not all(equal) or any(ovf.tolist()) or counts != [DP_FRAMES, 0, 0, 0]
            or not out["distinct"] or post_launches != 3 * DP_FRAMES):
        fail(f"render_frames_dp is not the sequential frames: {out}")
    return counts


def sharded_fit_phase(torch, dev, scene, cfg, card, reset_counts,
                      read_counts):
    """`sharded_fit`: `fit_step_sharded` at 1080p depth 6 over the 2x2
    mesh against the single-device step (loss and the 15 leaf
    gradients), then `fit(mesh=...)` for 2 steps, whose loss must
    descend. Returns the launches."""
    from sphereflake_tpu_torch.fit import fit, fit_step
    from sphereflake_tpu_torch.parallel import fit_step_sharded, make_mesh
    from sphereflake_tpu_torch.render import render_gbuffer

    t_phase = time.perf_counter()
    mesh = make_mesh([dev] * (MESH_SHAPE[0] * MESH_SHAPE[1]),
                     shape=MESH_SHAPE)
    n = mesh.size
    with torch.no_grad():
        target = render_gbuffer(scene, cfg, device=dev)
    start = perturbed(scene, 0.004, 0.004)
    total = [0, 0, 0, 0]
    reset_counts()
    t0 = time.perf_counter()
    loss_s, g_s = fit_step_sharded(start, target.position, target.normal,
                                   cfg, mesh)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    step_counts = read_counts()
    t0 = time.perf_counter()
    loss_1, g_1 = fit_step(start, target.position, target.normal, cfg,
                           device=dev)
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) * 1e3
    rel = []
    grads_ok = True
    for a, b in zip(g_s.leaves(), g_1.leaves()):
        err = (a - b).abs()
        grads_ok &= bool((err <= FIT_GRAD_ATOL + FIT_GRAD_RTOL * b.abs())
                         .all())
        rel.append(float((err / b.abs().clamp_min(1e-30)).max()))
    reset_counts()
    res = fit(start, target.position, target.normal, cfg, steps=2,
              learning_rate=2e-3, mesh=mesh)
    fit_counts = read_counts()
    for counts in (step_counts, fit_counts):
        total = [t + c for t, c in zip(total, counts)]
    out = dict(
        mesh=list(MESH_SHAPE), loss=float(loss_s), single_loss=float(loss_1),
        leaf_grad_max_rel_err=rel, grads_within=grads_ok,
        step0_grad=dict(yaw=float(g_s.camera.yaw),
                        single_yaw=float(g_1.camera.yaw)),
        step_launches=step_counts, fit_losses=res.losses,
        fit_launches=fit_counts, step_ms=step_ms, single_step_ms=single_ms,
        limits=dict(loss_rtol=FIT_LOSS_RTOL, grad_rtol=FIT_GRAD_RTOL,
                    grad_atol=FIT_GRAD_ATOL),
        card=card, seconds=time.perf_counter() - t_phase,
    )
    emit("sharded_fit", **out)
    if (abs(float(loss_s) - float(loss_1)) > FIT_LOSS_RTOL * abs(float(loss_1))
            or not grads_ok or step_counts != [n, 0, 0, 0]):
        fail(f"the sharded fit step disagrees with the single-device one: "
             f"{out}")
    if not res.losses[1] < res.losses[0] or fit_counts != [2 * n, 0, 0, 0]:
        fail(f"fit(mesh=...) does not descend: {out}")
    return total


def multiprocess_phase(torch, dev, scene, cfg, card):
    """`multiprocess`: two processes on the one card over gloo
    (`python -m sphereflake_tpu_torch.parallel.worker`), global mesh 2x1
    at 1080p depth 6: each renders its row-band (the shared bin across
    the processes) and runs one sharded fit step. The stitched min_t
    must equal the single-process sharded frame bit for bit, the loss
    and the gradient fingerprint must be equal on both ranks, and a
    failed rank fails the phase. Returns the ranks' launches."""
    import socket

    import numpy as np

    from sphereflake_tpu_torch.parallel import make_mesh, render_gbuffer_sharded

    t_phase = time.perf_counter()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ,
           "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    with tempfile.TemporaryDirectory() as tmp:
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "sphereflake_tpu_torch.parallel.worker",
                 tmp, "--coordinator", f"127.0.0.1:{port}", "--nprocs", "2",
                 "--pid", str(pid), "--device", dev.type, "--algorithm",
                 "binned", "--tile", "32x32", "--width", str(cfg.width),
                 "--height-per-device", str(cfg.height // 2), "--depth",
                 str(cfg.max_depth), "--max-frontier", str(cfg.max_frontier)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, cwd=root,
            )
            for pid in range(2)
        ]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        rcs = [p.returncode for p in procs]
        if rcs != [0, 0]:
            fail(f"a worker failed (rcs {rcs}): "
                 + " | ".join(log[-1500:] for log in logs))
        ranks = [dict(np.load(os.path.join(tmp, f"worker_{r}.npz")))
                 for r in range(2)]
    rows = {}
    for r in ranks:
        for k, v in r.items():
            if k.startswith("minrow_"):
                rows[int(k.split("_")[1])] = v
    stitched = np.concatenate([rows[k] for k in sorted(rows)], axis=0)
    with torch.no_grad():
        single = render_gbuffer_sharded(
            scene, cfg, make_mesh([dev, dev], shape=(2, 1)))
    equal = bool(np.array_equal(stitched, single.min_t.cpu().numpy()))
    out = dict(
        processes=2, backend="gloo", mesh=[2, 1], row_starts=sorted(rows),
        stitched_equals_single_process=equal,
        loss=[float(r["loss"]) for r in ranks],
        fingerprints_equal=bool(np.array_equal(
            ranks[0]["grad_fingerprint"], ranks[1]["grad_fingerprint"])),
        launches=[r["launches"].tolist() for r in ranks],
        render_launches=[r["render_launches"].tolist() for r in ranks],
        overflow=[int(r["overflow"]) for r in ranks],
        worker_seconds=[float(r["seconds"]) for r in ranks],
        card=card, seconds=time.perf_counter() - t_phase,
    )
    emit("multiprocess", **out)
    if (not equal or out["loss"][0] != out["loss"][1]
            or not out["fingerprints_equal"] or any(out["overflow"])
            or out["launches"] != [[1, 2, 0, 0]] * 2):
        fail(f"the two-process run disagrees: {out}")
    return [int(sum(r["launches"][i] for r in ranks)) for i in range(4)]


def _paeth_filtered(rgb):
    """The scanlines PNG filter 4 (Paeth) makes of `rgb`, each led by its
    filter byte — what the native encoder deflates."""
    import numpy as np

    h, w, _ = rgb.shape
    cur = rgb.reshape(h, w * 3).astype(np.int16)
    up = np.zeros_like(cur)
    up[1:] = cur[:-1]
    left = np.zeros_like(cur)
    left[:, 3:] = cur[:, :-3]
    upleft = np.zeros_like(cur)
    upleft[:, 3:] = up[:, :-3]
    p = left + up - upleft
    pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
    pred = np.where((pa <= pb) & (pa <= pc), left,
                    np.where(pb <= pc, up, upleft))
    out = ((cur - pred) & 0xFF).astype(np.uint8)
    return np.concatenate([np.full((h, 1), 4, np.uint8), out], axis=1)


def _inflated_idat(data: bytes):
    import struct
    import zlib

    pos, idat = 8, b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    return zlib.decompress(idat)


def native_phase(torch, dev, scene, cfg, card, cli_main, reset_counts,
                 read_counts, size_args):
    """`native`: the host library is built from the port's sources (a
    missing compiler fails here), `write_png` goes through it, the 1080p
    composite encoded natively and by the Python encoder decodes to the
    same pixels (each stream inflates to its filter of the image: Paeth
    for the native encoder, none for Python's, and unfiltering inverts
    the filter), both encode times; then `animate_ms_per_frame` of a
    3-frame `--animate` run with PNGs written natively. Returns the
    launches."""
    import numpy as np

    from sphereflake_tpu_torch.render import render_frame
    from sphereflake_tpu_torch.runtime import native
    from sphereflake_tpu_torch.utils import image as image_mod

    t_phase = time.perf_counter()
    if not native.available():
        fail("no C++ compiler: the native host library cannot be built")
    lib = native.build()  # the one `write_png` has used since its first PNG
    # A build from scratch, timed, into a directory of its own.
    with tempfile.TemporaryDirectory() as tmp:
        saved = os.environ.get("SPHEREFLAKE_TORCH_BUILD_DIR")
        os.environ["SPHEREFLAKE_TORCH_BUILD_DIR"] = tmp
        try:
            t0 = time.perf_counter()
            native.build()
            build_s = time.perf_counter() - t0
        finally:
            if saved is None:
                del os.environ["SPHEREFLAKE_TORCH_BUILD_DIR"]
            else:
                os.environ["SPHEREFLAKE_TORCH_BUILD_DIR"] = saved
    with torch.no_grad():
        image, _ = render_frame(scene, cfg, device=dev)
    rgb = image_mod.to_uint8(image)
    t0 = time.perf_counter()
    data_native = native.encode_png_native(rgb)
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    data_python = image_mod.encode_png_python(rgb)
    python_ms = (time.perf_counter() - t0) * 1e3
    h, w, _ = rgb.shape
    plain = np.concatenate([np.zeros((h, 1), np.uint8),
                            rgb.reshape(h, w * 3)], axis=1)
    native_ok = _inflated_idat(data_native) == _paeth_filtered(rgb).tobytes()
    python_ok = _inflated_idat(data_python) == plain.tobytes()
    calls = []
    real = native.encode_png_native

    def counted(x):
        calls.append(x.shape)
        return real(x)

    native.encode_png_native = counted
    try:
        with tempfile.TemporaryDirectory() as tmp:
            image_mod.write_png(os.path.join(tmp, "frame.png"), image)
            reset_counts()
            t0 = time.perf_counter()
            rc = cli_main(size_args + ["--animate", str(ANIMATE_FRAMES),
                                       "-o", os.path.join(tmp, "a.png")])
            anim_s = time.perf_counter() - t0
            counts = read_counts()
    finally:
        native.encode_png_native = real
    out = dict(
        library=os.path.relpath(lib, os.path.dirname(os.path.abspath(
            __file__))),
        build_seconds=build_s, write_png_native_calls=len(calls),
        png_bytes=dict(native=len(data_native), python=len(data_python)),
        decodes_to_same_pixels=dict(native=native_ok, python=python_ok),
        encode_ms=dict(native=native_ms, python=python_ms),
        animate=dict(rc=rc, frames=ANIMATE_FRAMES, launches=counts,
                     animate_ms_per_frame=anim_s * 1e3 / ANIMATE_FRAMES),
        card=card, seconds=time.perf_counter() - t_phase,
    )
    emit("native", **out)
    if not (native_ok and python_ok) or len(calls) != 1 + ANIMATE_FRAMES:
        fail(f"the native PNG path is off: {out}")
    if rc != 0 or counts != [ANIMATE_FRAMES, 0, 0, 0]:
        fail(f"--animate with native PNGs failed: {out}")
    return counts


# ---- the reference's measurement programs ----------------------------
# `python -m sphereflake_tpu_torch.bench` runs in-process at the
# reference's settings; the `bigframe` sizes and depths are the
# reference tool's (`tools/bigframe.py`), each climbing the capacity
# ladder (`render.grow_capacity`) until no band overflows, at most
# BIG_MAX_RUNGS rungs; the scaling projection runs both of the reference
# tool's modes with its loops cut to SCALING_LOOPS (the reference's:
# n_small 2, n_big 22 (1080p) or 4 (config5), min of 2 trials).
BIG_LEAN_SIZE = 4096  # lean_bands vs render_gbuffer, bit for bit
BIG_FULL_SIZE = 8192  # render_gbuffer, the full G-buffer on the card
BIG_DEPTHS = (6, 8)  # the 16384^2 frame through lean_bands
BIG_MAX_RUNGS = 4
SCALING_LOOPS = dict(n_small=1, n_big=2, trials=1)


def _captured(fn):
    """(fn(), the lines it printed to stdout, those to stderr): the
    programs print their results and their context; here they go into
    the phase's JSON line."""
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        result = fn()
    return (result, out.getvalue().strip().splitlines(),
            err.getvalue().strip().splitlines())


def bench_phase(torch, dev, card, reset_counts, read_counts):
    """`bench`: `sphereflake_tpu_torch.bench.main` at the reference's
    settings. It must return 0 (both gates held) and end with the JSON
    line of the reference's keys; K1 launches once a frame and once a
    trimmed prepare, K2 once a tile step, as its loops say. Returns the
    launches."""
    from sphereflake_tpu_torch import bench

    t_phase = time.perf_counter()
    # Each marginal runs n_small and n_big once to warm up, then per trial.
    per_round = bench.N_SMALL + bench.N_BIG
    frames = 1 + per_round * (1 + bench.FRAME_TRIALS)
    prepares = 1 + 2 * (1 + bench.REFRESH_TRIALS)
    steps = bench.GATE_STEPS + per_round * (1 + bench.REFRESH_TRIALS)
    expected = [frames + prepares, steps, 0, 0]
    reset_counts()
    rc, lines, context = _captured(lambda: bench.main([]))
    counts = read_counts()
    record = json.loads(lines[-1]) if rc == 0 and lines else {}
    keys = {"metric", "value", "unit", "mode", "full_frame_rays_per_second",
            "tiles_per_step", "sustained_trials_rays_per_second",
            "full_frame_trials_rays_per_second", "device", "power_limit"}
    out = dict(
        rc=rc, keys_as_the_reference=set(record) == keys,
        value=record.get("value"),
        full_frame_rays_per_second=record.get("full_frame_rays_per_second"),
        sustained_trials_rays_per_second=record.get(
            "sustained_trials_rays_per_second"),
        full_frame_trials_rays_per_second=record.get(
            "full_frame_trials_rays_per_second"),
        device=record.get("device"), power_limit=record.get("power_limit"),
        launches=counts, expected_launches=expected, card=card,
        seconds=time.perf_counter() - t_phase, context=context,
    )
    emit("bench", **out)
    if rc != 0 or not out["keys_as_the_reference"]:
        fail(f"the bench failed or printed another line: {out}, {lines[-1:]}")
    if counts != expected:
        fail(f"the bench's launches are not its loops': {out}")
    return counts


def bigframe_phase(torch, dev, scene, card, reset_counts, read_counts):
    """`bigframe`: `lean_bands` equal to `render_gbuffer` bit for bit at
    4096^2 (min_t, hit; the preview is the normal plane at every 8th
    pixel); 8192^2 through `render_gbuffer` and 16384^2 at depths 6 and
    8 through `lean_bands`, each climbing the capacity ladder until no
    band overflows, then K1 against its plain version on its last band
    (y offset 16256: bit for bit, a `kernel_vs_plain` line); K1 once a
    band in every call. Per size the warm call (CUDA events) and the
    peak memory. Returns the launches and the 16384^2 band checks."""
    from sphereflake_tpu_torch import bigframe
    from sphereflake_tpu_torch.render import grow_capacity, render_gbuffer

    t_phase = time.perf_counter()
    held_mib = torch.cuda.memory_allocated(dev) / 2**20
    total = [0, 0, 0, 0]
    calls = []  # (what, bands, launches) of every call

    def counted(what, cfg, fn):
        reset_counts()
        result = fn()
        counts = read_counts()
        calls.append(dict(what=what, bands=bigframe.n_bands(cfg),
                          launches=counts))
        total[:] = [t + c for t, c in zip(total, counts)]
        return result

    def gbuffer(cfg):
        with torch.no_grad():
            return render_gbuffer(scene, cfg, device=dev)

    def ladder(what, cfg, fn, overflow_of):
        rungs = []
        while True:
            result = counted(what, cfg, lambda: fn(cfg))
            rungs.append(dict(global_cap=cfg.global_cap,
                              band_tile_rows=cfg.effective_band_rows,
                              overflow=overflow_of(result)))
            if not rungs[-1]["overflow"]:
                return cfg, result, rungs
            if len(rungs) == BIG_MAX_RUNGS:
                fail(f"{what} still overflows after {rungs}")
            cfg = grow_capacity(cfg)

    def size_report(cfg, first_s, rungs, hits, fn):
        ms = bigframe.warm_ms(
            lambda: counted(f"warm {cfg.width} d{cfg.max_depth}", cfg, fn),
            dev)
        return dict(
            size=cfg.width, depth=cfg.max_depth, bands=bigframe.n_bands(cfg),
            rungs=rungs, first_call_seconds=first_s, warm_ms=ms,
            rays_per_second=cfg.width * cfg.height / (ms * 1e-3),
            hits=hits, hit_fraction=hits / (cfg.width * cfg.height),
            peak_memory_mib=torch.cuda.max_memory_allocated(dev) / 2**20,
        )

    sizes = []
    # 4096^2: the lean loop against the full G-buffer, bit for bit.
    cfg = bigframe.big_config(BIG_LEAN_SIZE, DEPTH)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    lean = counted("lean 4096", cfg, lambda: bigframe.lean_bands(scene, cfg))
    first_s = time.perf_counter() - t0
    gb = counted("render_gbuffer 4096", cfg, lambda: gbuffer(cfg))
    step = bigframe.DS
    hit_s = gb.hit[::step, ::step]
    equal = dict(
        min_t=bool(torch.equal(lean["min_t"], gb.min_t)),
        hit=bool(torch.equal(lean["hit"].bool(), gb.hit)),
        preview_where_hit=bool(torch.equal(
            lean["preview"][hit_s], gb.normal[::step, ::step][hit_s])),
        nodes=lean["nodes"] == int(gb.metrics.nodes_visited),
        overflow=lean["overflow"] == int(gb.metrics.overflow) == 0,
    )
    hits = int(gb.hit.sum(dtype=torch.int64))
    del gb, lean
    # One band's worth of host and device time, 8 times over.
    lean_profile = counted("profiled lean 4096", cfg, lambda: profile_device(
        torch, lambda: bigframe.lean_bands(scene, cfg), 1, cuda_only=True))
    sizes.append(dict(
        **size_report(cfg, first_s, None, hits,
                      lambda: bigframe.lean_bands(scene, cfg)),
        path="lean_bands", lean_equals_render_gbuffer=equal,
        profile=lean_profile,
    ))
    if lean_profile:
        sizes[-1]["idle_share"] = 1.0 - lean_profile["busy_ms"] / sizes[-1][
            "warm_ms"]

    # 8192^2: the full G-buffer through render_gbuffer.
    cfg = bigframe.big_config(BIG_FULL_SIZE, DEPTH)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg, gb, rungs = ladder("render_gbuffer 8192", cfg, gbuffer,
                            lambda g: int(g.metrics.overflow))
    first_s = time.perf_counter() - t0
    hits = int(gb.hit.sum(dtype=torch.int64))
    finite = bool(torch.isfinite(gb.position).all())
    del gb
    sizes.append(dict(**size_report(cfg, first_s, rungs, hits,
                                    lambda: gbuffer(cfg)),
                      path="render_gbuffer", position_finite=finite))

    # 16384^2 at depths 6 and 8: the lean loop.
    big_hits = {}
    band_checks_16k = []
    for depth in BIG_DEPTHS:
        cfg = bigframe.big_config(bigframe.LEAN_FROM, depth)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        cfg, lean, rungs = ladder(
            f"lean 16384 d{depth}", cfg,
            lambda c: bigframe.lean_bands(scene, c),
            lambda r: r["overflow"])
        first_s = time.perf_counter() - t0
        big_hits[depth] = int(lean["hit"].sum(dtype=torch.int64))
        finite = bool(torch.isfinite(lean["preview"]).all())
        del lean
        sizes.append(dict(
            **size_report(cfg, first_s, rungs, big_hits[depth],
                          lambda: bigframe.lean_bands(scene, cfg)),
            path="lean_bands", preview_finite=finite,
        ))
        # K1 against its plain version where the pixel offsets are
        # largest: the last band of the frame the ladder settled on
        # (outside every counted call).
        check = band_vs_plain(torch, scene, cfg)
        bands = check["shape"]["bands"]
        emit("kernel_vs_plain", kernel="pairs_kernel",
             variant=f"16384^2 band {bands - 1} of {bands}, depth {depth}",
             limits=dict(agree_min=AGREE_MIN, abs_err_max=ABS_ERR_MAX),
             **check)
        if not check["bits_equal"] or not check["metrics_equal"]:
            fail(f"pairs_kernel (16384^2 last band, depth {depth}) "
                 f"disagrees with its plain version: {check}")
        check_agreement(f"pairs_kernel (16384^2 last band, depth {depth})",
                        check)
        band_checks_16k.append(check)
    out = dict(
        sizes=sizes, hits_16384_by_depth=big_hits,
        hits_16384_equal_across_depths=len(set(big_hits.values())) == 1,
        calls=calls, launches=total, held_before_mib=held_mib, card=card,
        seconds=time.perf_counter() - t_phase,
    )
    emit("bigframe", **out)
    if not all(sizes[0]["lean_equals_render_gbuffer"].values()):
        fail(f"lean_bands differs from render_gbuffer at 4096^2: {out}")
    bad = [c for c in calls if c["launches"] != [c["bands"], 0, 0, 0]]
    if bad:
        fail(f"a big frame did not launch K1 once a band: {bad}")
    if not all(s.get("position_finite", True) and s.get("preview_finite", True)
               and 0.0 < s["hit_fraction"] < 1.0 for s in sizes):
        fail(f"a big frame is not finite or has no hits: {out}")
    return total, band_checks_16k


def scaling_phase(torch, dev, card, reset_counts, read_counts):
    """`scaling_project`: both modes of the reference's projection through
    the bench's moving-camera marginal, with the loops cut to
    SCALING_LOOPS; every projected efficiency, each measurement's peak
    memory (the whole 16384^2 `render_gbuffer` holds every band's rows
    until one cat) and K1 once a band of every frame. Returns the
    launches."""
    from sphereflake_tpu_torch import bigframe
    from sphereflake_tpu_torch import scaling_project as sp

    t_phase = time.perf_counter()
    frames = (SCALING_LOOPS["n_small"] + SCALING_LOOPS["n_big"]) * (
        1 + SCALING_LOOPS["trials"])  # warm-up and trials
    expected = 0
    for mode in sp.MODES:
        whole, blocks = sp.configs(mode, DEPTH)
        expected += frames * sum(bigframe.n_bands(c)
                                 for c in (whole, *blocks.values()))
    held_mib = torch.cuda.memory_allocated(dev) / 2**20
    reset_counts()
    results, lines, context = _captured(lambda: [
        sp.project(DEPTH, mode, dev, **SCALING_LOOPS) for mode in sp.MODES
    ])
    counts = read_counts()
    out = dict(
        reduction=dict(**SCALING_LOOPS, reference=dict(
            n_small=2, n_big=sp.N_BIG, trials=sp.TRIALS, pick="min")),
        projections=results, lines=lines, context=context, launches=counts,
        expected_launches=[expected, 0, 0, 0], held_before_mib=held_mib,
        card=card,
        seconds=time.perf_counter() - t_phase,
    )
    emit("scaling_project", **out)
    if counts != [expected, 0, 0, 0]:
        fail(f"the projection's launches are not its frames' bands: {out}")
    if not all(0.0 < b["efficiency"] and b["ms"] > 0.0
               for r in results for b in r["blocks"]):
        fail(f"a projection time is not positive: {out}")
    return counts


# The post chain's kernels (`csrc/post_kernel.cu`), each pass against its
# plain version on the same inputs, bit for bit: the frames the benchmark's
# one-card cells render, one 8192^2 block of the 16384^2 frame at the
# block origin of the four-card cell's last cell, and the SSAO target at
# half size. Times: the kernel queued behind the spin kernel over
# POST_TIMED_REPS launches, the plain version over POST_PLAIN_REPS calls.
POST_CASES = (
    # (variant, width, height, depth, ssao_downscale, block (y0, x0, bh, bw))
    ("1920x1080", 1920, 1080, 6, 1, None),
    ("3840x2160", 3840, 2160, 8, 1, None),
    ("16384^2 block at (8192, 8192)", 16384, 16384, 8, 1,
     (8192, 8192, 8192, 8192)),
    ("1920x1080 ssao_downscale 2", 1920, 1080, 6, 2, None),
)
POST_TIMED_REPS, POST_PLAIN_REPS = 20, 2
# Bytes a pixel of each pass's output, each input read once and the output
# written once: SSAO reads position and normal (24) and writes AO (4); the
# blur reads them and the source plane (4) and writes AO (4); the blur with
# the composite writes RGB (12) instead.
POST_BYTES = {"ssao": 28, "blur": 32, "blur_composite": 40}


def post_phase(torch, dev, card):
    """`kernel_vs_plain` lines of `post_kernel`, one per case and pass
    (bits equal, or the script fails), with each pass's ms beside its
    byte bound and its plain version's ms; then the `post_path` line:
    a 1080p `render_frame` launches the post kernel three times and
    counts `post.kernel` 3 in its unit; then the `post_grad_path` line:
    the same frame with the six SSAO uniforms requiring grad launches
    none, its image equals the kernels' bit for bit, and the uniforms
    the shaders weigh get finite, nonzero gradients. Returns the 1080p
    frame's three passes (kernel ms, plain ms, bound ms), summed, and
    the largest `max_abs_err` of the `kernel_vs_plain` lines."""
    from sphereflake_tpu_torch import spans
    from sphereflake_tpu_torch.config import RenderConfig, default_scene
    from sphereflake_tpu_torch.ops import post
    from sphereflake_tpu_torch.ops.noise import ssao_noise_texture
    from sphereflake_tpu_torch.render import render_frame, render_gbuffer

    scene = default_scene(dev)
    frame_sums, errs = None, []
    for variant, w, h, depth, ds, block in POST_CASES:
        cfg = RenderConfig(width=w, height=h, max_depth=depth, tile_h=32,
                           tile_w=32, algorithm="binned", ssao_downscale=ds)
        sh, sw = h // ds, w // ds
        sblock = None if block is None else tuple(b // ds for b in block)
        with torch.no_grad():
            gb = render_gbuffer(scene, cfg, device=dev)
            pos, nrm = gb.position, gb.normal
            noise = torch.from_numpy(ssao_noise_texture(cfg.noise_size)).to(dev)
            radius = (scene.ssao.radius_multiplier, gb.metrics.closest_distance)
            p = scene.ssao
            cam = scene.camera.position
            # Each pass's inputs: the kernel's output of the pass before,
            # over the whole target (a block's blur reads across its edges).
            ao = post.ssao_pass(pos, nrm, noise, p, radius, sh, sw)
            aoh = post.blur_pass(ao, pos, nrm, p, (1.0, 0.0), h, w)
            passes = (
                ("ssao", sblock, sh, sw,
                 lambda f, b: f(pos, nrm, noise, p, radius, sh, sw, b),
                 post.ssao_pass, post._ssao_plain),
                ("blur", block, h, w,
                 lambda f, b: f(ao, pos, nrm, p, (1.0, 0.0), h, w, b),
                 post.blur_pass, post._blur_plain),
                ("blur_composite", block, h, w,
                 lambda f, b: f(aoh, pos, nrm, p, cam, h, w, b),
                 post.blur_composite_pass, post._blur_composite_plain),
            )
            sums = [0.0, 0.0, 0.0]
            for name, blk, th, tw, call, kernel_fn, plain_fn in passes:
                before = post.post_kernel.launches
                got = call(kernel_fn, blk)
                torch.cuda.synchronize()
                launches = post.post_kernel.launches - before
                want = call(plain_fn, blk)
                torch.cuda.synchronize()
                equal = bits_equal(torch, got, want)
                err = float((got - want).abs().max())
                errs.append(err)
                ms = event_ms(torch, lambda: call(kernel_fn, blk),
                              POST_TIMED_REPS, queued=True)
                plain_ms = event_ms(torch, lambda: call(plain_fn, blk),
                                    POST_PLAIN_REPS)
                px = got.shape[0] * got.shape[1]
                bound_ms = bound(px * POST_BYTES[name], 0)[0]
                sums = [a + b for a, b in zip(sums, (ms, plain_ms, bound_ms))]
                emit("kernel_vs_plain", kernel="post_kernel", variant=variant,
                     **{"pass": name}, shape=list(got.shape), target=[th, tw],
                     block=blk, gbuffer=[h, w], bits_equal=equal,
                     max_abs_err=err, launches=launches, ms=ms,
                     plain_ms=plain_ms, bound_ms=bound_ms,
                     share=bound_ms / ms, card=card)
                if not equal or launches != 1:
                    fail(f"post_kernel {name} ({variant}) disagrees with its "
                         f"plain version (max_abs_err {err}) or launched "
                         f"{launches} times")
            del gb, pos, nrm, ao, aoh, passes
        torch.cuda.empty_cache()
        if frame_sums is None:
            frame_sums = sums

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=DEPTH, tile_h=32,
                       tile_w=32, algorithm="binned")
    render_frame(scene, cfg, device=dev)
    before = post.post_kernel.launches
    with spans.unit("post_check"):
        img, _ = render_frame(scene, cfg, device=dev)
    torch.cuda.synchronize()
    counted = spans.records("post_check")[-1]["counts"].get("post.kernel")
    launches = post.post_kernel.launches - before
    emit("post_path", launches=launches, span_count=counted,
         image=list(img.shape))
    if launches != 3 or counted != 3:
        fail(f"a frame launched the post kernel {launches} times "
             f"(post.kernel {counted}); 3 expected")

    # The differentiable frame: autograd has to see the post, so the
    # passes take their plain versions on the card.
    leaves = {f.name: getattr(scene.ssao, f.name).detach().clone()
              .requires_grad_(True)
              for f in dataclasses.fields(scene.ssao)}
    grad_scene = dataclasses.replace(
        scene, ssao=dataclasses.replace(scene.ssao, **leaves))
    torch.cuda.reset_peak_memory_stats()
    before = post.post_kernel.launches
    grad_img, _ = render_frame(grad_scene, cfg, device=dev)
    grad_img.sum().backward()
    torch.cuda.synchronize()
    launches = post.post_kernel.launches - before
    grads = {k: None if v.grad is None else float(v.grad)
             for k, v in leaves.items()}
    equal = bits_equal(torch, grad_img.detach(), img)
    # The radius only places NEAREST taps and the thresholds only gate
    # them (`render_frame`'s docstring): no gradient, or zero.
    weighed = ("intensity", "scale", "bias")
    out = dict(launches=launches, image_bits_equal=equal,
               max_abs_err=float((grad_img.detach() - img).abs().max()),
               grads=grads, weighed=list(weighed),
               peak_memory_mb=torch.cuda.max_memory_allocated() / 2**20)
    emit("post_grad_path", **out)
    if (launches != 0 or not equal
            or not all(g is None or math.isfinite(g) for g in grads.values())
            or not all(grads[k] not in (None, 0.0) for k in weighed)):
        fail(f"the differentiable frame's post went wrong: {out}")
    del grad_img, leaves, grad_scene
    return frame_sums, max(errs)


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
    from sphereflake_tpu_torch.ops import pallas_traversal as ptrav
    from sphereflake_tpu_torch.ops.post import post_kernel
    from sphereflake_tpu_torch.ops.recompute_vjp import recompute_vjp
    from sphereflake_tpu_torch.ops.binned import (
        camera_vector,
        trace_pairs_fused_plain,
        trace_pairs_fused_soa,
        trace_pairs_fused_subset,
        trace_pairs_fused_subset_plain,
        trace_pairs_pallas_soa,
        trace_pairs_pallas_soa_plain,
    )
    from sphereflake_tpu_torch.render import (
        _untile_rows,
        render_frame,
        render_gbuffer,
    )
    from sphereflake_tpu_torch.runtime.progressive import (
        progressive_init,
        progressive_prepare,
        progressive_prepare_trimmed,
        progressive_step,
        progressive_tile_ids,
        progressive_tiles_init,
        progressive_tiles_step,
        tile_progressive_composite,
        tile_progressive_gbuffer,
    )

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    t_script = time.perf_counter()

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
        for lib in libs.values():
            emit("sass", library=os.path.basename(lib),
                 kernels=sass_summary(lib, kernels.find_nvcc()))
    emit(
        "device", card=card, torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0],
        build_seconds=round(build_s, 2), libraries=sorted(libs),
    )

    # ---- phase 1b: the post chain's kernels ------------------------
    # (ms, plain_ms, bound_ms) of the 1080p frame's passes; max_abs_err
    post_chain, post_err = post_phase(torch, dev, card)

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
    shallow["bits_equal"] = bits_equal(torch, out_k, out_p)
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
            or shallow["max_abs_err"] > ABS_ERR_MAX
            or not shallow["bits_equal"]):
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
    deep["bits_equal"] = bits_equal(torch, dout_k, dout_p)
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
            or not bool((dm_k == dm_p).all()) or not deep["bits_equal"]):
        fail(f"pairs_kernel (deep) disagrees with its plain version: {deep}")

    # -- subset mode at the frameless operating point: the trimmed table
    # and the 1,024 Sobol tile ids of step 0 (seed 1) ------------------
    limits = dict(agree_min=AGREE_MIN, abs_err_max=ABS_ERR_MAX)
    with torch.no_grad():
        prep_full = progressive_prepare(scene, cfg, device=dev)
        prep_trim = progressive_prepare_trimmed(scene, cfg, device=dev)
        tpairs, tstarts, tlens, _tovf = prep_trim
        st0 = progressive_tiles_init(cfg, seed=1, device=dev)
        ids, _, _ = progressive_tile_ids(st0, cfg, TILES_PER_STEP)
        ids_l = ids.long()
        k2_args = (cam, tpairs, tstarts, tlens, ids, cfg)
        k2s_k, k2s_mk = trace_pairs_fused_subset(*k2_args, shade_only=True)
        k2c_k, k2c_mk = trace_pairs_fused_subset(*k2_args)
        k1_trim, _ = trace_pairs_fused_soa(cam, tpairs, tstarts, tlens, cfg)
        torch.cuda.synchronize()
        k2s_p, k2s_mp = trace_pairs_fused_subset_plain(*k2_args, shade_only=True)
        k2c_p, k2c_mp = trace_pairs_fused_subset_plain(*k2_args)
    if k2s_k.shape != (TILES_PER_STEP, 7, 8, 128) or not k2s_k.is_cuda:
        fail(f"subset kernel output {tuple(k2s_k.shape)} on {k2s_k.device}")
    k2_lens_sum = int(tlens[ids_l].sum())
    trim_dropped = 1.0 - int(tlens.sum()) / lens_sum
    k2_shade = compare_shaded(torch, k2s_k, k2s_p)
    k2_coded = compare_rows(torch, k2c_k, k2c_p, deep=False)
    gathered = k1_trim[ids_l]
    k2_eq_k1 = bool(torch.equal(k2c_k, gathered)) and bool(
        torch.equal(k2s_k, gathered[:, [0, 2, 3, 4, 5, 6, 7]])
    )
    for variant, res, m_eq in (
        ("shade_only", k2_shade, bool((k2s_mk == k2s_mp).all())),
        ("coded", k2_coded, bool((k2c_mk == k2c_mp).all())),
    ):
        emit(
            "kernel_vs_plain", kernel="pairs_kernel_subset", variant=variant,
            shape=dict(ids=TILES_PER_STEP, distinct_ids=int(ids.unique().numel()),
                       pairs_walked=k2_lens_sum,
                       pairs_per_tile=round(k2_lens_sum / TILES_PER_STEP, 2),
                       trim_dropped_fraction=trim_dropped),
            metrics_equal=m_eq, equals_full_grid_rows_at_ids=k2_eq_k1,
            limits=limits, **res,
        )
        check_agreement(f"pairs_kernel_subset ({variant})", res, m_eq)
    if not k2_eq_k1:
        fail("subset rows differ from the full-grid rows gathered at the ids")
    # Every tile of the frame as one id list (more rows than one piece of
    # the prologue's prefix sum): the full-grid rows, row for row.
    with torch.no_grad():
        all_ids = torch.arange(n_tiles, dtype=torch.int32, device=dev)
        k2_all, k2_all_m = trace_pairs_fused_subset(
            cam, tpairs, tstarts, tlens, all_ids, cfg
        )
    k2_all_eq = bool(torch.equal(k2_all, k1_trim)) and bool(
        torch.equal(k2_all_m[:, 0, 0], tlens)
    )
    emit("kernel_vs_plain", kernel="pairs_kernel_subset",
         variant="every tile as one id list", shape=dict(ids=n_tiles),
         equals_full_grid_rows=k2_all_eq)
    if not k2_all_eq:
        fail("the subset mode on every tile differs from the full grid")

    # Deep variant: ids that repeat and are not sorted.
    import numpy as np

    d_tiles = dcfg.tiles_x * dcfg.tiles_y
    ids_d = torch.from_numpy(
        np.random.default_rng(0).integers(0, d_tiles, 48).astype(np.int32)
    ).to(dev)
    with torch.no_grad():
        k2d_args = (dcam, dpairs, dstarts, dlens, ids_d, dcfg)
        k2ds_k, k2ds_mk = trace_pairs_fused_subset(*k2d_args, shade_only=True)
        k2dc_k, k2dc_mk = trace_pairs_fused_subset(*k2d_args)
        torch.cuda.synchronize()
        k2ds_p, k2ds_mp = trace_pairs_fused_subset_plain(*k2d_args, shade_only=True)
        k2dc_p, k2dc_mp = trace_pairs_fused_subset_plain(*k2d_args)
    k2d_shade = compare_shaded(torch, k2ds_k, k2ds_p)
    k2d_coded = compare_rows(torch, k2dc_k, k2dc_p, deep=True)
    k2d_eq_k1 = bool(torch.equal(k2dc_k, dout_k[ids_d.long()]))
    for variant, res, m_eq in (
        ("deep shade_only", k2d_shade, bool((k2ds_mk == k2ds_mp).all())),
        ("deep coded", k2d_coded, bool((k2dc_mk == k2dc_mp).all())),
    ):
        emit(
            "kernel_vs_plain", kernel="pairs_kernel_subset", variant=variant,
            shape=dict(ids=int(ids_d.numel()),
                       distinct_ids=int(ids_d.unique().numel())),
            metrics_equal=m_eq, equals_full_grid_rows_at_ids=k2d_eq_k1,
            limits=limits, **res,
        )
        check_agreement(f"pairs_kernel_subset ({variant})", res, m_eq)
    if k2dc_k.shape[1] != 9 or not k2d_eq_k1:
        fail("deep subset rows differ from the full-grid rows at the ids")

    # -- ray-bundle mode: the bundles and spans of one sample step ------
    def bundle_check(variant, b_scene, b_cfg, batch, prepared):
        state = progressive_init(b_cfg, seed=1, device=dev)
        _, calls = record_bundles(binned, lambda: progressive_step(
            state, b_scene, b_cfg, batch_size=batch, prepared=prepared
        ))
        if len(calls) != 1:
            fail(f"a sample step made {len(calls)} ray-bundle calls")
        args = calls[0]
        with torch.no_grad():
            out_kk, m_kk = trace_pairs_pallas_soa(*args)
            torch.cuda.synchronize()
            out_pp, m_pp = trace_pairs_pallas_soa_plain(*args)
        res = compare_rows(torch, out_kk, out_pp, deep=b_cfg.max_depth >= 7)
        m_eq = bool((m_kk == m_pp).all())
        b_lens = args[3]
        emit(
            "kernel_vs_plain", kernel="pairs_kernel_dirs", variant=variant,
            shape=dict(bundles=int(b_lens.numel()), samples=batch,
                       pairs_walked=int(b_lens.sum()),
                       longest_span=int(b_lens.max())),
            metrics_equal=m_eq, limits=limits, **res,
        )
        check_agreement(f"pairs_kernel_dirs ({variant})", res, m_eq)
        return args, out_kk, res

    k3_args, k3_out, k3_shallow = bundle_check(
        "shallow", scene, cfg, SAMPLE_BATCH, prep_full
    )
    _, k3d_out, k3_deep = bundle_check(
        "deep", dscene, dcfg, 8192,
        progressive_prepare(dscene, dcfg, device=dev),
    )
    if k3_out.shape != (SAMPLE_BATCH // 1024, 5, 8, 128) or k3d_out.shape[1] != 6:
        fail("ray-bundle kernel output has the wrong shape")

    # -- the item decomposition of the two modes, on constructed tables:
    # exact ties across item boundaries, spans of exactly one item and one
    # pair more, an empty span, ids that repeat; bit for bit ------------
    with torch.no_grad():
        item_results = item_cases(torch, binned, dev)
    for kernel_name, res in item_results.items():
        emit("kernel_vs_plain", kernel=kernel_name,
             variant="constructed spans: ties across items, C, C + 1, empty, "
                     "one pair; shallow and deep",
             equal=not res["unequal"], **res)
        if res["unequal"] or not res["cases"]:
            fail(f"{kernel_name} differs from its plain version on the "
                 f"constructed spans: {res['unequal']}")
    ITEM_PAIRS = binned.ITEM_PAIRS

    # -- the traversal kernel, on the launches the per-tile path makes ---
    pcfg = dataclasses.replace(cfg, algorithm="pallas")

    def traverse_launch_args(step):
        """The arguments of the one traversal launch `step()` makes."""
        _, calls = record_launches(ptrav, "_launch_traverse_kernel", step)
        if len(calls) != 1:
            fail(f"{len(calls)} traversal launches in a step, expected 1")
        return calls[0]

    def traverse_check(variant, args, shape):
        """Run the wrapper on the recorded launch's tensors and hold it
        against the plain version."""
        t_cfg = args[-1]
        with torch.no_grad():
            out_kk, m_kk = ptrav.trace_tiles_pallas_soa(*args)
            torch.cuda.synchronize()
            out_pp, m_pp = ptrav.trace_tiles_pallas_soa_plain(
                *args[:-1], dataclasses.replace(t_cfg, tile_batch=128)
            )
        res = compare_traversal(torch, out_kk, m_kk, out_pp, m_pp)
        n_bundles = int(args[0].shape[0])
        emit(
            "kernel_vs_plain", kernel="traverse_kernel", variant=variant,
            shape=dict(bundles=n_bundles,
                       level_caps=ptrav.level_caps(t_cfg),
                       queue_pool_mb=n_bundles * 4 * ptrav.queue_words(t_cfg)
                       / 1e6,
                       panels_mb_per_node_block=4 * ptrav.panel_words(t_cfg)
                       / 1e6,
                       **shape),
            limits=dict(abs_err_max=ABS_ERR_MAX), **res,
        )
        if not (res["hit_equal"] and res["codes_equal"]
                and res["metrics_equal"] and res["miss_t_equal"]
                and res["t_bits_equal"]
                and res["max_abs_err"] <= ABS_ERR_MAX):
            fail(f"traverse_kernel ({variant}) disagrees with its plain "
                 f"version: {res}")
        return out_kk, m_kk, res

    k4_args = traverse_launch_args(
        lambda: render_gbuffer(scene, pcfg, device=dev)
    )
    k4_out, k4_m, k4_frame = traverse_check(
        "frame 1080p d6", k4_args,
        dict(width=WIDTH, height=HEIGHT, depth=DEPTH),
    )
    k4s_args = traverse_launch_args(lambda: progressive_step(
        progressive_init(pcfg, seed=1, device=dev), scene, pcfg,
        batch_size=SAMPLE_BATCH,
    ))
    k4s_out, k4s_m, k4_sobol = traverse_check(
        "sobol bundles 1080p d6", k4s_args, dict(samples=SAMPLE_BATCH)
    )
    d7cfg = RenderConfig(
        width=256, height=128, max_depth=7, tile_h=32, tile_w=32,
        algorithm="pallas",
    )
    _, _, k4_dive = traverse_check(
        "dive d7",
        traverse_launch_args(lambda: render_gbuffer(dscene, d7cfg, device=dev)),
        dict(width=256, height=128, depth=7),
    )
    ocfg = RenderConfig(
        width=512, height=256, max_depth=4, tile_h=32, tile_w=32,
        max_frontier=128, algorithm="pallas",
    )
    _, _, k4_over = traverse_check(
        "overflow d4 max_frontier 128",
        traverse_launch_args(lambda: render_gbuffer(scene, ocfg, device=dev)),
        dict(width=512, height=256, depth=4, max_frontier=128),
    )
    if k4_out.shape != (n_tiles, 2, 8, 128) or k4s_out.shape[0] != 64:
        fail("traversal kernel output has the wrong shape")
    if k4_frame["overflow"] or k4_dive["deepest_level"] != 7:
        fail(f"traversal cases off: {k4_frame}, {k4_dive}")
    if k4_over["overflow"] <= 0:
        fail("the constructed overflow case did not overflow")
    # Wider frontiers: the same kernel body with larger scratch. The frame
    # does not overflow at 1,024, so a wider frontier must not change a bit
    # of it.
    # The Sobol bundles do overflow (1,024 pixels spread over some 32
    # tiles: the pyramid around their bounding cone takes in much of the
    # fractal) and still do at 16,384, where more nodes reach the deeper
    # levels; the line reports what is dropped at either frontier.
    wide_cfg = dataclasses.replace(pcfg, max_frontier=2048)
    k4w_args = (*k4_args[:-1], wide_cfg)
    k4w_out, k4w_m, k4_wide = traverse_check(
        "frame 1080p d6, max_frontier 2048", k4w_args,
        dict(width=WIDTH, height=HEIGHT, depth=DEPTH, max_frontier=2048),
    )
    if not (torch.equal(k4w_out, k4_out) and torch.equal(k4w_m, k4_m)):
        fail("a wider frontier changed the frame's traversal")
    _, _, k4_sobol_wide = traverse_check(
        "sobol bundles 1080p d6, max_frontier 16384",
        (*k4s_args[:-1], dataclasses.replace(pcfg, max_frontier=16384)),
        dict(samples=SAMPLE_BATCH, max_frontier=16384),
    )
    if k4_sobol_wide["queue_nodes"] <= k4_sobol["queue_nodes"]:
        fail("a wider frontier did not lengthen the Sobol bundles' queues")
    # An exact tie across the ray launch's items: queue positions 63 and 64.
    straddle_args = straddle_inputs(torch, dev)
    _, _, k4_straddle = traverse_check(
        "constructed tie at queue positions 63 and 64", straddle_args,
        dict(depth=2, tied_positions=[63, 64], item_nodes=ptrav.ITEM_NODES),
    )
    st_codes = ptrav.trace_tiles_pallas_soa(*straddle_args)[0][0, 1]
    k4_straddle["tie_winner_rays"] = int((st_codes == 158.0).sum())
    k4_straddle["tie_loser_rays"] = int((st_codes == 87.0).sum())
    emit("kernel_vs_plain", kernel="traverse_kernel",
         variant="constructed tie at queue positions 63 and 64: winner",
         tie_winner_code=158.0, tie_loser_code=87.0,
         tie_winner_rays=k4_straddle["tie_winner_rays"],
         tie_loser_rays=k4_straddle["tie_loser_rays"])
    if (k4_straddle["tie_winner_rays"] < 500 or k4_straddle["tie_loser_rays"]
            or k4_straddle["queue_nodes"] != 91):
        fail(f"the straddling tie went wrong: {k4_straddle}")

    # ---- phase 3: the main path ------------------------------------
    def frame(i):
        camera = dataclasses.replace(
            scene.camera, yaw=scene.camera.yaw + 1e-7 * i
        )
        return render_frame(
            dataclasses.replace(scene, camera=camera), cfg, device=dev
        )

    trace_pairs_fused_soa.launches = 0
    post_kernel.launches = 0
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
    frames_post = post_kernel.launches
    frames_rendered = FRAMES + CLI_FRAMES + 1
    if rc != 0 or png_bytes < 10000:
        fail(f"CLI run failed: rc={rc}, png of {png_bytes} bytes")
    image, gb = frames[-1]
    m = gb.metrics
    hit_fraction = float(gb.hit.float().mean())
    main_path = dict(
        frames=frames_rendered, launches=launches,
        post_kernel_launches=frames_post, cli_png_bytes=png_bytes,
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
    if launches != frames_rendered or frames_post != 3 * frames_rendered:
        fail(f"pairs_kernel launched {launches} times and post_kernel "
             f"{frames_post} for {frames_rendered} frames")
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

    # ---- phase 3b: the frameless path -------------------------------
    counted = (trace_pairs_fused_soa, trace_pairs_fused_subset,
               trace_pairs_pallas_soa, ptrav.trace_tiles_pallas_soa)

    # The post kernel's launches in each counted run (from its reset to
    # its read), the main paths' count: every run is reset just before.
    post_runs = []

    def reset_counts():
        # The backward's and the post's kernels are reset with the four
        # and read apart (`recompute_vjp.launches`, `post_kernel.launches`,
        # after `read_counts`): `read_counts` stays the four forward
        # kernels' list every phase compares.
        for wrapper in (*counted, recompute_vjp, post_kernel):
            wrapper.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        post_runs.append(post_kernel.launches)
        return [wrapper.launches for wrapper in counted]

    def tile_steps(prepared, steps, seed=1):
        st = progressive_tiles_init(cfg, seed=seed, device=dev)
        for _ in range(steps):
            st = progressive_tiles_step(
                st, scene, cfg, tiles_per_step=TILES_PER_STEP,
                prepared=prepared,
            )
        return st

    reset_counts()
    prepared = progressive_prepare_trimmed(scene, cfg, device=dev)
    st = tile_steps(prepared, GATE_STEPS)
    fl_counts = read_counts()
    covered = int(st.covered.sum())
    _pos_t, _nrm_t, mt_t, _hit_t = tile_progressive_gbuffer(st, cfg)
    pixel_parity = float(torch.isclose(
        mt_t, gb_kernel.min_t, rtol=1e-4, atol=1e-4
    ).float().mean())
    composite = tile_progressive_composite(st, scene, cfg)
    image_full, _gb_full = render_frame(scene, cfg, device=dev)
    composite_err = float((composite - image_full).abs().max())
    st_untrimmed = tile_steps(prep_full, GATE_STEPS)
    trim_invisible = bool(torch.equal(st.rows, st_untrimmed.rows)) and bool(
        torch.equal(st.covered, st_untrimmed.covered)
    )
    frameless = dict(
        steps=GATE_STEPS, tiles_per_step=TILES_PER_STEP, seed=1,
        launches=dict(zip(KERNEL_NAMES, fl_counts)),
        covered=covered, tiles=n_tiles, overflow=int(st.overflow),
        prepare_overflow=int(prepared[3]),
        samples_traced=st.samples_traced, sample_lo=st.sample_lo,
        closest_distance=float(st.closest_distance),
        pixel_parity=pixel_parity, composite_max_abs_err=composite_err,
        trimmed_equals_untrimmed=trim_invisible,
        trim_dropped_fraction=trim_dropped,
        limits=dict(pixel_parity_min=FRAME_HIT_MIN,
                    composite_err_max=COMPOSITE_ERR_MAX),
    )
    emit("frameless_path", **frameless)
    if fl_counts != [1, GATE_STEPS, 0, 0]:
        fail(f"frameless launches {fl_counts}: expected one full-grid launch "
             f"per prepare and one subset launch per step")
    if covered != n_tiles or int(st.overflow) or int(prepared[3]):
        fail(f"frameless run incomplete: {frameless}")
    if pixel_parity < FRAME_HIT_MIN or composite_err > COMPOSITE_ERR_MAX:
        fail(f"frameless buffer diverges from the full render: {frameless}")
    if not trim_invisible:
        fail("the trimmed table changed the accumulated state")
    if st.samples_traced != GATE_STEPS * TILES_PER_STEP * 1024:
        fail(f"samples_traced {st.samples_traced}")

    # The same through the CLI: tile unit, sample unit, moving camera.
    size_args = ["--width", str(WIDTH), "--height", str(HEIGHT),
                 "--depth", str(DEPTH)]
    cli_runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, extra, outputs in (
            ("progressive_tile",
             ["--progressive", str(GATE_STEPS), "--batch",
              str(TILES_PER_STEP * 1024), "--seed", "1"],
             ["out.png"]),
            ("progressive_sample",
             ["--progressive", "4", "--progressive-unit", "sample",
              "--batch", str(SAMPLE_BATCH)],
             ["out.png"]),
            ("animate_frameless",
             ["--animate", "3", "--frameless", "--batch",
              str(TILES_PER_STEP * 1024)],
             [f"out_{i:04d}.png" for i in range(3)]),
        ):
            reset_counts()
            rc = cli_main(size_args + extra + ["-o", os.path.join(tmp, "out.png")])
            cli_runs[name] = dict(
                rc=rc, launches=read_counts(),
                png_bytes=[
                    os.path.getsize(os.path.join(tmp, f))
                    if os.path.exists(os.path.join(tmp, f)) else 0
                    for f in outputs
                ],
            )
            for f in outputs:
                if os.path.exists(os.path.join(tmp, f)):
                    os.remove(os.path.join(tmp, f))
    emit("frameless_cli", **cli_runs)
    expected = dict(
        progressive_tile=[1, GATE_STEPS, 0, 0],
        progressive_sample=[0, 0, 4, 0],
        animate_frameless=[0, 3 * 8, 0, 0],  # 8 steps per camera step
    )
    for name, run in cli_runs.items():
        if run["rc"] != 0 or min(run["png_bytes"]) < 10000:
            fail(f"CLI {name} failed: {run}")
        if run["launches"] != expected[name]:
            fail(f"CLI {name} launched {run['launches']}, "
                 f"expected {expected[name]}")
    path_launches = [
        launches + fl_counts[0] + cli_runs["progressive_tile"]["launches"][0],
        fl_counts[1] + sum(r["launches"][1] for r in cli_runs.values()),
        sum(r["launches"][2] for r in cli_runs.values()),
    ]

    # ---- phase 3c: the per-tile traversal path -----------------------
    def pallas_frame(i):
        camera = dataclasses.replace(
            scene.camera, yaw=scene.camera.yaw + 1e-7 * i
        )
        return render_frame(
            dataclasses.replace(scene, camera=camera), pcfg, device=dev
        )

    PALLAS_FRAMES, PALLAS_CLI_FRAMES = 2, 1
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "pallas.png")
        rc = cli_main(size_args + [
            "--algorithm", "pallas", "--frames", str(PALLAS_CLI_FRAMES),
            "-o", png,
        ])
        png_bytes = os.path.getsize(png) if os.path.exists(png) else 0
    p_frames = [pallas_frame(i) for i in range(PALLAS_FRAMES)]
    p_counts = read_counts()
    p_post = post_kernel.launches
    p_rendered = PALLAS_FRAMES + PALLAS_CLI_FRAMES + 1  # + the CLI's warm-up
    if rc != 0 or png_bytes < 10000:
        fail(f"CLI --algorithm pallas failed: rc={rc}, png of {png_bytes} bytes")
    p_image, _ = p_frames[-1]
    p_gb = render_gbuffer(scene, pcfg, device=dev)
    pm = p_gb.metrics
    cross_hit = float((p_gb.hit == gb_kernel.hit).float().mean())
    cross_both = p_gb.hit & gb_kernel.hit
    cross_t = float(torch.isclose(
        p_gb.min_t, gb_kernel.min_t, rtol=1e-4, atol=1e-4
    )[cross_both].float().mean())
    leaf_radius = 3.0 ** -int(pm.max_depth_reached)
    cross_leaf = float(
        ((p_gb.min_t - gb_kernel.min_t).abs() <= leaf_radius)[cross_both]
        .float().mean()
    )
    pallas_path = dict(
        frames=p_rendered,
        launches=dict(zip(KERNEL_NAMES, p_counts)),
        cli_png_bytes=png_bytes, overflow=int(pm.overflow),
        max_depth_reached=int(pm.max_depth_reached),
        binned_max_depth_reached=int(gb_kernel.metrics.max_depth_reached),
        nodes_visited=int(pm.nodes_visited),
        closest_distance=float(pm.closest_distance),
        hit_fraction=float(p_gb.hit.float().mean()),
        hit_agree_with_binned=cross_hit, min_t_close_to_binned=cross_t,
        min_t_within_leaf_radius=cross_leaf, leaf_radius=leaf_radius,
        image_shape=list(p_image.shape), image_mean=float(p_image.mean()),
        limits=dict(hit_agree_min=CROSS_HIT_MIN,
                    min_t_close_min=CROSS_T_CLOSE_MIN,
                    min_t_within_leaf_radius_min=CROSS_T_LEAF_MIN),
    )
    emit("pallas_path", **pallas_path)
    if p_counts != [0, 0, 0, p_rendered] or p_post != 3 * p_rendered:
        fail(f"pallas frames launched {p_counts} and post_kernel {p_post}: "
             f"expected one traversal launch and three post launches per "
             f"frame ({p_rendered}) and no pair-kernel launch")
    if int(pm.overflow) != 0 or int(pm.max_depth_reached) != int(
            gb_kernel.metrics.max_depth_reached):
        fail(f"pallas frame properties off: {pallas_path}")
    if not (p_image.is_cuda and tuple(p_image.shape) == (HEIGHT, WIDTH, 3)
            and bool(torch.isfinite(p_image).all())):
        fail("the pallas image is not a finite [1080, 1920, 3] tensor on the card")
    if (cross_hit < CROSS_HIT_MIN or cross_t < CROSS_T_CLOSE_MIN
            or cross_leaf < CROSS_T_LEAF_MIN):
        fail(f"the pallas frame diverges from the binned frame: {pallas_path}")

    # The sample unit on the per-tile path, through the CLI.
    PALLAS_STEPS = 4
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "samples.png")
        rc = cli_main(size_args + [
            "--algorithm", "pallas", "--progressive", str(PALLAS_STEPS),
            "--progressive-unit", "sample", "--batch", str(SAMPLE_BATCH),
            "-o", png,
        ])
        png_bytes = os.path.getsize(png) if os.path.exists(png) else 0
    ps_counts = read_counts()
    emit("pallas_cli_sample", rc=rc, launches=ps_counts, png_bytes=png_bytes)
    if rc != 0 or png_bytes < 10000 or ps_counts != [0, 0, 0, PALLAS_STEPS]:
        fail(f"CLI pallas sample unit: rc={rc}, launches {ps_counts}")
    k4_path_launches = p_counts[3] + ps_counts[3]

    # The `fast` fallback once, at a reduced frame, against `pallas`.
    fcfg = RenderConfig(
        width=512, height=256, max_depth=4, tile_h=32, tile_w=32,
        algorithm="fast",
    )
    reset_counts()
    t0 = time.perf_counter()
    f_gb = render_gbuffer(scene, fcfg, device=dev)
    torch.cuda.synchronize()
    fast_s = time.perf_counter() - t0
    f_counts = read_counts()
    fp_gb = render_gbuffer(
        scene, dataclasses.replace(fcfg, algorithm="pallas"), device=dev
    )
    fast_hit = float((f_gb.hit == fp_gb.hit).float().mean())
    fast_both = f_gb.hit & fp_gb.hit
    fast_t = float(torch.isclose(
        f_gb.min_t, fp_gb.min_t, rtol=1e-4, atol=1e-4
    )[fast_both].float().mean())
    emit("fast_path", width=512, height=256, depth=4, seconds=fast_s,
         launches=f_counts, overflow=int(f_gb.metrics.overflow),
         pallas_overflow=int(fp_gb.metrics.overflow),
         max_depth_reached=int(f_gb.metrics.max_depth_reached),
         hit_fraction=float(f_gb.hit.float().mean()),
         hit_agree_with_pallas=fast_hit, min_t_close_to_pallas=fast_t,
         limits=dict(hit_agree_min=CROSS_HIT_MIN))
    if f_counts != [0, 0, 0, 0]:
        fail(f"the fast path launched a kernel: {f_counts}")
    if fast_hit < CROSS_HIT_MIN or int(f_gb.metrics.max_depth_reached) != int(
            fp_gb.metrics.max_depth_reached):
        fail(f"fast diverges from pallas: {fast_hit}")

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
        # The kernel's own time, queued behind a spin kernel (see
        # `event_ms`); `kernel_host_paced_ms` is the same call at the
        # host's pace.
        k1_call = lambda: trace_pairs_fused_soa(cam, pairs, starts, lens, cfg)
        kernel_ms = event_ms(torch, k1_call, 50, queued=True)
        kernel_host_paced_ms = event_ms(torch, k1_call, 50)
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
    bound_ms, bound_by, bytes_ms, ops_ms = bound(bytes_moved, ops)
    emit(
        "times", card=card, width=WIDTH, height=HEIGHT, depth=DEPTH,
        frame_ms=frame_ms, gbuffer_ms=gbuffer_ms,
        rays_per_second=WIDTH * HEIGHT / (frame_ms * 1e-3),
        stages_ms=dict(expand=expand_ms, bin=bin_ms, kernel=kernel_ms,
                       untile=untile_ms, post=post_ms),
        kernel_ms=kernel_ms, kernel_host_paced_ms=kernel_host_paced_ms,
        plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, bytes_ms=bytes_ms, ops_ms=ops_ms,
        bytes_moved=bytes_moved, operations=ops,
        share_of_bound=bound_ms / kernel_ms,
        **item_stats(lens, ITEM_PAIRS),
        launches_per_frame=launches / frames_rendered,
        node_slots=int(nodes["cx"].numel()),
        peak_memory_mb=torch.cuda.max_memory_allocated() / 2**20,
    )

    # ---- phase 4b: times of the frameless path -----------------------
    from sphereflake_tpu_torch.camera import ray_directions
    from sphereflake_tpu_torch.ops.pallas_traversal import resolve_codes
    from sphereflake_tpu_torch.ops.sobol import sobol_sample
    from sphereflake_tpu_torch.runtime.progressive import (
        _cursor_indices,
        _hash_u32,
    )

    with torch.no_grad():
        tile_state = {"st": progressive_tiles_init(cfg, seed=1, device=dev)}

        def tile_step():
            tile_state["st"] = progressive_tiles_step(
                tile_state["st"], scene, cfg, tiles_per_step=TILES_PER_STEP,
                prepared=prep_trim,
            )

        for _ in range(5):
            tile_step()
        step_ms = event_ms(torch, tile_step, 60)
        step_prof = profile_device(torch, tile_step, 5)
        ids_ms = event_ms(
            torch, lambda: progressive_tile_ids(st0, cfg, TILES_PER_STEP), 20
        )
        cam_ms = event_ms(torch, lambda: camera_vector(scene, cfg), 20)
        # The kernels' own times: queued behind a spin kernel, so that the
        # host's pace of enqueueing (slower than the kernel on a busy host)
        # stays out of them. `host_paced_ms` is the same call at that pace.
        k2_shade_call = lambda: trace_pairs_fused_subset(
            *k2_args, shade_only=True)
        k2_coded_call = lambda: trace_pairs_fused_subset(*k2_args)
        k2_ms = event_ms(torch, k2_shade_call, 50, queued=True)
        k2_coded_ms = event_ms(torch, k2_coded_call, 50, queued=True)
        # Once more in the other order: the two flavours within one run.
        k2_again_ms = event_ms(torch, k2_shade_call, 50, queued=True)
        k2_coded_again_ms = event_ms(torch, k2_coded_call, 50, queued=True)
        k2_host_paced_ms = event_ms(torch, k2_shade_call, 50)
        k2_untrimmed_ms = event_ms(
            torch,
            lambda: trace_pairs_fused_subset(
                cam, prep_full[0], prep_full[1], prep_full[2], ids, cfg,
                shade_only=True,
            ),
            50, queued=True,
        )
        k2_plain_ms = event_ms(
            torch,
            lambda: trace_pairs_fused_subset_plain(*k2_args, shade_only=True),
            1,
        )
        # Where the subset mode's time goes: the same ids against empty
        # segments (raygen, shading, stores and the items' fixed costs, no
        # tests), with the longest segments first (the draw at its best
        # balance), and the call's two launches apart.
        no_lens = torch.zeros_like(tlens)
        k2_no_pairs_ms = event_ms(
            torch,
            lambda: trace_pairs_fused_subset(
                cam, tpairs, tstarts, no_lens, ids, cfg,
                shade_only=True,
            ),
            50, queued=True,
        )
        ids_by_len = ids[
            torch.argsort(tlens[ids_l], descending=True)].contiguous()
        k2_longest_first_ms = event_ms(
            torch,
            lambda: trace_pairs_fused_subset(
                cam, tpairs, tstarts, tlens, ids_by_len, cfg, shade_only=True,
            ),
            50, queued=True,
        )
        k2_launches = profile_device(torch, k2_shade_call, 20)
        k2_demand = walk_demand(
            torch, *binned._tile_raygen(cam, ids, cfg), tpairs,
            tstarts[ids_l], tlens[ids_l],
        )

        def scatter():
            rows = st.rows.clone()
            rows[ids_l] = k2s_k
            cov = st.covered.clone()
            cov[ids_l] = True
            return rows, cov, torch.min(k2s_k[:, 0])

        scatter_ms = event_ms(torch, scatter, 20)
        prepare_ms = event_ms(
            torch, lambda: progressive_prepare(scene, cfg, device=dev), 5
        )
        prepare_trimmed_ms = event_ms(
            torch, lambda: progressive_prepare_trimmed(scene, cfg, device=dev),
            5,
        )

        # The sample step and its parts, on the recorded bundles.
        sample_state = {"st": progressive_init(cfg, seed=1, device=dev)}

        def sample_step():
            sample_state["st"] = progressive_step(
                sample_state["st"], scene, cfg, batch_size=SAMPLE_BATCH,
                prepared=prep_full,
            )

        for _ in range(2):
            sample_step()
        sample_step_ms = event_ms(torch, sample_step, 10)
        sample_prof = profile_device(torch, sample_step, 3)

        def pixels():
            idx_lo, idx_hi, _, _ = _cursor_indices(0, 0, SAMPLE_BATCH, dev)
            sx = sobol_sample(idx_lo, 0, _hash_u32(1), idx_hi)
            sy = sobol_sample(idx_lo, 1, _hash_u32(1 ^ 0x9E3779B9), idx_hi)
            px = 1.0 + torch.floor(sx * (WIDTH - 2))
            py = 1.0 + torch.floor(sy * (HEIGHT - 2))
            return px, py, ray_directions(scene.camera, px, py, WIDTH, HEIGHT)

        px_s, py_s, dirs_s = pixels()
        xi, yi = px_s.to(torch.int32), py_s.to(torch.int32)
        pix = yi * WIDTH + xi

        def sorts():
            tile_id = torch.div(yi, 32, rounding_mode="floor") * cfg.tiles_x + (
                torch.div(xi, 32, rounding_mode="floor")
            )
            _, order = torch.sort(tile_id, stable=True)
            inv = torch.empty_like(order)
            inv[order] = torch.arange(SAMPLE_BATCH, device=dev)
            return dirs_s[order], inv, torch.sort(pix, stable=True)

        _, _, (pix_sorted, s_order) = sorts()
        n_bundles = SAMPLE_BATCH // 1024
        groups = torch.movedim(
            k3_args[0].reshape(n_bundles, 3, 1024), 1, 2
        ).contiguous()
        codes = k3_out[:, 1].reshape(n_bundles, 1024)

        def resolve():
            return resolve_codes(
                groups, codes, root, templates, scene.fractal, cfg
            )

        dst = torch.where(
            torch.cat([pix_sorted[:-1] != pix_sorted[1:],
                       torch.ones(1, dtype=torch.bool, device=dev)]),
            pix_sorted, torch.full_like(pix_sorted, WIDTH * HEIGHT),
        )
        sst = sample_state["st"]

        def sample_scatter():
            res = []
            for plane, upd in ((sst.position, dirs_s), (sst.normal, dirs_s),
                               (sst.min_t, px_s)):
                flat = plane.reshape(WIDTH * HEIGHT, *upd.shape[1:])
                pad = torch.zeros((1, *upd.shape[1:]), device=dev)
                out = torch.cat([flat, pad], dim=0)
                out[dst] = upd[s_order]
                res.append(out[: WIDTH * HEIGHT].reshape(plane.shape))
            return res

        sample_split = dict(
            sobol_raygen=event_ms(torch, pixels, 10),
            sorts=event_ms(torch, sorts, 10),
            kernel=event_ms(
                torch, lambda: trace_pairs_pallas_soa(*k3_args), 50,
                queued=True,
            ),
            resolve=event_ms(torch, resolve, 5),
            scatter=event_ms(torch, sample_scatter, 10),
        )
        k3_ms = sample_split["kernel"]
        k3_host_paced_ms = event_ms(
            torch, lambda: trace_pairs_pallas_soa(*k3_args), 50
        )
        k3_plain_ms = event_ms(
            torch, lambda: trace_pairs_pallas_soa_plain(*k3_args), 1
        )

        def dirs_kernel_at(batch):
            """The ray-bundle launch of one sample step of `batch`
            samples: its items and its time."""
            state = progressive_init(cfg, seed=1, device=dev)
            _, calls = record_bundles(binned, lambda: progressive_step(
                state, scene, cfg, batch_size=batch, prepared=prep_full
            ))
            args = calls[0]
            longest = int(args[3].max())
            equals_plain = None  # the plain walk is a Python loop: short spans only
            if longest <= 8000:
                got, got_m = trace_pairs_pallas_soa(*args)
                want, want_m = trace_pairs_pallas_soa_plain(*args)
                equals_plain = bool(torch.equal(got, want)) and bool(
                    torch.equal(got_m, want_m))
                if not equals_plain:
                    fail(f"ray-bundle kernel at {batch} samples differs "
                         f"from its plain version")
            return dict(
                samples=batch, pairs_walked=int(args[3].sum()),
                longest_span=longest, equals_plain=equals_plain,
                ms=event_ms(
                    torch, lambda: trace_pairs_pallas_soa(*args), 50,
                    queued=True,
                ),
                **item_stats(args[3], ITEM_PAIRS),
            )

        k3_other_batches = [dirs_kernel_at(b) for b in (16384, 262144)]
        k3_d = k3_args[0].reshape(n_bundles, 3, 1024)
        k3_demand = walk_demand(
            torch, k3_d[:, 0], k3_d[:, 1], k3_d[:, 2], *k3_args[1:4]
        )

    for prof_view, per_ms, what in (
        (step_prof, step_ms, "progressive_tiles_step 1080p d6, 1024 tiles"),
        (sample_prof, sample_step_ms,
         "progressive_step 1080p d6, 65536 samples"),
    ):
        if prof_view is not None:
            prof_view["idle_share"] = 1.0 - prof_view["busy_ms"] / per_ms
        emit("device_profile", what=what, **(prof_view or {
            "busy_ms": None, "note": "torch.profiler reported no device time"
        }))

    # Bounds from this run's data. Subset mode, shade_only: 7 output rows
    # and the metrics written once; of the pair columns inside the walked
    # segments only the 6 rows it reads (no code row); ids, and one start
    # and one length per id, read once.
    k2_bytes = (
        k2s_k.numel() * 4 + k2s_mk.numel() * 4
        + k2_lens_sum * (tpairs.shape[0] - 1) * 4
        + 3 * TILES_PER_STEP * 4 + cam.numel() * 4
    )
    k2_ops = (k2_lens_sum * 1024 * OPS_PER_TEST_SHADE_ONLY
              + TILES_PER_STEP * 1024 * OPS_PER_RAY)
    k2_bound_ms, k2_bound_by, k2_bytes_ms, k2_ops_ms = bound(k2_bytes, k2_ops)
    # Ray-bundle mode: directions in, raw winner rows out, the pair
    # columns of every span once.
    k3_dirs, k3_pairs, _k3_starts, k3_lens, _ = k3_args
    k3_lens_sum = int(k3_lens.sum())
    k3_bytes = (
        k3_dirs.numel() * 4 + k3_out.numel() * 4 + n_bundles * 16
        + k3_lens_sum * k3_pairs.shape[0] * 4 + 2 * n_bundles * 4
    )
    k3_ops = (k3_lens_sum * 1024 * OPS_PER_TEST
              + n_bundles * 1024 * OPS_PER_RAY_DIRS)
    k3_bound_ms, k3_bound_by, k3_bytes_ms, k3_ops_ms = bound(k3_bytes, k3_ops)
    emit(
        "frameless_times", card=card, width=WIDTH, height=HEIGHT, depth=DEPTH,
        tiles_per_step=TILES_PER_STEP, step_ms=step_ms,
        rays_per_second=TILES_PER_STEP * 1024 / (step_ms * 1e-3),
        step_split_ms=dict(ids=ids_ms, camera_pack=cam_ms, kernel=k2_ms,
                           scatter=scatter_ms),
        prepare_ms=prepare_ms, prepare_trimmed_ms=prepare_trimmed_ms,
        trim_dropped_fraction=trim_dropped,
        subset_kernel=dict(
            ms=k2_ms, coded_ms=k2_coded_ms, ms_again=k2_again_ms,
            coded_ms_again=k2_coded_again_ms, host_paced_ms=k2_host_paced_ms,
            untrimmed_table_ms=k2_untrimmed_ms,
            no_pairs_ms=k2_no_pairs_ms, longest_first_ms=k2_longest_first_ms,
            launches_profile=k2_launches, **k2_demand,
            plain_ms=k2_plain_ms, bound_ms=k2_bound_ms, bound_by=k2_bound_by,
            bytes_ms=k2_bytes_ms, ops_ms=k2_ops_ms, bytes_moved=k2_bytes,
            operations=k2_ops, pairs_walked=k2_lens_sum,
            share_of_bound=k2_bound_ms / k2_ms,
            **item_stats(tlens[ids_l], ITEM_PAIRS),
            untrimmed_table_items=item_stats(prep_full[2][ids_l], ITEM_PAIRS),
        ),
        sample_batch=SAMPLE_BATCH, sample_step_ms=sample_step_ms,
        samples_per_second=SAMPLE_BATCH / (sample_step_ms * 1e-3),
        sample_split_ms=sample_split,
        dirs_kernel=dict(
            ms=k3_ms, host_paced_ms=k3_host_paced_ms, plain_ms=k3_plain_ms,
            bound_ms=k3_bound_ms,
            bound_by=k3_bound_by, bytes_ms=k3_bytes_ms, ops_ms=k3_ops_ms,
            bytes_moved=k3_bytes, operations=k3_ops,
            pairs_walked=k3_lens_sum, longest_span=int(k3_lens.max()),
            share_of_bound=k3_bound_ms / k3_ms,
            **item_stats(k3_lens, ITEM_PAIRS),
            **k3_demand,
            other_batches=k3_other_batches,
        ),
        peak_memory_mb=torch.cuda.max_memory_allocated() / 2**20,
    )

    # ---- phase 4c: times of the per-tile traversal path ---------------
    from sphereflake_tpu_torch.ops.pallas_traversal import resolve_codes_soa
    from sphereflake_tpu_torch.render import (
        _soa_raygen,
        _soa_shade,
        _untile,
    )

    k4_dirs, k4_planes, k4_root, k4_templates, k4_fractal, _ = k4_args
    with torch.no_grad():
        pallas_frame_ms = event_ms(
            torch, lambda: pallas_frame(next(counter)), 5
        )
        pallas_gbuffer_ms = event_ms(
            torch, lambda: render_gbuffer(scene, pcfg, device=dev), 5
        )
        pallas_prof = profile_device(
            torch, lambda: pallas_frame(next(counter)), 3
        )

        def raygen():
            tiled = _soa_raygen(scene, pcfg)
            return tiled, torch.stack(
                [t.reshape(n_tiles, 8, 128) for t in tiled], dim=1
            )

        tiled, _ = raygen()
        level_tab, expand_tab = ptrav._level_tables(
            k4_templates, k4_fractal, pcfg
        )
        enqueue_args = (k4_dirs, k4_planes, k4_root, expand_tab, level_tab, pcfg)
        ks_level_tab, ks_expand = ptrav._level_tables(
            k4s_args[3], k4s_args[4], pcfg
        )
        dxf, dyf, dzf = (t.reshape(-1) for t in tiled)
        codes_flat = k4_out[:, 1].reshape(-1)
        resolved = resolve_codes_soa(
            dxf, dyf, dzf, codes_flat, k4_root, k4_templates, k4_fractal, pcfg
        )
        shaded = _soa_shade(dxf, dyf, dzf, *resolved)

        def untile_planes():
            img = lambda flat: _untile(flat.reshape(n_tiles, 1024), pcfg)
            return (torch.stack([img(c) for c in shaded[:3]], dim=-1),
                    torch.stack([img(c) for c in shaded[3:]], dim=-1),
                    img(resolved[0]), img(resolved[4]))

        pallas_split = dict(
            raygen=event_ms(torch, raygen, 5),
            planes=event_ms(torch, lambda: tile_frustum_planes(
                scene.camera, WIDTH, HEIGHT, 32, 32,
                block_h=pcfg.padded_height, block_w=pcfg.padded_width,
            ), 5),
            kernel_wrapper=event_ms(
                torch, lambda: ptrav.trace_tiles_pallas_soa(*k4_args), 20
            ),
            resolve=event_ms(torch, lambda: resolve_codes_soa(
                dxf, dyf, dzf, codes_flat, k4_root, k4_templates, k4_fractal,
                pcfg,
            ), 5),
            shade=event_ms(
                torch, lambda: _soa_shade(dxf, dyf, dzf, *resolved), 5
            ),
            untile=event_ms(torch, untile_planes, 5),
        )
        # The kernel alone, its level tables prepared (the wrapper's own
        # plain ops are host-bound launches): queued behind a spin kernel,
        # and at the host's pace; then its node and ray launches apart,
        # each queued, on scratch of their own.
        def traverse_times(t_args, t_expand, t_level_tab, t_cfg):
            call = lambda: ptrav._enqueue_traverse_kernel(
                t_args[0], t_args[1], t_args[2], t_expand, t_level_tab, t_cfg)
            n = t_args[0].shape[0]
            dirs = t_args[0]
            if dirs.data_ptr() % 16:
                dirs = dirs.clone()
            scratch = ptrav._traverse_scratch(n, t_cfg, dev)
            out = torch.empty((n, 2, 8, 128), dtype=torch.float32, device=dev)
            met = torch.empty((n, 1, 8), dtype=torch.int32, device=dev)
            nodes = lambda: ptrav._enqueue_nodes(
                t_args[1], t_args[2], t_expand, t_level_tab, t_cfg, scratch,
                met)
            rays = lambda: ptrav._enqueue_rays(
                dirs, t_level_tab, t_cfg, scratch, met, out)
            nodes()
            return dict(
                ms=event_ms(torch, call, 50, queued=True),
                host_paced_ms=event_ms(torch, call, 50),
                nodes_ms=event_ms(torch, nodes, 50, queued=True),
                rays_ms=event_ms(torch, rays, 50, queued=True),
                node_blocks=int(scratch.panels.shape[0]),
                **item_stats(met[:, 0, 0], ptrav.ITEM_NODES),
                **queue_demand(torch, ptrav, dirs, scratch.pool, met,
                               t_level_tab, t_cfg),
            )

        k4_times = traverse_times(k4_args, expand_tab, level_tab, pcfg)
        k4_ms = k4_times["ms"]
        pallas_split["kernel"] = k4_ms
        k4s_times = traverse_times(k4s_args, ks_expand, ks_level_tab, pcfg)
        k4_sobol_ms = k4s_times["ms"]
        k4_wide_ms = event_ms(
            torch, lambda: ptrav._enqueue_traverse_kernel(
                *enqueue_args[:-1], wide_cfg
            ), 20, queued=True,
        )
        # Device memory of one pallas frame: what it allocates past what
        # this script already holds, and the peak.
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        render_gbuffer(scene, pcfg, device=dev)
        torch.cuda.synchronize()
        pallas_peak = torch.cuda.max_memory_allocated()
        pallas_memory = dict(
            frame_peak_mb=(pallas_peak - held) / 2**20,
            process_peak_mb=pallas_peak / 2**20,
            queue_pool_mb=n_tiles * 4 * ptrav.queue_words(pcfg) / 2**20,
            queue_pool_mb_at_2048=n_tiles * 4 * ptrav.queue_words(wide_cfg)
            / 2**20,
            panels_mb=k4_times["node_blocks"] * 4 * ptrav.panel_words(pcfg)
            / 2**20,
        )
        k4_plain_ms = event_ms(
            torch, lambda: ptrav.trace_tiles_pallas_soa_plain(
                *k4_args[:-1], dataclasses.replace(pcfg, tile_batch=128)
            ), 1,
        )
        pstate = {"st": progressive_init(pcfg, seed=1, device=dev)}

        def pallas_sample_step():
            pstate["st"] = progressive_step(
                pstate["st"], scene, pcfg, batch_size=SAMPLE_BATCH
            )

        for _ in range(2):
            pallas_sample_step()
        pallas_sample_step_ms = event_ms(torch, pallas_sample_step, 5)
    if pallas_prof is not None:
        pallas_prof["idle_share"] = 1.0 - pallas_prof["busy_ms"] / pallas_frame_ms
    emit("device_profile", what="render_frame 1080p d6, algorithm=pallas",
         **(pallas_prof or {
             "busy_ms": None, "note": "torch.profiler reported no device time"
         }))

    def traverse_bound(args, out, m):
        """Bound of one traversal launch from its own metrics: every ray
        tests its bundle's whole queue; the expansion examines 9 children
        of every queued node above the last level."""
        col = m[:, 0].long()
        qlen = int(col[:, 0].sum())
        parents = qlen - int(col[:, 3].sum())
        moved = (args[0].numel() + args[1].numel() + out.numel()
                 + m.numel()) * 4
        operations = (qlen * 1024 * OPS_PER_TRAVERSE_TEST
                      + 9 * parents * OPS_PER_CHILD)
        return (*bound(moved, operations), moved, operations, qlen)

    (k4_bound_ms, k4_bound_by, k4_bytes_ms, k4_ops_ms, k4_bytes, k4_ops,
     k4_qlen) = traverse_bound(k4_args, k4_out, k4_m)
    (k4s_bound_ms, k4s_bound_by, _, _, k4s_bytes, k4s_ops,
     k4s_qlen) = traverse_bound(k4s_args, k4s_out, k4s_m)
    emit(
        "pallas_times", card=card, width=WIDTH, height=HEIGHT, depth=DEPTH,
        max_frontier=pcfg.max_frontier, pallas_frame_ms=pallas_frame_ms,
        pallas_gbuffer_ms=pallas_gbuffer_ms,
        rays_per_second=WIDTH * HEIGHT / (pallas_frame_ms * 1e-3),
        pallas_split_ms=pallas_split,
        traverse_kernel=dict(
            **k4_times, wrapper_ms=pallas_split["kernel_wrapper"],
            wide_frontier_ms=k4_wide_ms, plain_ms=k4_plain_ms,
            bound_ms=k4_bound_ms, bound_by=k4_bound_by, bytes_ms=k4_bytes_ms,
            ops_ms=k4_ops_ms, bytes_moved=k4_bytes, operations=k4_ops,
            queue_nodes=k4_qlen, longest_queue=k4_frame["longest_queue"],
            bundles=n_tiles, share_of_bound=k4_bound_ms / k4_ms,
        ),
        memory=pallas_memory,
        pallas_sample_step_ms=pallas_sample_step_ms,
        samples_per_second=SAMPLE_BATCH / (pallas_sample_step_ms * 1e-3),
        traverse_kernel_sobol=dict(
            **k4s_times, bound_ms=k4s_bound_ms, bound_by=k4s_bound_by,
            bytes_moved=k4s_bytes, operations=k4s_ops, queue_nodes=k4s_qlen,
            longest_queue=k4_sobol["longest_queue"], bundles=64,
            share_of_bound=k4s_bound_ms / k4_sobol_ms,
        ),
        peak_memory_mb=torch.cuda.max_memory_allocated() / 2**20,
    )

    # ---- phase 4b: gradients and fitting ----------------------------
    grad_launches = gradient_phase(
        torch, dev, scene, cfg, card, reset_counts, read_counts
    )
    vjp = grad_launches["vjp"]
    path_launches[0] += (grad_launches["fit_pairs_kernel"]
                         + grad_launches["pairs_kernel"])
    k4_path_launches += grad_launches["traverse_kernel"]

    # ---- phase 4d: the parity traversal, the camera path, the profiler
    strict_phase(torch, dev, scene, gb_kernel, reset_counts, read_counts)
    k4_path_launches += strict_grad_phase(torch, dev, scene, reset_counts,
                                          read_counts)
    path_launches[0] += animate_phase(torch, dev, scene, cfg, cli_main,
                                      reset_counts, read_counts, size_args)
    path_launches[0] += profile_phase(cli_main, reset_counts, read_counts,
                                      size_args)

    # ---- phase 4e: the multi-device layer and the native host library
    multi = [0, 0, 0, 0]
    for counts in (
        sharded_phase(torch, dev, scene, cfg, card, reset_counts,
                      read_counts),
        sharded_frameless_phase(torch, dev, scene, cfg, card, reset_counts,
                                read_counts),
        frames_dp_phase(torch, dev, scene, cfg, card, reset_counts,
                        read_counts),
        sharded_fit_phase(torch, dev, scene, cfg, card, reset_counts,
                          read_counts),
        multiprocess_phase(torch, dev, scene, cfg, card),
        native_phase(torch, dev, scene, cfg, card, cli_main, reset_counts,
                     read_counts, size_args),
    ):
        multi = [m + c for m, c in zip(multi, counts)]

    # ---- phase 4f: the reference's measurement programs
    bench_counts = bench_phase(torch, dev, card, reset_counts, read_counts)
    big_counts, big_checks = bigframe_phase(torch, dev, scene, card,
                                            reset_counts, read_counts)
    scaling_counts = scaling_phase(torch, dev, card, reset_counts,
                                   read_counts)
    for counts in (bench_counts, big_counts, scaling_counts):
        multi = [m + c for m, c in zip(multi, counts)]
    path_launches = [p + m for p, m in zip(path_launches, multi)]
    k4_path_launches += multi[3]

    # ---- phase 5: the kernels line, the card, the verdict ----------
    # The three launch modes of one source, the traversal kernel and the
    # backward's kernel (its `launches`: the 4K fit's steps and its timed
    # step, each counted from 0 and gated in `fit_path`; it replaces no
    # TPU kernel). For the four forward kernels `launches` sums the main paths' runs (each counted from 0: frames,
    # the 24-step frameless run, the three frameless CLI runs; pallas
    # frames and the CLI's pallas sample unit; the 4K fit and the
    # 1080p gradients with the kernels; the pallas side of the
    # pallas-vs-strict gradient check; the full-frame camera paths and
    # the profiled CLI run; the multi-device phases, the two workers'
    # launches included); no single PyTorch call computes any of them,
    # so `library_ms` is null. The post kernel (it replaces no TPU kernel
    # either): `launches` sums the main paths' runs, each counted from 0
    # (the frames, and every run `read_counts` closes: the frameless and
    # pallas runs, the camera paths, the profiled CLI run, the
    # multi-device phases, bench, bigframe and scaling; the gated ones 3 a
    # one-card frame, 12 a 2x2 mesh frame); `max_abs_err` is the largest of
    # its `kernel_vs_plain` lines; ms, plain_ms and bound_ms are the 1080p
    # frame's three passes summed.
    source = "sphereflake_tpu_torch/csrc/pairs_kernel.cu"
    print(json.dumps({"kernels": [
        {
            "name": "pairs_kernel", "route": "cuda", "source": source,
            "replaces": "sphereflake_tpu/ops/binned.py:1064",
            "launches": path_launches[0],
            "max_abs_err": max(r["max_abs_err"] for r in (
                shallow, deep, *big_checks)),
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
        },
        {
            "name": "pairs_kernel_subset", "route": "cuda", "source": source,
            "replaces": "sphereflake_tpu/ops/binned.py:1147",
            "launches": path_launches[1],
            "max_abs_err": max(r["max_abs_err"] for r in (
                k2_shade, k2_coded, k2d_shade, k2d_coded)),
            "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound_ms,
            "bound_by": k2_bound_by, "library_ms": None,
        },
        {
            "name": "pairs_kernel_dirs", "route": "cuda", "source": source,
            "replaces": "sphereflake_tpu/ops/binned.py:973",
            "launches": path_launches[2],
            "max_abs_err": max(k3_shallow["max_abs_err"],
                               k3_deep["max_abs_err"]),
            "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound_ms,
            "bound_by": k3_bound_by, "library_ms": None,
        },
        {
            "name": "traverse_kernel", "route": "cuda",
            "source": "sphereflake_tpu_torch/csrc/traverse_kernel.cu",
            "replaces": "sphereflake_tpu/ops/pallas_traversal.py:416",
            "launches": k4_path_launches,
            "max_abs_err": max(r["max_abs_err"] for r in (
                k4_frame, k4_sobol, k4_dive, k4_over, k4_wide,
                k4_sobol_wide, k4_straddle)),
            "ms": k4_ms, "plain_ms": k4_plain_ms, "bound_ms": k4_bound_ms,
            "bound_by": k4_bound_by, "library_ms": None,
        },
        {
            "name": "recompute_vjp", "route": "cuda",
            "source": "sphereflake_tpu_torch/csrc/recompute_vjp.cu",
            "replaces": None,
            "launches": grad_launches["fit_recompute_vjp"],
            "max_abs_err": vjp["max_abs_err"],
            "ms": vjp["ms"], "plain_ms": vjp["plain_ms"],
            "bound_ms": vjp["bound_ms"], "bound_by": vjp["bound_by"],
            "library_ms": None,
        },
        {
            "name": "post_kernel", "route": "cuda",
            "source": "sphereflake_tpu_torch/csrc/post_kernel.cu",
            "replaces": None, "launches": frames_post + sum(post_runs),
            "max_abs_err": post_err, "ms": post_chain[0],
            "plain_ms": post_chain[1], "bound_ms": post_chain[2],
            "bound_by": "bytes",
            "library_ms": None,
        },
    ]}), flush=True)
    emit("total", seconds=round(time.perf_counter() - t_script, 1))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
