#!/usr/bin/env python3
"""How closely do the `pallas` and the `binned` frame of one scene agree?

The two algorithms choose candidates differently (per-tile frustum planes
against screen binning) and compute the hit distance by differently
associated f32 sums, so they are compared by fractions, not bit for bit:
hit-mask agreement, `min_t` within rtol = atol = 1e-4 on the common hits,
and `min_t` within one radius of the deepest level reached.

    # the port, its kernels' plain versions on the CPU (or --device cuda),
    # with the per-level table and the share of equal winners
    python tools/torch_cross_algorithm.py --width 480 --height 270 --depth 6
    # the JAX reference package on its CPU backend (kernels interpreted)
    python tools/torch_cross_algorithm.py --package reference --width 480 \
        --height 270 --depth 6

    # each package's frames to a file, then port vs reference per
    # algorithm (hit masks, equal winner codes, min_t within 1e-4, by
    # the level of the winner)
    python tools/torch_cross_algorithm.py --dump port.npz
    python tools/torch_cross_algorithm.py --package reference --dump ref.npz
    python tools/torch_cross_algorithm.py --compare port.npz ref.npz

Prints one JSON line. One process imports one package only (`--compare`
imports neither).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def summary(hit_b, hit_p, t_b, t_p, leaf_radius):
    """Fractions over numpy arrays [H, W] of the two frames."""
    import numpy as np

    both = hit_b & hit_p
    return dict(
        pixels=int(hit_b.size), common_hits=int(both.sum()),
        hit_agree=float((hit_b == hit_p).mean()),
        min_t_close=float(
            np.isclose(t_b, t_p, rtol=1e-4, atol=1e-4)[both].mean()
        ),
        min_t_within_leaf_radius=float(
            (np.abs(t_b - t_p) <= leaf_radius)[both].mean()
        ),
        leaf_radius=leaf_radius,
    )


def reference_frames(kw, max_frontier):
    """The reference package's binned and pallas frames of the default
    scene: min_t, winner codes (binned: lo + hi * 9^7) as [H, W] numpy
    arrays, and each frame's metrics."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from sphereflake_tpu import render
    from sphereflake_tpu.camera import corner_rays, tile_frustum_planes
    from sphereflake_tpu.config import RenderConfig, default_scene
    from sphereflake_tpu.models.sphereflake import child_templates, root_frame
    from sphereflake_tpu.ops.binned import binned_gbuffer
    from sphereflake_tpu.ops.pallas_traversal import trace_tiles_pallas_soa

    scene = default_scene()
    bcfg = RenderConfig(algorithm="binned", **kw)
    pcfg = RenderConfig(
        algorithm="pallas", max_frontier=max_frontier, tile_batch=4, **kw
    )
    T = bcfg.tiles_y * bcfg.tiles_x
    image = lambda flat: np.asarray(render._untile(flat.reshape(T, 1024), bcfg))
    b = jax.jit(lambda s: binned_gbuffer(
        (bcfg, bcfg.width, bcfg.height, True), s, (0.0, 0.0)
    ))(scene)
    p = render.render_gbuffer(scene, pcfg)

    # The pallas frame's winner codes: its raygen and traversal call.
    def codes(s):
        origin, tl, tr, bl = corner_rays(s.camera, pcfg.width / pcfg.height)
        ex, ey = tr - tl, bl - tl
        u = jnp.arange(pcfg.padded_width, dtype=jnp.float32)[None, :] / pcfg.width
        v = jnp.arange(pcfg.padded_height, dtype=jnp.float32)[:, None] / pcfg.height
        comps = [(tl[a] + (ex[a] * u + ey[a] * v)) - origin[a] for a in range(3)]
        dnorm = jnp.sqrt(comps[0] ** 2 + comps[1] ** 2 + comps[2] ** 2)
        tiled = [render._tile(c / dnorm, pcfg) for c in comps]
        planes = tile_frustum_planes(
            s.camera, pcfg.width, pcfg.height, pcfg.tile_h, pcfg.tile_w,
            block_h=pcfg.padded_height, block_w=pcfg.padded_width,
        )
        out, m = trace_tiles_pallas_soa(
            jnp.stack([t.reshape(T, 8, 128) for t in tiled], axis=1), planes,
            root_frame(s.camera.position), child_templates(s.fractal),
            s.fractal, pcfg, interpret=True,
        )
        return out[:, 1].reshape(-1), m

    code_p, m = jax.jit(codes)(scene)
    lo, hi = image(b[8]), image(b[9])
    return dict(
        binned_min_t=image(b[0]),
        binned_code=lo.astype(np.float64) + hi.astype(np.float64) * 9.0**7,
        pallas_min_t=np.asarray(p.min_t), pallas_code=image(code_p),
        binned_overflow=int(np.asarray(b[10])[..., 1].sum() + b[11]),
        pallas_overflow=int(np.asarray(m)[:, 0, 1].sum()),
        max_depth_reached=int(np.asarray(m)[:, 0, 2].max()),
    )


def run_reference(kw, max_frontier):
    """(frames, summary) of the reference package, as `run_port`."""
    f = reference_frames(kw, max_frontier)
    depth = f["max_depth_reached"]
    hit_b, hit_p = f["binned_code"] >= 1.0, f["pallas_code"] >= 1.0
    return f, dict(
        overflow=dict(binned=f["binned_overflow"],
                      pallas=f["pallas_overflow"]),
        max_depth_reached=depth,
        **summary(hit_b, hit_p, f["binned_min_t"], f["pallas_min_t"],
                  3.0 ** -depth),
        same_winner=float(
            (f["binned_code"] == f["pallas_code"])[hit_b & hit_p].mean()
        ),
    )


def code_level(code):
    """Level of a sentinel-prefixed winner code: floor(log9)."""
    import numpy as np

    return sum((code >= 9.0 ** k).astype(np.int64) for k in range(1, 14))


def compare(port_path, ref_path):
    """Port vs reference per algorithm on the same frame: hit masks,
    equal winner codes and min_t within rtol = atol = 1e-4 on the common
    hits, by the level of the reference's winner."""
    import numpy as np

    port, ref = np.load(port_path), np.load(ref_path)
    out = {}
    for alg in ("binned", "pallas"):
        t_q, t_r = port[f"{alg}_min_t"], ref[f"{alg}_min_t"]
        c_q, c_r = port[f"{alg}_code"], ref[f"{alg}_code"]
        hit_q, hit_r = c_q >= 1.0, c_r >= 1.0
        both = hit_q & hit_r
        same = c_q == c_r
        close = np.isclose(t_q, t_r, rtol=1e-4, atol=1e-4)
        level = code_level(c_r)
        out[alg] = dict(
            common_hits=int(both.sum()),
            hit_agree=float((hit_q == hit_r).mean()),
            same_code=float(same[both].mean()),
            min_t_close=float(close[both].mean()),
            min_t_close_given_same_code=float(close[both & same].mean()),
            max_abs_err_given_same_code=float(
                np.abs(t_q - t_r)[both & same].max()
            ),
            by_level_of_the_reference_winner={
                int(lv): dict(
                    hits=int((both & (level == lv)).sum()),
                    same_code=float(same[both & (level == lv)].mean()),
                    min_t_close=float(close[both & (level == lv)].mean()),
                )
                for lv in range(int(level.max()) + 1)
                if (both & (level == lv)).any()
            },
        )
    return out


def run_port(kw, max_frontier, device):
    import numpy as np
    import torch

    from sphereflake_tpu_torch.camera import tile_frustum_planes
    from sphereflake_tpu_torch.config import RenderConfig, default_scene
    from sphereflake_tpu_torch.models.sphereflake import (
        child_templates,
        root_frame,
    )
    from sphereflake_tpu_torch.ops.binned import band_fronts, binned_gbuffer
    from sphereflake_tpu_torch.ops.pallas_traversal import (
        resolve_codes_soa,
        trace_tiles_pallas_soa,
    )
    from sphereflake_tpu_torch.render import _soa_raygen, _untile

    scene = default_scene(device)
    bcfg = RenderConfig(algorithm="binned", **kw)
    pcfg = RenderConfig(
        algorithm="pallas", max_frontier=max_frontier, tile_batch=64, **kw
    )
    T = pcfg.tiles_y * pcfg.tiles_x
    image = lambda flat: _untile(flat.reshape(T, 1024), pcfg).cpu().numpy()
    with torch.no_grad():
        b = binned_gbuffer(bcfg, bcfg.width, bcfg.height, scene, (0.0, 0.0),
                           band_fronts(scene, bcfg, bcfg.width, bcfg.height,
                                       0.0, [0.0])[0])
        t_b, code_b = image(b[0]), image(b[8])
        b_overflow = int(b[10][..., 1].sum()) + int(b[11])
        tiled = _soa_raygen(scene, pcfg)
        root = root_frame(scene.camera.position)
        templates = child_templates(scene.fractal)
        planes = tile_frustum_planes(
            scene.camera, pcfg.width, pcfg.height, 32, 32,
            block_h=pcfg.padded_height, block_w=pcfg.padded_width,
        )
        out, m = trace_tiles_pallas_soa(
            torch.stack([t.reshape(T, 8, 128) for t in tiled], dim=1),
            planes.contiguous(), root, templates, scene.fractal, pcfg,
        )
        dx, dy, dz = (t.reshape(-1) for t in tiled)
        resolved = resolve_codes_soa(
            dx, dy, dz, out[:, 1].reshape(-1), root, templates, scene.fractal,
            pcfg,
        )
        t_p, code_p = image(resolved[0]), image(out[:, 1])
    frames = dict(
        binned_min_t=t_b, binned_code=code_b.astype(np.float64)
        + image(b[9]).astype(np.float64) * 9.0**7,
        pallas_min_t=t_p, pallas_code=code_p,
    )
    hit_b, hit_p = code_b >= 1.0, code_p >= 1.0
    both = hit_b & hit_p
    depth = int(m[:, 0, 2].max())
    # Level of the pallas winner: floor(log9) of its sentinel-prefixed code.
    level = sum((code_p >= 9.0 ** k).astype(np.int64) for k in range(1, 8))
    close = np.isclose(t_b, t_p, rtol=1e-4, atol=1e-4)
    same = code_b == code_p
    return frames, dict(
        device=str(device),
        overflow=dict(binned=b_overflow, pallas=int(m[:, 0, 1].sum())),
        max_depth_reached=depth,
        **summary(hit_b, hit_p, t_b, t_p, 3.0 ** -depth),
        same_winner=float(same[both].mean()),
        min_t_close_given_same_winner=float(close[both & same].mean()),
        by_level_of_the_pallas_winner={
            int(l): dict(hits=int((both & (level == l)).sum()),
                         min_t_close=float(close[both & (level == l)].mean()),
                         same_winner=float(same[both & (level == l)].mean()))
            for l in range(depth + 1) if (both & (level == l)).any()
        },
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("port", "reference"), default="port")
    ap.add_argument("--device", default="cpu", help="port only: cpu or cuda")
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--max-frontier", type=int, default=16384,
                    help="wide enough that the pallas frame drops nothing")
    ap.add_argument("--dump", metavar="NPZ",
                    help="also write both frames (min_t, winner codes)")
    ap.add_argument("--compare", nargs=2, metavar=("PORT_NPZ", "REF_NPZ"),
                    help="compare two dumps per algorithm, then exit")
    args = ap.parse_args()
    if args.compare:
        print(json.dumps(compare(*args.compare)))
        return 0
    kw = dict(width=args.width, height=args.height, max_depth=args.depth,
              tile_h=32, tile_w=32)
    if args.package == "reference":
        frames, res = run_reference(kw, args.max_frontier)
    else:
        frames, res = run_port(kw, args.max_frontier, args.device)
    if args.dump:
        import numpy as np

        np.savez(args.dump, **{k: v for k, v in frames.items()
                               if isinstance(v, np.ndarray)})
    print(json.dumps(dict(package=args.package, max_frontier=args.max_frontier,
                          **kw, **res)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
