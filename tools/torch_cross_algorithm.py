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

Prints one JSON line. One process imports one package only.
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


def run_reference(kw, max_frontier):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from sphereflake_tpu import render
    from sphereflake_tpu.config import RenderConfig, default_scene

    scene = default_scene()
    b = render.render_gbuffer(scene, RenderConfig(algorithm="binned", **kw))
    p = render.render_gbuffer(scene, RenderConfig(
        algorithm="pallas", max_frontier=max_frontier, tile_batch=4, **kw
    ))
    depth = int(p.metrics.max_depth_reached)
    return dict(
        overflow=dict(binned=int(b.metrics.overflow),
                      pallas=int(p.metrics.overflow)),
        max_depth_reached=depth,
        **summary(np.asarray(b.hit), np.asarray(p.hit), np.asarray(b.min_t),
                  np.asarray(p.min_t), 3.0 ** -depth),
    )


def run_port(kw, max_frontier, device):
    import numpy as np
    import torch

    from sphereflake_tpu_torch.camera import tile_frustum_planes
    from sphereflake_tpu_torch.config import RenderConfig, default_scene
    from sphereflake_tpu_torch.models.sphereflake import (
        child_templates,
        root_frame,
    )
    from sphereflake_tpu_torch.ops.binned import binned_gbuffer
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
        b = binned_gbuffer(bcfg, bcfg.width, bcfg.height, scene, (0.0, 0.0))
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
    hit_b, hit_p = code_b >= 1.0, code_p >= 1.0
    both = hit_b & hit_p
    depth = int(m[:, 0, 2].max())
    # Level of the pallas winner: floor(log9) of its sentinel-prefixed code.
    level = sum((code_p >= 9.0 ** k).astype(np.int64) for k in range(1, 8))
    close = np.isclose(t_b, t_p, rtol=1e-4, atol=1e-4)
    same = code_b == code_p
    return dict(
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
    args = ap.parse_args()
    kw = dict(width=args.width, height=args.height, max_depth=args.depth,
              tile_h=32, tile_w=32)
    if args.package == "reference":
        res = run_reference(kw, args.max_frontier)
    else:
        res = run_port(kw, args.max_frontier, args.device)
    print(json.dumps(dict(package=args.package, max_frontier=args.max_frontier,
                          **kw, **res)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
