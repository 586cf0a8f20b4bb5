"""Sharded rendering and fitting over a 2D screen-tile device mesh.

Counterpart of the reference package's `parallel/sharded.py`. Every
mesh cell renders its own image block with the kernels the single-device
frame uses (its tile set is just smaller), on its own device:

- forward: no communication for the G-buffer (rays are independent —
  `Sphereflake.cpp:139-150`'s statistical sharding had the same
  property); the blocks are gathered and the metrics reduced
  (`parallel.mesh`'s collectives);
- backward (fitting): each cell's loss reaches the scene's leaves
  through a differentiable move to the cell's device, so one backward
  over the sum of the block losses sums the cells' gradients — the
  reference's explicit `psum` of gradients; across processes the
  gradients are all-reduced.

Binned frames that the shared bin takes go through it
(`parallel.shared_bin`); the rest render per block: K1 once per block
and band, or, on the per-tile algorithms, raygen at global pixel
coordinates and the per-tile traversal (K4 on `pallas`) per block.

Stage spans of a frame (`spans.py`, in the open unit, `frame` under
`animate(mesh=...)`): `mesh.blocks` (the per-block G-buffers, the
`gbuffer.*` spans of their bands nested in it; counter `mesh.cells`),
`mesh.gather` (the planes assembled on the home device and the metrics
reduced) and `mesh.post` (the post with its gathers); the collectives
count `mesh.peer_bytes` (`parallel.mesh`).
"""

from __future__ import annotations

import dataclasses

import torch

from sphereflake_tpu_torch import spans
from sphereflake_tpu_torch.config import RenderConfig, SceneParams
from sphereflake_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    broadcast,
    pmax,
    psum,
    tile_blocks,
)

_BIG = 3.0e38


def _block_cfg(cfg: RenderConfig, mesh: Mesh) -> RenderConfig:
    """One mesh cell's block configuration.

    Blocks are tile-aligned and sized ceil(frame / mesh): frames that
    do not divide evenly (1080p over 2 rows of devices, say) render a
    few extrapolated rows/cols in the last blocks — the same padding
    the single-device pipeline applies — and the assembled image is
    cropped back to (height, width). An explicit band request is kept
    only where it divides the block's tile rows (else the block
    auto-bands if its tile count needs it)."""
    my, mx = mesh.shape
    bh = -(-cfg.height // (my * cfg.tile_h)) * cfg.tile_h
    bw = -(-cfg.width // (mx * cfg.tile_w)) * cfg.tile_w
    btr = cfg.band_tile_rows
    if btr is not None and (bh // cfg.tile_h) % btr:
        btr = None
    return dataclasses.replace(cfg, height=bh, width=bw, band_tile_rows=btr)


def _render_block(scene: SceneParams, cfg: RenderConfig, bcfg: RenderConfig,
                  iy: int, ix: int):
    """Render cell (iy, ix)'s image block on the scene's device, binned
    or traced with the full frame's dims (the corner-ray basis is
    global) and the block's pixel offset.

    Returns (pos, nrm, min_t, hit, (depth_reached, nodes_visited,
    overflow))."""
    from sphereflake_tpu_torch.camera import (
        pixel_grid,
        ray_directions,
        tile_frustum_planes,
    )
    from sphereflake_tpu_torch.ops.traversal import shade_gbuffer
    from sphereflake_tpu_torch.render import (
        _binned_rows,
        _tile,
        _untile,
        _untile_rows,
        trace_tiles,
    )

    y0 = float(iy * bcfg.height)
    x0 = float(ix * bcfg.width)
    if bcfg.algorithm == "binned":
        frame = (cfg.width, cfg.height, x0, y0)
        rows, metrics = _binned_rows(scene, bcfg, frame)
        imgs = _untile_rows(rows, bcfg)
        return (
            torch.stack(imgs[1:4], dim=-1),
            torch.stack(imgs[4:7], dim=-1),
            imgs[0],
            imgs[0] < _BIG,
            metrics,
        )

    xs, ys = pixel_grid(bcfg.padded_width, bcfg.padded_height,
                        device=scene.device)
    # Global pixel coordinates; the ray math uses the FULL image dims.
    dirs = ray_directions(scene.camera, xs + x0, ys + y0, cfg.width,
                          cfg.height)
    tiles = _tile(dirs, bcfg)
    planes = tile_frustum_planes(
        scene.camera, cfg.width, cfg.height, bcfg.tile_h, bcfg.tile_w,
        x_off=x0, y_off=y0,
        block_h=bcfg.padded_height, block_w=bcfg.padded_width,
    )
    res = trace_tiles(tiles, planes, scene, bcfg)
    pos_t, nrm_t = shade_gbuffer(tiles, res)
    return (
        _untile(pos_t, bcfg),
        _untile(nrm_t, bcfg),
        _untile(res.min_t, bcfg),
        _untile(res.hit, bcfg),
        (res.max_depth_reached, res.nodes_visited, res.overflow),
    )


def render_gbuffer_sharded(scene: SceneParams, cfg: RenderConfig,
                           mesh: Mesh):
    """Full-frame G-buffer with image blocks sharded over `mesh`, on the
    mesh's home device (a `render.GBuffer`, planes cropped to (height,
    width)).

    Binned frames that `shared_bin_supported` takes go through the
    shared bin (one cooperative bin, the kernel sharded by tile block:
    equal to `render_gbuffer` bit for bit); everything else renders
    per-cell blocks (each block expands and bins its own frustum — the
    banded shape)."""
    from sphereflake_tpu_torch.parallel.shared_bin import (
        render_gbuffer_shared,
        shared_bin_supported,
    )
    from sphereflake_tpu_torch.render import (
        GBuffer,
        _frame_metrics,
        _grad_mode,
    )

    if shared_bin_supported(cfg, mesh):
        return render_gbuffer_shared(scene, cfg, mesh)
    bcfg = _block_cfg(cfg, mesh)
    scene = scene.to(mesh.home)
    with _grad_mode(scene):
        with spans.span("mesh.blocks"):
            blocks = [
                _render_block(s, cfg, bcfg, iy, ix)
                for ((iy, ix), _), s in zip(mesh.local_cells(),
                                            broadcast(mesh, scene))
            ]
            spans.count("mesh.cells", len(blocks))
        with spans.span("mesh.gather"):
            planes = [
                tile_blocks(mesh, all_gather(mesh, [b[k] for b in blocks]))
                for k in range(4)
            ]
            depth_r = pmax(mesh, [b[4][0] for b in blocks])
            nodes_n = psum(mesh, [b[4][1] for b in blocks])
            overflow = psum(mesh, [b[4][2] for b in blocks])
    h, w = cfg.height, cfg.width
    pos, nrm, min_t, hit = (p[:h, :w] for p in planes)
    return GBuffer(
        position=pos, normal=nrm, min_t=min_t, hit=hit,
        # Over the CROPPED image (padded extrapolation rows excluded),
        # like the single-device pipeline.
        metrics=_frame_metrics(cfg, depth_r, nodes_n, overflow, min_t, hit),
    )


def render_frame_sharded(scene: SceneParams, cfg: RenderConfig, mesh: Mesh):
    """The complete pipeline — trace + SSAO + blur x2 + composite
    (`main.cpp:301-335`) — with every stage sharded over `mesh`.

    The SSAO taps reach a data-dependent, unbounded radius
    (`post_ssao.glsl:42`, radius law 8 * closest distance), so every
    cell reads the whole gathered G-buffer and evaluates ITS OWN block
    of each full-resolution pass (the `block` of `ops.post`'s passes); the
    separable blur reads the previous pass across block borders, so the
    AO target is gathered between passes. Targets whose blocks do not
    tile evenly take the post replicated on the home device (correct,
    not sharded), as in the reference.

    Returns (image [H, W, 3], GBuffer) like `render.render_frame`, on
    the home device."""
    scene = scene.to(mesh.home)
    gb = render_gbuffer_sharded(scene, cfg, mesh)
    with spans.span("mesh.post"):
        return _post_sharded(gb, scene, cfg, mesh), gb


def _post_sharded(gb, scene: SceneParams, cfg: RenderConfig, mesh: Mesh):
    """The image of `render_frame_sharded` from the gathered G-buffer."""
    from sphereflake_tpu_torch.ops import post as post_ops
    from sphereflake_tpu_torch.ops.noise import ssao_noise_texture
    from sphereflake_tpu_torch.render import _grad_mode

    home = mesh.home
    noise = torch.from_numpy(ssao_noise_texture(cfg.noise_size)).to(home)
    bcfg = _block_cfg(cfg, mesh)
    h, w = cfg.height, cfg.width
    ds = cfg.ssao_downscale
    sh, sw = h // ds, w // ds
    my, mx = mesh.shape
    with _grad_mode(scene):
        closest = gb.metrics.closest_distance
        if (sh % my or sw % mx or h % my or w % mx
                or bcfg.height % ds or bcfg.width % ds):
            return post_ops.postprocess(
                gb.position, gb.normal, closest, scene, cfg, noise
            )
        sbh, sbw = sh // my, sw // mx  # SSAO-target blocks
        bbh, bbw = h // my, w // mx  # full-resolution post blocks
        cells = list(zip(
            [idx for idx, _ in mesh.local_cells()],
            *(broadcast(mesh, x) for x in (scene, gb.position, gb.normal,
                                           noise, closest)),
        ))

        def block(idx, bh, bw):
            return (idx[0] * bh, idx[1] * bw, bh, bw)

        def gathered(blocks):
            return tile_blocks(mesh, all_gather(mesh, blocks))

        ao = gathered([
            post_ops.ssao_pass(
                pos, nrm, nz, s.ssao, (s.ssao.radius_multiplier, near), sh,
                sw, block=block(idx, sbh, sbw),
            )
            for idx, s, pos, nrm, nz, near in cells
        ])
        aoh = gathered([
            post_ops.blur_pass(a, pos, nrm, s.ssao, (1.0, 0.0), h, w,
                               block=block(idx, bbh, bbw))
            for (idx, s, pos, nrm, _nz, _near), a in zip(cells,
                                                         broadcast(mesh, ao))
        ])
        # The vertical blur and the composite, which samples every plane
        # at its own pixel, in one pass on the cell's block.
        return gathered([
            post_ops.blur_composite_pass(
                a, pos, nrm, s.ssao, s.camera.position, h, w,
                block=block(idx, bbh, bbw),
            )
            for (idx, s, pos, nrm, _nz, _near), a in zip(cells,
                                                         broadcast(mesh, aoh))
        ])


def fit_step_sharded(scene: SceneParams, target_position, target_normal,
                     cfg: RenderConfig, mesh: Mesh):
    """One sharded fitting step of the G-buffer L2 loss: (loss, grads),
    both on the home device, grads a `SceneParams` of the 15 leaves'
    gradients summed over every cell (every process).

    Targets arrive at (height, width); the blocks' padded extrapolation
    pixels are masked out of the loss."""
    from sphereflake_tpu_torch.fit import _value_and_grad

    home = mesh.home
    bcfg = _block_cfg(cfg, mesh)
    bh, bw = bcfg.height, bcfg.width
    h, w = cfg.height, cfg.width
    my, mx = mesh.shape
    pad = lambda t: torch.nn.functional.pad(
        t.to(home), (0, 0, 0, mx * bw - w, 0, my * bh - h)
    )
    tgt_pos, tgt_nrm = pad(target_position), pad(target_normal)
    n_pix = w * h

    def local_loss(s):
        losses = []
        for (iy, ix), dev in mesh.local_cells():
            pos, nrm, _, _, _ = _render_block(s.to(dev), cfg, bcfg, iy, ix)
            gy = iy * bh + torch.arange(bh, device=dev)[:, None]
            gx = ix * bw + torch.arange(bw, device=dev)[None, :]
            valid = ((gy < h) & (gx < w)).to(torch.float32)[..., None]
            blk = (slice(iy * bh, (iy + 1) * bh), slice(ix * bw, (ix + 1) * bw))
            err = torch.sum(valid * (pos - tgt_pos[blk].to(dev)) ** 2) + \
                torch.sum(valid * (nrm - tgt_nrm[blk].to(dev)) ** 2)
            losses.append((err / n_pix).to(home))
        return sum(losses)

    loss, grads = _value_and_grad(local_loss, scene.to(home))
    if mesh.multi_process:
        loss = psum(mesh, [loss])
        grads = SceneParams.from_leaves(
            [psum(mesh, [g]) for g in grads.leaves()]
        )
    return loss, grads


def render_frames_dp(scenes, cfg: RenderConfig, mesh: Mesh):
    """Frame data parallelism: cell i renders a DIFFERENT whole frame,
    `scenes[i]`, through the complete single-device pipeline (trace +
    SSAO + blur + composite) on its device.

    The answer for small frames: screen-tile sharding of one small frame
    pays the binning constant once per block, but N different frames — an
    animation, a fitting batch — scale with no shared cost. `mesh` is 1D
    (`make_frame_mesh`), `scenes` one per cell. Returns (images [N, H, W,
    3], overflow [N] int32) on the home device — callers check overflow
    like any other render (the capacity ladder retries)."""
    from sphereflake_tpu_torch.render import render_frame

    if len(mesh.shape) != 1 or len(scenes) != mesh.size:
        raise ValueError(
            f"render_frames_dp takes a 1D mesh and one scene per cell, got "
            f"a {mesh.shape} mesh and {len(scenes)} scenes"
        )
    images, overflow = [], []
    for (i,), dev in mesh.local_cells():
        image, gb = render_frame(scenes[i], cfg, device=dev)
        images.append(image)
        overflow.append(gb.metrics.overflow)
    return (torch.stack(all_gather(mesh, images)),
            torch.stack(all_gather(mesh, overflow)))


def make_frame_mesh(devices) -> Mesh:
    """1D "dp" mesh for `render_frames_dp` (a device may repeat)."""
    import numpy as np

    arr = np.empty(len(devices), dtype=object)
    arr[:] = list(devices)
    return Mesh(arr, ("dp",))
