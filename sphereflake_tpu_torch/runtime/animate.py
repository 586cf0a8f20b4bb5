"""Camera-path animation — the headless analogue of the C++ app's
interactive navigation.

Counterpart of the reference package's `runtime/animate.py`: `animate`
(one full frame per camera step), `frameless_animate` (the camera moves
while one frameless buffer keeps accumulating) and their camera
helpers. The C++ app's main loop translates the camera at a speed
proportional to the closest-sphere distance (`main.cpp:206-257`, speed
law at `main.cpp:213`) — the classic "fractal zoom": the closer you
get, the slower you move, and the LOD cut keeps revealing deeper
levels.

- **approach**: fly the camera along its forward axis, each frame
  advancing `speed_factor * closest_sphere_distance`.
- **orbit**: a turntable around the fractal at constant radius, always
  looking at the origin.

One intended difference from the reference: on an all-sky frame the
closest distance is the miss sentinel (3e38), and `animate`'s approach
holds the camera where the reference would step it by
`speed_factor * 3e38`. The multi-device forms: `animate(mesh=...)`
shards every frame over a device mesh, `animate_frames_dp` renders a
different orbit frame on each device (frame data parallelism).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from sphereflake_tpu_torch import spans
from sphereflake_tpu_torch.config import (
    RenderConfig,
    SceneParams,
    resolve_device,
)


def _look_at_origin(position):
    """Yaw/pitch that aim the camera's -Z forward axis at the origin.

    The camera rotation is R = Rz(roll) @ Ry(pitch) @ Rx(yaw)
    (`transforms.look_rotation`; the C++ app's "yaw" rotates about x,
    `camera.h:65-68`), so the forward axis is R @ (0,0,-1) =
    (-cos(yaw) sin(pitch), sin(yaw), -cos(yaw) cos(pitch)). Solving
    for forward f = -position/|position|:
    yaw = asin(fy), pitch = atan2(-fx, -fz)."""
    f = -position / torch.linalg.vector_norm(position)
    yaw = torch.asin(torch.clamp(f[1], -1.0, 1.0))
    pitch = torch.atan2(-f[0], -f[2])
    return yaw, pitch


def camera_forward(cam):
    """The camera's forward axis (the -Z column of its rotation)."""
    from sphereflake_tpu_torch.ops.transforms import look_rotation, matvec3

    rot = look_rotation(cam.yaw, cam.pitch, cam.roll)
    return matvec3(rot, rot.new_tensor([0.0, 0.0, -1.0]))


def _orbit_scene(scene, cam0, radius, i, n_frames):
    angle = 2.0 * np.pi * i / max(n_frames, 1)
    base = cam0.position
    c, s = float(np.cos(angle)), float(np.sin(angle))
    pos = torch.stack(
        [
            c * base[0] + s * base[2],
            base[1],
            -s * base[0] + c * base[2],
        ]
    )
    pos = pos * (radius / torch.linalg.vector_norm(pos))
    yaw, pitch = _look_at_origin(pos)
    cam = dataclasses.replace(cam0, position=pos, yaw=yaw, pitch=pitch)
    return dataclasses.replace(scene, camera=cam)


def _image_to_host(image: torch.Tensor):
    """`image.cpu().numpy()` for a mesh frame's image on a card (16384^2
    float32 is 3.2 GB), into page-locked memory from torch's caching host
    allocator: the card copies at the link's speed (3.2 GB in 0.06 s on
    an H100 host, against 1.5–1.9 s into new pageable memory, where the
    CUDA runtime's staging copy and the first touch of each page run on one
    thread), and the memory of a frame the caller has dropped serves a
    later frame. Pageable memory where none can be locked."""
    if image.device.type != "cuda":
        return image.cpu().numpy()
    try:
        out = torch.empty(image.shape, dtype=image.dtype, pin_memory=True)
    except RuntimeError:
        return image.cpu().numpy()
    out.copy_(image)
    return out.numpy()


def animate_frames_dp(
    scene: SceneParams,
    cfg: RenderConfig,
    n_frames: int,
    devices,
) -> Iterator[tuple[np.ndarray, SceneParams]]:
    """Orbit animation with FRAME data parallelism: each device renders
    a DIFFERENT full frame per batch (`parallel.render_frames_dp`) — the
    shape for small frames, where screen-tile sharding of one frame pays
    its fixed costs once per block. A device may repeat. A batch that
    overflows is rendered again one rung up the capacity ladder, like
    the sequential path. Yields (image as a NumPy array, scene) per
    frame, in order."""
    from sphereflake_tpu_torch.parallel import (
        make_frame_mesh,
        render_frames_dp,
    )
    from sphereflake_tpu_torch.render import grow_capacity

    mesh = make_frame_mesh(devices)
    n_dev = mesh.size
    scene = scene.to(mesh.home)
    cam0 = scene.camera
    radius = float(torch.linalg.vector_norm(cam0.position))
    for b0 in range(0, n_frames, n_dev):
        idx = [min(b0 + k, n_frames - 1) for k in range(n_dev)]
        scenes = [_orbit_scene(scene, cam0, radius, i, n_frames) for i in idx]
        while True:
            images, ovf = render_frames_dp(scenes, cfg, mesh)
            if not int(ovf.sum()):
                break
            cfg = grow_capacity(cfg)
        images = images.cpu().numpy()
        for k in range(n_dev):
            if b0 + k >= n_frames:
                break
            yield images[k], scenes[k]


def frameless_animate(
    scene: SceneParams,
    cfg: RenderConfig,
    n_frames: int,
    steps_per_frame: int = 8,
    tiles_per_step: int = 256,
    mode: str = "orbit",
    speed_factor: float = 0.05,
    seed: int = 0,
    composite: bool = True,
    device="cuda",
) -> Iterator[tuple[np.ndarray, SceneParams, dict]]:
    """Fly the camera WHILE framelessly accumulating into ONE buffer —
    the C++ app's defining interaction: `SetView` lands mid-flight and
    the workers simply start overwriting stale texels with the new view
    (`main.cpp:304`, `Sphereflake.cpp:76-84`); the display thread
    composites whatever mixture is in the buffer every vsync.

    Per camera step the pair table is re-prepared (the analogue of
    SetView: the workers' shared view vectors change, nothing else),
    the SAME `TileProgressiveState` keeps accumulating — tiles not yet
    refreshed under the new camera still show the previous view — and
    a snapshot of the in-flight buffer is yielded after
    `steps_per_frame` steps. Yields (image as a NumPy array,
    scene-at-frame, stats) where stats carries samples_traced / closest
    / refreshed-tile fraction for the frame. The host reads the device
    once per camera step (the prepare's overflow count, then the
    frame's image and metrics); no refresh step reads anything."""
    from sphereflake_tpu_torch.runtime.progressive import (
        grow_frameless_capacity,
        progressive_prepare,
        progressive_tiles_init,
        progressive_tiles_step,
        reset_closest_distance,
        tile_progressive_composite,
        tile_progressive_gbuffer,
    )

    assert cfg.algorithm == "binned", "frameless animate rides the binned path"
    dev = resolve_device(device)
    scene = scene.to(dev)
    state = progressive_tiles_init(cfg, seed=seed, device=dev)
    cam0 = scene.camera
    radius = float(torch.linalg.vector_norm(cam0.position))
    # Approach speed law: last KNOWN closest distance. A frame whose
    # refreshed tiles all miss leaves the per-frame metric at BIG;
    # stepping by speed_factor * BIG would fling the camera into f32
    # overflow, so such frames coast on the previous value — the C++
    # app's counter likewise just retains sparse worker samples between
    # resets (`Sphereflake.cpp:197-200`).
    last_closest = None
    for i in range(n_frames):
        if mode == "orbit":
            scene = _orbit_scene(scene, cam0, radius, i, n_frames)
        elif mode != "approach":
            raise ValueError(f"unknown animation mode {mode!r}")

        # SetView: re-bin for the new camera; accumulation state is NOT
        # reset (stale-tile overwrite is the point). Banding can't
        # rescue an over-cap frameless table, so the ladder errors
        # cleanly at the ceiling (grow_frameless_capacity).
        while True:
            prepared = progressive_prepare(scene, cfg, device=dev)
            if not int(prepared[3]):
                break
            cfg = grow_frameless_capacity(cfg)
        # Track the frame's own closest distance for the approach speed
        # law (the C++ app resets this metric per report).
        state = reset_closest_distance(state)
        for _ in range(steps_per_frame):
            state = progressive_tiles_step(
                state, scene, cfg, tiles_per_step=tiles_per_step,
                prepared=prepared,
            )
        if composite:
            image = tile_progressive_composite(state, scene, cfg).cpu().numpy()
        else:
            from sphereflake_tpu_torch.utils.image import shade_normals

            _p, nrm, _mt, hit = tile_progressive_gbuffer(state, cfg)
            image = shade_normals(nrm, hit)
        closest = float(state.closest_distance)
        stats = {
            "samples_traced": state.samples_traced,
            "closest": closest,
            "covered": float(state.covered.float().mean()),
            "refresh_fraction": min(
                1.0,
                steps_per_frame * tiles_per_step
                / (cfg.tiles_y * cfg.tiles_x),
            ),
        }
        yield image, scene, stats

        if mode == "approach":
            if closest < 1.0e37:
                last_closest = closest
            if last_closest is not None:
                step = speed_factor * last_closest
                fwd = camera_forward(scene.camera)
                cam = dataclasses.replace(
                    scene.camera,
                    position=scene.camera.position + step * fwd,
                )
                scene = dataclasses.replace(scene, camera=cam)
            # else: nothing hit yet — hold position until a sample
            # lands (an all-sky start pose).


def animate(
    scene: SceneParams,
    cfg: RenderConfig,
    n_frames: int,
    mode: str = "orbit",
    speed_factor: float = 0.05,
    composite: bool = True,
    mesh=None,
    device="cuda",
) -> Iterator[tuple[np.ndarray, SceneParams]]:
    """Yield (image [H, W, 3] as a NumPy array, scene-at-frame) per
    frame, each a full `render_frame` (`composite`) or the normal
    shading of `render_gbuffer` on `device`.

    A frame that overflows is rendered again one rung up the capacity
    ladder (`render.grow_capacity`), and the larger config is kept for
    the rest of the path. `approach` steps the camera along its forward
    axis by `speed_factor` times the frame's closest distance (the C++
    app's speed law, `main.cpp:213`); on an all-sky frame it holds the
    camera. `mesh` shards every frame over a device mesh
    (`parallel.render_frame_sharded`; the frames live on its home
    device, not `device`)."""
    from sphereflake_tpu_torch import render
    from sphereflake_tpu_torch.utils.image import shade_normals

    if mesh is not None:
        from sphereflake_tpu_torch.parallel import (
            render_frame_sharded,
            render_gbuffer_sharded,
        )

        dev = mesh.home

        def render_frame(s, c):
            return render_frame_sharded(s, c, mesh)

        def render_gbuffer(s, c):
            return render_gbuffer_sharded(s, c, mesh)

        to_host = _image_to_host
    else:
        dev = resolve_device(device)

        def render_frame(s, c):
            return render.render_frame(s, c, device=dev)

        def render_gbuffer(s, c):
            return render.render_gbuffer(s, c, device=dev)

        def to_host(image):
            return image.cpu().numpy()
    scene = scene.to(dev)
    cam0 = scene.camera
    radius = float(torch.linalg.vector_norm(cam0.position))
    for i in range(n_frames):
        # The unit ends before the yield: the caller's time with the
        # frame is not the frame's.
        with spans.unit("frame"):
            if mode == "orbit":
                # Rotate the start position about the world Y axis.
                scene = _orbit_scene(scene, cam0, radius, i, n_frames)
            elif mode != "approach":
                raise ValueError(f"unknown animation mode {mode!r}")

            while True:
                spans.count("frame.renders")
                if composite:
                    image, gb = render_frame(scene, cfg)
                    with spans.span("animate.to_host"):
                        image = to_host(image)
                else:
                    gb = render_gbuffer(scene, cfg)
                    image = shade_normals(gb.normal, gb.hit)
                with spans.span("animate.overflow_read"):
                    overflow = int(gb.metrics.overflow)
                if not overflow:
                    break
                # Deep poses outgrow the capacity defaults (the C++ app's
                # recursion has no caps).
                cfg = render.grow_capacity(cfg)
        yield image, scene

        if mode == "approach":
            closest = float(gb.metrics.closest_distance)
            if closest < 1.0e37:  # else all sky: hold the camera
                fwd = camera_forward(scene.camera)
                cam = dataclasses.replace(
                    scene.camera,
                    position=scene.camera.position
                    + speed_factor * closest * fwd,
                )
                scene = dataclasses.replace(scene, camera=cam)
