"""Camera → frustum-corner ray parameterization (torch).

The C++ app's tracer is parameterized by the three frustum-corner
points topLeft/topRight/bottomLeft (`camera.h:37-53`) and generates
rays by bilinear interpolation of those corners
(`Sphereflake.cpp:162-167`); the port keeps that parameterization.

Quirk preserved: the corner scaling is
`tan(fov/2) / vec3(-aspect,1,0).length()` where GLM's member
`.length()` is the *component count* (3), so d = tan(fov_rad/2) / 3
(`camera.h:111-114`).
"""

from __future__ import annotations

import torch

from sphereflake_tpu_torch.config import CameraParams
from sphereflake_tpu_torch.ops.transforms import (
    look_rotation,
    matvec3,
    normalize,
)


def camera_scaling(fov_deg):
    """`camera.h:111-114` (including the .length()==3 quirk)."""
    return torch.tan(torch.deg2rad(fov_deg) * 0.5) / 3.0


def corner_rays(cam: CameraParams, aspect: float):
    """Return (origin, top_left, top_right, bottom_left), each [3].

    `camera.h:37-53`: corner = position + R @ (±aspect·d, ±d, -1).
    """
    rot = look_rotation(cam.yaw, cam.pitch, cam.roll)
    d = camera_scaling(cam.fov)
    a = d.new_tensor(aspect)
    one = torch.ones_like(d)
    top_left = cam.position + matvec3(rot, torch.stack([-a * d, d, -one]))
    top_right = cam.position + matvec3(rot, torch.stack([a * d, d, -one]))
    bottom_left = cam.position + matvec3(rot, torch.stack([-a * d, -d, -one]))
    return cam.position, top_left, top_right, bottom_left


def ray_directions(cam: CameraParams, xs, ys, width: int, height: int):
    """Normalized world-space ray directions for pixel coords (xs, ys).

    Matches `Sphereflake.cpp:149-167`: uv = (x/W, y/H);
    target = TL + (TR-TL)·uvx + (BL-TL)·uvy; dir = normalize(target - origin).
    xs/ys broadcast; returns [..., 3] float32.
    """
    origin, tl, tr, bl = corner_rays(cam, width / height)
    dev = origin.device
    wt = origin.new_tensor(float(width))
    ht = origin.new_tensor(float(height))
    uvx = (torch.as_tensor(xs, dtype=torch.float32, device=dev) / wt)[..., None]
    uvy = (torch.as_tensor(ys, dtype=torch.float32, device=dev) / ht)[..., None]
    target = tl + (tr - tl) * uvx + (bl - tl) * uvy
    return normalize(target - origin)


def tile_frustum_planes(
    cam: CameraParams,
    width: int,
    height: int,
    tile_h: int,
    tile_w: int,
    x_off: float = 0.0,
    y_off: float = 0.0,
    block_h: int | None = None,
    block_w: int | None = None,
):
    """[T, 4, 3] inward unit normals of each screen tile's bounding
    frustum (row-major over (tile_y, tile_x), matching `render._tile`).

    A tile's rays are convex combinations of the tile's 4 corner
    directions, so the 4 planes through the origin and adjacent corner
    pairs bound the whole bundle exactly. Corners are taken half a
    pixel outside the outermost ray coordinates.

    width/height are the FULL image dims (ray math is global);
    block_h/block_w (default: full image) describe the sub-image this
    call tiles, offset by (x_off, y_off) pixels.
    """
    bh = height if block_h is None else block_h
    bw = width if block_w is None else block_w
    ty, tx = bh // tile_h, bw // tile_w
    origin, tl, tr, bl = corner_rays(cam, width / height)
    dev = origin.device
    y0 = torch.arange(ty, dtype=torch.float32, device=dev) * tile_h - 0.5 + y_off
    x0 = torch.arange(tx, dtype=torch.float32, device=dev) * tile_w - 0.5 + x_off
    y1, x1 = y0 + tile_h, x0 + tile_w
    ex, ey = tr - tl, bl - tl
    wt = origin.new_tensor(float(width))
    ht = origin.new_tensor(float(height))

    def corner_dir(gx, gy):
        # Unnormalized is fine: plane normals get normalized below.
        return tl - origin + ex * (gx / wt)[..., None] + ey * (gy / ht)[..., None]

    gy0, gx0 = torch.meshgrid(y0, x0, indexing="ij")
    gy1, gx1 = torch.meshgrid(y1, x1, indexing="ij")
    corners = torch.stack(
        [
            corner_dir(gx0, gy0).reshape(-1, 3),
            corner_dir(gx1, gy0).reshape(-1, 3),
            corner_dir(gx1, gy1).reshape(-1, 3),
            corner_dir(gx0, gy1).reshape(-1, 3),
        ],
        dim=1,
    )  # [T, 4, 3]
    axis = torch.sum(corners, dim=1)
    n = torch.linalg.cross(corners, torch.roll(corners, -1, dims=1), dim=-1)
    n = n / torch.clamp_min(
        torch.linalg.vector_norm(n, dim=-1, keepdim=True), 1e-20
    )
    s = torch.sign(torch.sum(n * axis[:, None, :], dim=-1, keepdim=True))
    return n * torch.where(s == 0, torch.ones_like(s), s)


def bundle_frustum_planes(dirs):
    """[B, 4, 3] conservative frustum planes for arbitrary unit-ray
    bundles `dirs` [B, R, 3] (or [4, 3] for one bundle [R, 3]): a
    4-plane pyramid circumscribing each bundle's bounding cone. Falls
    back to all-pass planes (zeros) for bundles wider than a
    hemisphere-ish cone, where no pyramid exists."""
    if dirs.dim() == 2:
        return bundle_frustum_planes(dirs[None])[0]
    axis = torch.sum(dirs, dim=1)  # [B, 3]
    axis = axis / torch.sqrt(
        torch.clamp_min(torch.sum(axis * axis, dim=-1, keepdim=True), 1e-20)
    )
    dots = (
        dirs[..., 0] * axis[:, None, 0]
        + dirs[..., 1] * axis[:, None, 1]
        + dirs[..., 2] * axis[:, None, 2]
    )
    cos_t = torch.amin(dots, dim=1)[:, None]  # [B, 1]
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    # Orthobasis around the axis.
    ex = axis.new_tensor([1.0, 0.0, 0.0]).expand_as(axis)
    ey = axis.new_tensor([0.0, 1.0, 0.0]).expand_as(axis)
    alt = torch.where(torch.abs(axis[:, :1]) < 0.9, ex, ey)
    u = torch.linalg.cross(axis, alt, dim=-1)
    u = u / torch.sqrt(
        torch.clamp_min(torch.sum(u * u, dim=-1, keepdim=True), 1e-20)
    )
    v = torch.linalg.cross(axis, u, dim=-1)
    # Plane normal tangent to the cone opposite lateral direction e:
    # n = sin(t)*axis - cos(t)*e; dot(n, x) >= 0 for all cone dirs.
    planes = torch.stack(
        [sin_t * axis - cos_t * e for e in (u, -u, v, -v)], dim=1
    )
    return torch.where(
        (cos_t > 0.05)[:, :, None], planes, torch.zeros_like(planes)
    )


def pixel_grid(width: int, height: int, device="cuda"):
    """Integer pixel-coordinate grids xs, ys of shape [height, width].

    The C++ app traces rays *at* integer pixel coordinates (uv = x/W,
    not (x+0.5)/W) — `Sphereflake.cpp:117-127` — so the port does too.
    """
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return xs, ys
