"""Golden-model scalar tracer: an independent NumPy implementation.

The port's own copy of the reference package's `models/golden.py`,
array for array the same functions (NumPy only, float64): a small,
slow, obviously-correct CPU tracer with *per-ray* traversal semantics
that the levelwise torch traversal ("strict", `ops/traversal.py`) must
match. It re-implements the math (rotations, camera, intersection) in
plain NumPy rather than calling into the torch modules, so the two code
paths can cross-check each other.

Per-ray traversal semantics (derived from `Sphereflake.h:86-226` with a
1-wide packet):

  visit(node, active):
    bhit = active ∧ tca ≥ 0 ∧ d² ≤ (2r)²                  bounding sphere
    cont = bhit ∧ (t_bound < lod² · r)                    LOD cut, incl. t<0
    if depth < max_depth: visit(children, cont)
    self-hit = cont ∧ d² ≤ r² ∧ (t_self < minT)  →  update minT/pos/normal

The reference's 8-wide packets make the LOD/self-test gating *packet
dependent* (a lane that fails the LOD cut is still self-tested if a
sibling lane passes, `Sphereflake.h:146-153` + `:185-225`); the per-ray
semantics above are the packet-width-1 limit and are what the whole
framework standardizes on (deterministic, packet-shape independent).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


# ---------------------------------------------------------------------------
# Independent NumPy geometry (mirrors Util.h / camera.h semantics)
# ---------------------------------------------------------------------------


def _rot_x(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)


def _rot_y(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)


def _rot_z(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)


def rotation_xyz_deg(rot_deg):
    """`Util.h:13-18`: Rx @ Ry @ Rz, degrees."""
    rx, ry, rz = (math.radians(float(v)) for v in rot_deg)
    return _rot_x(rx) @ _rot_y(ry) @ _rot_z(rz)


def spherical_to_world(lon, lat):
    """`Util.h:7-11`."""
    return np.array(
        [math.cos(lat) * math.sin(lon), math.sin(lat) * math.sin(lon), math.cos(lon)],
        dtype=np.float64,
    )


def reference_child_templates():
    """The 9 child frames of `Sphereflake.cpp:216-249` as (R[9,3,3], disp[9,3])."""
    rots = np.zeros((9, 3, 3))
    disps = np.zeros((9, 3))
    for i in range(6):
        lon, lat = math.radians(90.0), math.radians(60.0 * i)
        d = spherical_to_world(lon, lat)
        disps[i] = d / np.linalg.norm(d)
        rots[i] = rotation_xyz_deg((90.0, 90.0 + 60.0 * i, 0.0))
    polar = [(325.0, 45.0, 15.0), (145.0, 230.0, 165.0), (60.0, 0.0, 0.0)]
    for i in range(3):
        lon, lat = math.radians(30.0), math.radians(30.0 + 120.0 * i)
        d = spherical_to_world(lon, lat)
        disps[6 + i] = d / np.linalg.norm(d)
        rots[6 + i] = rotation_xyz_deg(polar[i])
    return rots, disps


def camera_rays(position, yaw, pitch, roll, fov_deg, width, height):
    """Per-pixel normalized ray directions [H, W, 3] (float64).

    Matches `camera.h:37-53,111-114` (d = tan(fov/2)/3 quirk) and the
    bilinear corner interpolation of `Sphereflake.cpp:149-167`.
    """
    aspect = width / height
    # GLM quat(vec3(yaw,pitch,roll)) == Rz(roll)@Ry(pitch)@Rx(yaw); see
    # sphereflake_tpu_torch.ops.transforms.look_rotation.
    rot = _rot_z(roll) @ _rot_y(pitch) @ _rot_x(yaw)
    d = math.tan(math.radians(fov_deg) / 2.0) / 3.0
    pos = np.asarray(position, dtype=np.float64)
    tl = pos + rot @ np.array([-aspect * d, d, -1.0])
    tr = pos + rot @ np.array([aspect * d, d, -1.0])
    bl = pos + rot @ np.array([-aspect * d, -d, -1.0])
    xs = np.arange(width, dtype=np.float64)[None, :, None]
    ys = np.arange(height, dtype=np.float64)[:, None, None]
    target = tl + (tr - tl) * (xs / width) + (bl - tl) * (ys / height)
    dirs = target - pos
    return dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# Per-ray recursive traversal (vectorized over rays, recursion over nodes)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GoldenResult:
    position: np.ndarray  # [H, W, 3] camera-relative hit position (dir * t)
    normal: np.ndarray  # [H, W, 3] unit normal, zeros for sky
    min_t: np.ndarray  # [H, W] hit distance, +inf for sky
    max_depth_reached: int
    nodes_visited: int


def golden_trace(
    dirs,
    camera_position,
    max_depth=2,
    lod_factor=70.0,
    radius_ratio=1.0 / 3.0,
    root_radius=1.0,
):
    """Trace all rays in `dirs` [..., 3] against the sphereflake.

    Returns a GoldenResult with arrays shaped like dirs[..., :].
    Root frame = translate(-cam) @ Rx(90°) (`Sphereflake.cpp:83`).
    """
    shape = dirs.shape[:-1]
    dirs = np.asarray(dirs, dtype=np.float64).reshape(-1, 3)
    n_rays = dirs.shape[0]

    child_rots, child_disps = reference_child_templates()
    lod_sq = float(lod_factor) ** 2

    min_t = np.full(n_rays, np.inf)
    best_center = np.zeros((n_rays, 3))

    root_rot = _rot_x(math.radians(90.0))
    root_trans = -np.asarray(camera_position, dtype=np.float64)

    stats = {"max_depth": 0, "nodes": 0}

    def visit(rot, trans, radius, depth, active):
        stats["nodes"] += 1
        c = trans
        tca = dirs @ c
        d2 = float(c @ c) - tca * tca
        r2 = radius * radius
        bhit = active & (tca >= 0.0) & (d2 <= 4.0 * r2)
        tb = tca - np.sqrt(np.maximum(4.0 * r2 - d2, 0.0))
        cont = bhit & (tb < lod_sq * radius)
        if not cont.any():
            return
        stats["max_depth"] = max(stats["max_depth"], depth)
        if depth < max_depth:
            scale = (1.0 + radius_ratio) * radius
            for i in range(9):
                child_rot = rot @ child_rots[i]
                child_trans = rot @ (child_disps[i] * scale) + trans
                visit(child_rot, child_trans, radius * radius_ratio, depth + 1, cont)
        shit = cont & (d2 <= r2)
        ts = tca - np.sqrt(np.maximum(r2 - d2, 0.0))
        upd = shit & (ts < min_t)
        min_t[upd] = ts[upd]
        best_center[upd] = c

    visit(root_rot, root_trans, float(root_radius), 0, np.ones(n_rays, dtype=bool))

    hit = np.isfinite(min_t)
    t = np.where(hit, min_t, 0.0)
    position = dirs * t[:, None]
    normal = np.zeros_like(position)
    delta = position[hit] - best_center[hit]
    normal[hit] = delta / np.linalg.norm(delta, axis=-1, keepdims=True)
    position[~hit] = 0.0

    return GoldenResult(
        position=position.reshape(*shape, 3),
        normal=normal.reshape(*shape, 3),
        min_t=min_t.reshape(shape),
        max_depth_reached=stats["max_depth"],
        nodes_visited=stats["nodes"],
    )


def golden_render_gbuffer(
    width,
    height,
    camera_position=(-5.4098, -7.2139, 1.19006),
    yaw=0.921999,
    pitch=-1.371,
    roll=0.0,
    fov_deg=60.0,
    max_depth=2,
    lod_factor=70.0,
    radius_ratio=1.0 / 3.0,
    root_radius=1.0,
):
    """Full-frame golden G-buffer at the reference's default pose."""
    dirs = camera_rays(camera_position, yaw, pitch, roll, fov_deg, width, height)
    return golden_trace(
        dirs,
        camera_position,
        max_depth=max_depth,
        lod_factor=lod_factor,
        radius_ratio=radius_ratio,
        root_radius=root_radius,
    )
