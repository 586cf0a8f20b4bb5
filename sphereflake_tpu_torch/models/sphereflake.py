"""The sphereflake fractal model: child frames + root frame (torch).

Geometry semantics match `Sphereflake.cpp:216-249` / `Sphereflake.h:86-226`:

- 9 child template frames, each a rotation plus a *unit* displacement
  stored in the translation column; at traversal time the displacement
  is scaled by (1 + radius_ratio) · parent_sphere_radius.
- child frame in world = parent_frame ∘ scaled_template.
- the root frame is translate(-camera_position) @ Rx(90°)
  (`Sphereflake.cpp:83`): sphere centers live in camera-relative world
  space and the ray origin is implicitly 0.
- every sphere at tree level L has radius root_radius · radius_ratio^L.
"""

from __future__ import annotations

import torch

from sphereflake_tpu_torch.config import FractalParams
from sphereflake_tpu_torch.ops.transforms import (
    compose_rt,
    euler_xyz_rotation,
    rotation_x,
    spherical_to_world,
)


def child_templates(params: FractalParams):
    """[9, 3, 4] affine child template frames (unit displacement)."""
    rot = euler_xyz_rotation(params.child_rotations_deg)  # [9,3,3]
    longlat = torch.deg2rad(params.child_longlat_deg)
    disp = spherical_to_world(longlat[:, 0], longlat[:, 1])  # [9,3]
    disp = disp / torch.linalg.vector_norm(disp, dim=-1, keepdim=True)
    return compose_rt(rot, disp)


def root_frame(camera_position):
    """[3, 4] root frame: translate(-cam_pos) @ Rx(90°) (`Sphereflake.cpp:83`)."""
    pos = camera_position.to(torch.float32)
    rot = rotation_x(torch.deg2rad(pos.new_tensor(90.0)))
    return compose_rt(rot, -pos)


def level_radius(params: FractalParams, level):
    """Sphere radius at tree level `level` (root sphere = level 0)."""
    lvl = torch.as_tensor(
        level, dtype=torch.float32, device=params.root_radius.device
    )
    return params.root_radius * params.radius_ratio ** lvl
