"""The inputs a cell hands to both sides: scenes and camera poses, made
from the configuration and the seed.

A scene is a dict of groups (camera, fractal, ssao) of float32 NumPy
leaves. The program gets them as its `SceneParams`; the reference gets
the same float32 values as float64 tensors, so both start from identical
inputs.
"""

from __future__ import annotations

import math
import random

import numpy as np

GROUPS = {
    "camera": ("position", "yaw", "pitch", "roll", "fov"),
    "fractal": ("radius_ratio", "root_radius", "child_rotations_deg",
                "child_longlat_deg"),
    "ssao": ("intensity", "scale", "bias", "normal_threshold",
             "depth_threshold", "radius_multiplier"),
}


def rng(seed: int, stream: str) -> random.Random:
    """A generator of its own for each use of the seed."""
    return random.Random(f"{int(seed)}:{stream}")


def base_scene(config: dict) -> dict:
    s = config["scene"]
    return {g: {k: np.asarray(s[g][k], np.float32) for k in keys}
            for g, keys in GROUPS.items()}


def orbit_position(base, angle: float, radius: float):
    """The orbit's camera position at `angle` about the world Y axis from
    `base`, at distance `radius` from the origin (float64)."""
    c, s = math.cos(angle), math.sin(angle)
    b = np.asarray(base, np.float64)
    pos = np.array([c * b[0] + s * b[2], b[1], -s * b[0] + c * b[2]])
    return pos * (radius / np.linalg.norm(pos))


def look_at_origin(pos):
    """(yaw, pitch) that aim the camera's -Z axis at the origin (rotation
    Rz(roll) Ry(pitch) Rx(yaw)): yaw = asin(f_y), pitch = atan2(-f_x,
    -f_z) for f = -pos / |pos|."""
    f = -np.asarray(pos, np.float64) / np.linalg.norm(pos)
    return math.asin(max(-1.0, min(1.0, f[1]))), math.atan2(-f[0], -f[2])


def posed(scene: dict, angle: float) -> dict:
    """`scene` with its camera moved `angle` radians round the orbit
    (same radius), looking at the origin; float32 leaves."""
    cam = scene["camera"]
    radius = float(np.linalg.norm(cam["position"].astype(np.float64)))
    pos = orbit_position(cam["position"], angle, radius)
    yaw, pitch = look_at_origin(pos)
    out = {g: dict(v) for g, v in scene.items()}
    out["camera"].update(position=pos.astype(np.float32),
                         yaw=np.float32(yaw), pitch=np.float32(pitch))
    return out


def seeded_angle(seed: int) -> float:
    return 2.0 * math.pi * rng(seed, "angle").random()


def to_program(scene: dict, device):
    """The program's `SceneParams` of `scene`, on `device`."""
    import torch

    from sphereflake_tpu_torch.config import (
        CameraParams, FractalParams, SceneParams, SSAOParams,
    )

    def group(cls, g):
        return cls(**{k: torch.as_tensor(np.array(v, np.float32)).to(device)
                      for k, v in scene[g].items()})

    return SceneParams(camera=group(CameraParams, "camera"),
                       fractal=group(FractalParams, "fractal"),
                       ssao=group(SSAOParams, "ssao"))


def to_reference(scene: dict, device):
    """The reference's scene: the same leaves as float64 tensors."""
    import torch

    return {g: {k: torch.as_tensor(np.array(v, np.float64), device=device)
                for k, v in leaves.items()}
            for g, leaves in scene.items()}
