"""Small 3D math helpers (torch).

Counterpart of the reference package's `ops/transforms.py` (itself the
replacement of the C++ app's `Util.h:7-18` and the 4x4 vocabulary of
`SIMD_AVX.h:29-81`). Convention: column-vector matrices, ``p' = M @ p``,
composition ``A @ B`` applies B first.

All functions broadcast over leading batch dimensions.

Matrix products here are 3x3 and are written as broadcast multiply +
sum (`matmul3`, `matvec3`) rather than `torch.matmul`: they stay in
full float32 whatever `torch.backends.cuda.matmul.allow_tf32` says, and
never go through a BLAS library.
"""

from __future__ import annotations

import torch


def matmul3(a, b):
    """[..., i, k] @ [..., k, j] for tiny matrices, in full float32."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def matvec3(a, v):
    """[..., i, k] @ [..., k] for tiny matrices, in full float32."""
    return (a * v[..., None, :]).sum(dim=-1)


def spherical_to_world(longitude, latitude):
    """`Util.h:7-11`: (cos(lat)·sin(lon), sin(lat)·sin(lon), cos(lon)).

    Args are radians; broadcasts; returns [..., 3].
    """
    sin_lon = torch.sin(longitude)
    return torch.stack(
        [
            torch.cos(latitude) * sin_lon,
            torch.sin(latitude) * sin_lon,
            torch.cos(longitude),
        ],
        dim=-1,
    )


def rotation_x(a):
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([o, z, z], -1),
            torch.stack([z, c, -s], -1),
            torch.stack([z, s, c], -1),
        ],
        dim=-2,
    )


def rotation_y(a):
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, z, s], -1),
            torch.stack([z, o, z], -1),
            torch.stack([-s, z, c], -1),
        ],
        dim=-2,
    )


def rotation_z(a):
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, -s, z], -1),
            torch.stack([s, c, z], -1),
            torch.stack([z, z, o], -1),
        ],
        dim=-2,
    )


def euler_xyz_rotation(rot_deg):
    """`Util.h:13-18`: R = Rx(x) @ Ry(y) @ Rz(z), angles in degrees.

    rot_deg: [..., 3] -> [..., 3, 3].
    """
    r = torch.deg2rad(rot_deg)
    return matmul3(
        matmul3(rotation_x(r[..., 0]), rotation_y(r[..., 1])),
        rotation_z(r[..., 2]),
    )


def compose_rt(rotation, translation):
    """Pack a [..., 3, 3] rotation and [..., 3] translation into
    [..., 3, 4]. The fractal transform chain is rigid, so 3x4 affine
    frames suffice (no homogeneous bottom row)."""
    return torch.cat([rotation, translation[..., :, None]], dim=-1)


def rt_multiply(a, b):
    """Compose 3x4 affine frames: result = a ∘ b (apply b first):
    R = Ra@Rb, t = Ra@tb + ta. Broadcasts."""
    ra, ta = a[..., :3], a[..., 3]
    rb, tb = b[..., :3], b[..., 3]
    r = matmul3(ra, rb)
    t = matvec3(ra, tb) + ta
    return torch.cat([r, t[..., :, None]], dim=-1)


def rt_translation(a):
    """The translation column (the sphere origin the C++ app reads via
    `parentTransform.Extract(3)`, `Sphereflake.h:116`)."""
    return a[..., 3]


def normalize(v, dim=-1, eps=0.0):
    """Exact-math normalize (true sqrt and divide)."""
    n2 = torch.sum(v * v, dim=dim, keepdim=True)
    return v / torch.sqrt(n2 + eps)


def look_rotation(yaw, pitch, roll):
    """Camera orientation of the C++ app (`camera.h:65-68`):
    quat(vec3(yaw, pitch, roll)) = Rz(roll) @ Ry(pitch) @ Rx(yaw) on
    column vectors — its "yaw" is a rotation about x."""
    return matmul3(matmul3(rotation_z(roll), rotation_y(pitch)), rotation_x(yaw))
