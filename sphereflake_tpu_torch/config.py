"""Configuration and parameter containers of the port.

Same split as the reference package's `config.py`:

- ``RenderConfig`` — static configuration (shapes, tile sizes, depth
  bounds, capacities). A plain frozen dataclass, field for field and
  error for error the reference's, so both packages size every table
  identically.
- ``CameraParams`` / ``FractalParams`` / ``SSAOParams`` /
  ``SceneParams`` — dataclasses of float32 tensors with the reference's
  leaf names. Every leaf is a tensor on one device; mark leaves
  ``requires_grad`` and the frame builds its graph (`fit.py`).

The port renders every algorithm of the reference: ``"binned"``,
``"pallas"``, ``"fast"``, ``"strict"`` and ``"loose"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """The device an entry point was asked for — or an error. Asking
    for "cuda" on a machine without one raises; nothing falls back to
    the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was requested but torch.cuda.is_available() "
            "is False; pass device='cpu' explicitly to run on the CPU"
        )
    return dev


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float32)).to(device)


class _Leaves:
    """Shared helpers of the parameter dataclasses."""

    def to(self, device):
        """Copy with every leaf moved to `device` (nested)."""
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
            },
        )

    @property
    def device(self) -> torch.device:
        leaf = getattr(self, dataclasses.fields(self)[0].name)
        return leaf.device


@dataclasses.dataclass
class CameraParams(_Leaves):
    """Pinhole camera, parameterized like the reference app
    (`camera.h:7-123`): position + Euler angles + fov.

    Naming quirk preserved: ``yaw`` rotates about the *x* axis and
    ``pitch`` about *y* (`camera.h:65-68` builds
    `quat(vec3(m_Yaw, m_Pitch, m_Roll))`, GLM reads it as (x, y, z))."""

    position: torch.Tensor  # [3] world position
    yaw: torch.Tensor  # rotation about x (radians)
    pitch: torch.Tensor  # rotation about y (radians)
    roll: torch.Tensor  # rotation about z (radians)
    fov: torch.Tensor  # field of view in DEGREES (reference: 60)

    @staticmethod
    def reference_default(device="cuda") -> "CameraParams":
        """The hardcoded startup pose of the reference app (`main.cpp:93-96`)."""
        dev = resolve_device(device)
        return CameraParams(
            position=_f32([-5.4098, -7.2139, 1.19006], dev),
            yaw=_f32(0.921999, dev),
            pitch=_f32(-1.371, dev),
            roll=_f32(0.0, dev),
            fov=_f32(60.0, dev),
        )


@dataclasses.dataclass
class FractalParams(_Leaves):
    """Sphereflake geometry: the 9-ary child layout of
    `Sphereflake.cpp:216-249` (6 equatorial + 3 polar children, child
    radius = parent/3, tangent displacement) as parameters."""

    radius_ratio: torch.Tensor  # child_radius / parent_radius (reference: 1/3)
    root_radius: torch.Tensor  # radius of the top sphere (reference: 1)
    child_rotations_deg: torch.Tensor  # [9, 3] XYZ Euler angles in degrees
    child_longlat_deg: torch.Tensor  # [9, 2] (longitude, latitude) of displacement

    @staticmethod
    def reference_default(device="cuda") -> "FractalParams":
        dev = resolve_device(device)
        rotations = np.zeros((9, 3), dtype=np.float32)
        longlat = np.zeros((9, 2), dtype=np.float32)
        for i in range(6):  # equatorial ring (Sphereflake.cpp:218-231)
            rotations[i] = (90.0, 90.0 + 60.0 * i, 0.0)
            longlat[i] = (90.0, 60.0 * i)
        polar_rotations = [(325.0, 45.0, 15.0), (145.0, 230.0, 165.0), (60.0, 0.0, 0.0)]
        for i in range(3):  # polar cap (Sphereflake.cpp:233-248)
            rotations[6 + i] = polar_rotations[i]
            longlat[6 + i] = (30.0, 30.0 + 120.0 * i)
        return FractalParams(
            radius_ratio=_f32(1.0 / 3.0, dev),
            root_radius=_f32(1.0, dev),
            child_rotations_deg=_f32(rotations, dev),
            child_longlat_deg=_f32(longlat, dev),
        )


@dataclasses.dataclass
class SSAOParams(_Leaves):
    """SSAO/blur/composite tuning (`SSAO.cpp:49-55`) and the radius law
    `SSAOSampleRadius = 8 * closestSphereDistance` (`SSAO.h:15-18`)."""

    intensity: torch.Tensor  # 0.51
    scale: torch.Tensor  # 3.28
    bias: torch.Tensor  # 0.23
    normal_threshold: torch.Tensor  # 2.47 (blur edge gate)
    depth_threshold: torch.Tensor  # 0.01
    radius_multiplier: torch.Tensor  # 8.0 (SSAO.h:17)

    @staticmethod
    def reference_default(device="cuda") -> "SSAOParams":
        dev = resolve_device(device)
        return SSAOParams(
            intensity=_f32(0.51, dev),
            scale=_f32(3.28, dev),
            bias=_f32(0.23, dev),
            normal_threshold=_f32(2.47, dev),
            depth_threshold=_f32(0.01, dev),
            radius_multiplier=_f32(8.0, dev),
        )


@dataclasses.dataclass
class SceneParams(_Leaves):
    """The full parameter tree: `params -> image`."""

    camera: CameraParams
    fractal: FractalParams
    ssao: SSAOParams

    @property
    def device(self) -> torch.device:
        return self.camera.device

    def leaves(self) -> list:
        """The 15 leaf tensors in the reference pytree's order: camera
        (position, yaw, pitch, roll, fov), fractal (radius_ratio,
        root_radius, child_rotations_deg, child_longlat_deg), ssao (6)."""
        return [
            getattr(group, f.name)
            for group in (self.camera, self.fractal, self.ssao)
            for f in dataclasses.fields(group)
        ]

    @staticmethod
    def from_leaves(leaves) -> "SceneParams":
        """Inverse of `leaves`."""
        it = iter(leaves)
        groups = [
            cls(**{f.name: next(it) for f in dataclasses.fields(cls)})
            for cls in (CameraParams, FractalParams, SSAOParams)
        ]
        return SceneParams(*groups)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration — the reference's `RenderConfig`,
    field for field (defaults included), so capacities and tile grids
    agree between the two packages."""

    width: int = 1280
    height: int = 720
    max_depth: int = 4  # deepest fractal level rendered (level 0 = root sphere)
    lod_factor: float = 70.0  # recurse while sqrt(t/r) < lod_factor
    tile_h: int = 64  # screen-tile height
    tile_w: int = 128  # screen-tile width
    max_frontier: int = 1024  # per-tile cap on live spheres per level
    tile_batch: int = 16  # tiles traced concurrently (per-tile paths)
    # "binned": global expansion + screen binning + the fused kernel
    #           (production).
    # "pallas": the per-tile traversal kernel (every tile on its own).
    # "fast":   plain-op levelwise traversal with tile-cone culling.
    # "strict" / "loose": the parity traversal (per-ray gating while
    #           strict_lod, per-node gating without it).
    algorithm: str = "fast"
    strict_lod: bool = True
    # Binned path: render the frame in horizontal bands of this many
    # tile rows, each binned separately (bounds the pair table for very
    # large frames). None = auto: whole frame when it fits the pair
    # table comfortably, else ~2048-tile bands.
    band_tile_rows: int | None = None
    # Binned path: live-node capacity per fractal level once the dense
    # level width would exceed it. Overflow is counted, never silent,
    # and the compaction drops farthest-first. The default is 9x the
    # pre-expansion cap (global_cap // 9), so a compacted level's
    # children exactly fill the next level with no second sort.
    global_cap: int = 9 << 13
    ssao_downscale: int = 1  # SSAO target downscale (main.cpp:118 uses 1)
    noise_size: int = 64  # SSAO noise texture size (SSAO.h:4)
    background: float = 0.0  # sky writes zeros (post_final.glsl:20-24)

    def __post_init__(self):
        if self.algorithm in ("pallas", "binned"):
            # One tile is one 1024-ray block; the image is padded to a
            # tile multiple and cropped after.
            if self.tile_h * self.tile_w != 1024:
                raise ValueError(
                    "algorithm='pallas' requires tile_h * tile_w == 1024 "
                    f"(one vreg of rays), got {self.tile_h}x{self.tile_w}"
                )
        elif self.width % self.tile_w or self.height % self.tile_h:
            raise ValueError(
                f"image {self.width}x{self.height} must be divisible by "
                f"tile {self.tile_w}x{self.tile_h}"
            )
        if self.algorithm == "binned" and self.max_depth > 13:
            raise ValueError(
                f"max_depth {self.max_depth} > 13 is not renderable in "
                "f32: the two-lane path code is exact only through "
                "level 13 (hi < 9^7 < 2^24), and level-13 spheres "
                "(radius 3^-13 ~ 6.3e-7) already sit near the f32 "
                "relative-precision floor of the center coordinates "
                "(eps ~ 1.2e-7) — deeper levels would render garbage, "
                "not geometry (see ops/binned.py DEEP_MAX_DEPTH)"
            )
        if self.max_depth < 0:
            raise ValueError("max_depth must be >= 0")
        if self.band_tile_rows is not None:
            if self.algorithm != "binned":
                raise ValueError("band_tile_rows requires algorithm='binned'")
            if self.tiles_y % self.band_tile_rows:
                raise ValueError(
                    f"tiles_y {self.tiles_y} not divisible by "
                    f"band_tile_rows {self.band_tile_rows}"
                )

    @property
    def pair_cap(self) -> int:
        """Static (node, tile) pair-table capacity for the binned path:
        the max of a tile term (64 per tile, rounded up to 2048), a
        node term (2 * global_cap) that grows with depth past level 6,
        capped at 2^20. Overflow is counted; the capacity ladder
        (`render.grow_capacity`) doubles global_cap on retry."""
        tiles = self.tiles_x * self.tiles_y
        depth_levels = max(1, self.max_depth - 6)
        return min(
            1 << 20,
            max(2 * self.global_cap * depth_levels,
                -(-tiles * 64 // 2048) * 2048),
        )

    @property
    def effective_band_rows(self) -> int | None:
        """Band height in tile rows for the binned path, or None for a
        whole-frame bin. Auto-bands frames whose tile count would
        overflow the pair table (~2048 tiles per band)."""
        if self.band_tile_rows is not None:
            return self.band_tile_rows
        if self.algorithm != "binned" or self.tiles_x * self.tiles_y <= 4096:
            return None
        rows = max(1, 2048 // self.tiles_x)
        while rows > 1 and self.tiles_y % rows:
            rows -= 1
        return rows

    @property
    def padded_width(self) -> int:
        """Width rounded up to a tile multiple (padded, cropped after)."""
        return -(-self.width // self.tile_w) * self.tile_w

    @property
    def padded_height(self) -> int:
        return -(-self.height // self.tile_h) * self.tile_h

    @property
    def tiles_x(self) -> int:
        return self.padded_width // self.tile_w

    @property
    def tiles_y(self) -> int:
        return self.padded_height // self.tile_h

    @property
    def aspect(self) -> float:
        return self.width / self.height


def default_scene(device="cuda") -> SceneParams:
    """Scene parameters matching the reference app's startup state."""
    return SceneParams(
        camera=CameraParams.reference_default(device),
        fractal=FractalParams.reference_default(device),
        ssao=SSAOParams.reference_default(device),
    )
