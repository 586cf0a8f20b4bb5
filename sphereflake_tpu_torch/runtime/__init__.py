"""Run-time loops of the port: frameless accumulation and the camera
paths that feed it."""

from sphereflake_tpu_torch.runtime.progressive import (  # noqa: F401
    ProgressiveState,
    TileProgressiveState,
    progressive_init,
    progressive_prepare,
    progressive_prepare_trimmed,
    progressive_step,
    progressive_tiles_init,
    progressive_tiles_step,
    tile_progressive_composite,
    tile_progressive_gbuffer,
)
