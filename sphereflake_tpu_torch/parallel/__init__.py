"""Multi-device rendering and fitting: device meshes over screen blocks,
the shared bin, sharded frameless accumulation, frame data parallelism
and multi-process runs over `torch.distributed`."""

from sphereflake_tpu_torch.parallel.frameless import (  # noqa: F401
    ShardedTileState,
    sharded_tiles_as_single,
    sharded_tiles_init,
    sharded_tiles_step,
)
from sphereflake_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from sphereflake_tpu_torch.parallel.shared_bin import (  # noqa: F401
    render_gbuffer_shared,
    shared_bin_supported,
)
from sphereflake_tpu_torch.parallel.sharded import (  # noqa: F401
    fit_step_sharded,
    make_frame_mesh,
    render_frame_sharded,
    render_frames_dp,
    render_gbuffer_sharded,
)
