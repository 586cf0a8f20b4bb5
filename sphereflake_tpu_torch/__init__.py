"""sphereflake_tpu_torch — the PyTorch/CUDA port of the sphereflake renderer.

The JAX/XLA/Pallas package `sphereflake_tpu` beside this one is the
reference; this package computes the same functions with plain torch
ops and hand-written CUDA kernels for NVIDIA Hopper (sm_90a). It
imports `torch` and `numpy` only — never `jax`, and nothing of the JAX
package (it keeps its own copy of every JAX-free helper it needs).

Ported: everything the reference does on one device. The full-frame
forward path, `render_frame` = `render_gbuffer` (algorithm "binned":
global expansion -> screen-tile binning -> the fused
raygen+trace+shade kernel -> untile) + `postprocess` (SSAO -> blur x2
-> composite); the frameless refresh path (`runtime/progressive.py`:
Sobol-chosen tiles or pixels accumulated into one persistent G-buffer,
through the kernel's subset and ray-bundle modes); the camera paths
(`runtime/animate.py`: one full frame per step, or the camera moving
while the frameless buffer accumulates); the per-tile traversal paths
("pallas", "fast") and the parity traversal ("strict", "loose"), held
against the per-ray golden tracer (`models/golden.py`,
`models/golden_post.py`: NumPy copies of the reference's); gradients on
every path (on "binned" through `ops.binned.BinnedGBuffer`, a recompute
from the kernel's path codes), fitting (`fit.py`) and checkpoints
(`runtime/checkpoint.py`, the reference's file format); and the CLI
that drives them (`python -m sphereflake_tpu_torch`: `--progressive`,
`--animate`, `--fit`, `--checkpoint`, `--resume`, `--profile`). Not
ported yet: the multi-device paths (`torch.distributed`) and the native
host library (PNG encoder, Sobol, mt19937).

Every entry point takes an explicit `device` (default "cuda"); asking
for "cuda" on a machine without one raises — nothing moves to the CPU
on its own. Sub-packages mirror the reference (`ops/`, `models/`,
`runtime/`, `utils/`) so each counterpart is found under the same name.
"""

__version__ = "0.1.0"

from sphereflake_tpu_torch.config import (  # noqa: F401
    CameraParams,
    FractalParams,
    RenderConfig,
    SSAOParams,
    SceneParams,
    default_scene,
)
