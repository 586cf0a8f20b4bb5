"""Checkpoint / resume of fitted parameters, optimizer state and
frameless state.

Counterpart of the reference package's `runtime/checkpoint.py`, in its
file format: one ``.npz`` whose named components are flattened in the
reference pytree's leaf order and stored as ``<name>/<i>`` arrays.
Loading fills a caller-provided *template* of the same structure (a
fresh scene, `fit.adam_init(...)`, a fresh frameless state), which keeps
the format free of pickled code. Files pass between the two packages
in both directions:

- `SceneParams`: 15 leaves (camera, fractal, ssao; `SceneParams.leaves`);
- `fit.AdamState`: optax's adam state, 31 leaves (32 with the cosine
  schedule's count);
- `ProgressiveState` / `TileProgressiveState`: their fields in order;
  the cursor, which the port keeps as host ints, is stored as uint32
  scalars like the reference's (`convert.leaves_to_numpy`);
- `parallel.ShardedTileState`: likewise, its per-cell cursors (int64
  tensors of uint32 words) as uint32 arrays.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from sphereflake_tpu_torch.convert import leaves_from_numpy, leaves_to_numpy


def save_checkpoint(path: str, **components: Any) -> None:
    """Save named components (e.g. scene=..., opt_state=...,
    progressive=...)."""
    out = {}
    for name, tree in components.items():
        if "/" in name:
            raise ValueError(f"component name may not contain '/': {name}")
        for i, leaf in enumerate(leaves_to_numpy(tree)):
            out[f"{name}/{i}"] = leaf
    np.savez(path, **out)


def load_checkpoint(path: str, templates: Mapping[str, Any]) -> dict:
    """Load components back into the structure of `templates`.

    Each template must have the same structure (and leaf count) as the
    saved component; leaf dtypes and shapes come from the file, devices
    from the template's leaves."""
    with np.load(path) as data:
        out = {}
        for name, template in templates.items():
            n_leaves = len(leaves_to_numpy(template))
            keys = [f"{name}/{i}" for i in range(n_leaves)]
            missing = [k for k in keys if k not in data]
            if missing:
                raise KeyError(
                    f"checkpoint {path} lacks leaves for component "
                    f"'{name}': {missing[:3]}{'...' if len(missing) > 3 else ''}"
                )
            n_stored = sum(
                1 for k in data.files if k.startswith(f"{name}/")
            )
            if n_stored != n_leaves:
                raise ValueError(
                    f"component '{name}': template has {n_leaves} "
                    f"leaves but checkpoint stores {n_stored}"
                )
            out[name] = leaves_from_numpy(template, [data[k] for k in keys])
    return out

