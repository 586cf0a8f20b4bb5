"""Carrying parameters and intermediate tables across from NumPy.

The tests hand both packages the same inputs: the reference package's
parameter leaves and stage outputs, flattened to NumPy on the test's
side, enter the port through these helpers (the port itself never
touches the JAX package).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sphereflake_tpu_torch.config import (
    CameraParams,
    FractalParams,
    SSAOParams,
    SceneParams,
    resolve_device,
)


def tensor_from_numpy(x, device="cuda") -> torch.Tensor:
    """A NumPy array (or scalar) as a tensor on `device`: floats become
    float32, integers int32, bools stay bool."""
    dev = resolve_device(device)
    a = np.asarray(x)
    if a.dtype == np.bool_:
        pass
    elif np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int32)
    else:
        a = a.astype(np.float32)
    return torch.tensor(a, device=dev)  # copies; keeps 0-d arrays 0-d


def _leaves(cls, d, device):
    return cls(**{
        f.name: tensor_from_numpy(d[f.name], device)
        for f in dataclasses.fields(cls)
    })


def scene_from_numpy(d, device="cuda") -> SceneParams:
    """The port's `SceneParams` from a nested dict of NumPy arrays with
    the reference's leaf names: {"camera": {"position", "yaw", ...},
    "fractal": {...}, "ssao": {...}}."""
    return SceneParams(
        camera=_leaves(CameraParams, d["camera"], device),
        fractal=_leaves(FractalParams, d["fractal"], device),
        ssao=_leaves(SSAOParams, d["ssao"], device),
    )


def nodes_from_numpy(d, device="cuda") -> dict:
    """The node dict of `expand_global` (cx, cy, cz, cc, r2, code,
    code_hi, live, rad) from NumPy arrays."""
    return {k: tensor_from_numpy(v, device) for k, v in d.items()}


def geo_from_numpy(d, device="cuda") -> dict:
    """The geometry dict of `bin_geometry` from NumPy arrays (`n_nodes`
    stays a Python int)."""
    return {
        k: int(v) if k == "n_nodes" else tensor_from_numpy(v, device)
        for k, v in d.items()
    }


_CURSOR_FIELDS = ("sample_lo", "sample_hi", "seed", "samples_traced")


def _state_from_numpy(cls, d, device):
    """A frameless state dataclass from a dict of NumPy arrays keyed by
    the reference's field names: the uint32 cursor fields (which the
    port keeps on the host) become Python ints, everything else a
    tensor on `device`."""
    return cls(**{
        f.name: (
            int(np.asarray(d[f.name])) & 0xFFFFFFFF
            if f.name in _CURSOR_FIELDS
            else tensor_from_numpy(d[f.name], device)
        )
        for f in dataclasses.fields(cls)
    })


def tile_state_from_numpy(d, device="cuda"):
    """The port's `TileProgressiveState` continuing a reference state
    carried over as NumPy arrays (rows, covered, sample_lo, sample_hi,
    seed, closest_distance, samples_traced, overflow)."""
    from sphereflake_tpu_torch.runtime.progressive import TileProgressiveState

    return _state_from_numpy(TileProgressiveState, d, device)


def progressive_state_from_numpy(d, device="cuda"):
    """The port's `ProgressiveState` continuing a reference state
    carried over as NumPy arrays (position, normal, min_t, sample_lo,
    sample_hi, seed, closest_distance, samples_traced, overflow)."""
    from sphereflake_tpu_torch.runtime.progressive import ProgressiveState

    return _state_from_numpy(ProgressiveState, d, device)


def to_numpy(x):
    """Tensors (any device), and dicts / tuples / lists / dataclasses of
    them, as NumPy arrays of the same structure (a dataclass — a scene,
    a frameless state — becomes a dict by field name; Python ints, such
    as a state's cursor, pass through)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {
            f.name: to_numpy(getattr(x, f.name))
            for f in dataclasses.fields(x)
        }
    return x
