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


def cursor_from_numpy(x) -> int:
    """A frameless cursor word, which the reference stores as a uint32
    scalar, as the Python int the port keeps on the host."""
    return int(np.asarray(x).astype(np.int64)) & 0xFFFFFFFF


def cursor_to_numpy(n: int) -> np.ndarray:
    """Inverse of `cursor_from_numpy`: the reference's uint32 scalar."""
    return np.asarray(n & 0xFFFFFFFF, dtype=np.uint32)


def _state_from_numpy(cls, d, device):
    """A frameless state dataclass from a dict of NumPy arrays keyed by
    the reference's field names: the cursor fields become Python ints,
    everything else a tensor on `device`."""
    return cls(**{
        f.name: (
            cursor_from_numpy(d[f.name])
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


def leaves_to_numpy(tree) -> list:
    """The NumPy leaves of `tree` in the reference pytree's order: a
    dataclass (a scene, a frameless state, `fit.AdamState`) by its
    fields in order, lists and tuples in order, None (optax's
    `EmptyState`) as no leaf. A tensor is one leaf; a Python int — the
    frameless cursor — is `cursor_to_numpy`'s uint32 scalar, and a
    cursor field held as an int64 tensor a uint32 array."""
    if isinstance(tree, torch.Tensor):
        return [tree.detach().cpu().numpy()]
    if tree is None:
        return []
    if isinstance(tree, int) and not isinstance(tree, bool):
        return [cursor_to_numpy(tree)]
    if isinstance(tree, (list, tuple)):
        return [a for x in tree for a in leaves_to_numpy(x)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [
            a for f in dataclasses.fields(tree)
            for a in (
                [_cursor_tensor_to_numpy(getattr(tree, f.name))]
                if _is_cursor_tensor(f.name, getattr(tree, f.name))
                else leaves_to_numpy(getattr(tree, f.name))
            )
        ]
    raise TypeError(f"no leaves for a {type(tree).__name__}")


def _is_cursor_tensor(name: str, value) -> bool:
    """A cursor field held as a tensor of uint32 words in int64 (the
    sharded frameless state's per-cell cursors)."""
    return name in _CURSOR_FIELDS and isinstance(value, torch.Tensor)


def _cursor_tensor_to_numpy(x: torch.Tensor) -> np.ndarray:
    """The reference's uint32 array of a cursor tensor."""
    return (x.detach().cpu().numpy() & 0xFFFFFFFF).astype(np.uint32)


def leaves_from_numpy(template, arrays):
    """Inverse of `leaves_to_numpy`: `template`'s structure filled with
    `arrays` in order. A tensor leaf takes the array's dtype and shape on
    the template leaf's device; an int leaf is a cursor word
    (`cursor_from_numpy`), and a cursor field held as a tensor takes the
    words as int64."""
    it = iter(arrays)

    def fill(t):
        if isinstance(t, torch.Tensor):
            return torch.tensor(np.asarray(next(it)), device=t.device)
        if t is None:
            return None
        if isinstance(t, int) and not isinstance(t, bool):
            return cursor_from_numpy(next(it))
        if isinstance(t, (list, tuple)):
            return type(t)(fill(x) for x in t)
        return dataclasses.replace(t, **{
            f.name: (
                torch.tensor(
                    np.asarray(next(it)).astype(np.int64) & 0xFFFFFFFF,
                    device=getattr(t, f.name).device,
                )
                if _is_cursor_tensor(f.name, getattr(t, f.name))
                else fill(getattr(t, f.name))
            )
            for f in dataclasses.fields(t)
        })

    return fill(template)


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
