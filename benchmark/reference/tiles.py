"""Plain NumPy reference of the frameless tile stream: which tiles a
refresh step traces, independent of the program.

The C++ app's workers refresh packets chosen by a Sobol stream with a
per-run scramble (`Sphereflake.cpp:139-150`); with a tile as the packet,
step s of a stream of k tiles a step traces the tiles of Sobol indices
s k ... s k + k - 1 in dimension 0: u = bitreverse32(index) XOR
scramble, the scramble a 32-bit integer hash of the seed; tile =
min(int(f32(f32(u) 2^-32) f32(T)), T - 1) over T tiles.
"""

from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF


def hash_u32(x: int) -> int:
    """The scramble of a seed: a 32-bit xorshift-multiply hash."""
    x = int(x) & M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & M32
    x ^= x >> 16
    return x & M32


def bitreverse32(v):
    v = np.asarray(v, dtype=np.uint64) & np.uint64(M32)
    out = np.zeros_like(v)
    for i in range(32):
        out |= ((v >> np.uint64(i)) & np.uint64(1)) << np.uint64(31 - i)
    return out


def step_tiles(seed: int, step: int, k: int, n_tiles: int) -> np.ndarray:
    """The tile ids [k] (int64) that step `step` (from 0) of a stream of
    `k` tiles a step traces, for `seed`, over `n_tiles` tiles."""
    index = np.arange(step * k, step * k + k, dtype=np.uint64)
    u = (bitreverse32(index) ^ np.uint64(hash_u32(seed))).astype(np.uint32)
    s = u.astype(np.float32) * np.float32(2.0 ** -32)
    ids = (s * np.float32(n_tiles)).astype(np.int64)
    return np.minimum(ids, n_tiles - 1)
