"""Frozen copy of the SSAO noise texture generator (std::mt19937 seeded
with 12512, libstdc++'s uniform_real_distribution<float>(-1, 1), then
normalized; `SSAO.cpp:144-175`), taken from the program's
`ops/noise.py` when the benchmark was written. It is frozen here so that
a later change to the program cannot move the reference: the reference
makes its own texture.
"""

from __future__ import annotations

import functools

import numpy as np

_N, _M = 624, 397
_MATRIX_A = 0x9908B0DF
_UPPER = 0x80000000
_LOWER = 0x7FFFFFFF


class MT19937:
    """std::mt19937 (vectorized twist)."""

    def __init__(self, seed: int):
        mt = np.empty(_N, dtype=np.uint64)
        mt[0] = seed & 0xFFFFFFFF
        for i in range(1, _N):
            mt[i] = (1812433253 * (mt[i - 1] ^ (mt[i - 1] >> 30)) + i) & 0xFFFFFFFF
        self._mt = mt.astype(np.uint32)
        self._idx = _N

    def _twist(self):
        # Staged vectorization of the canonical loop: y-values use the old
        # state everywhere except the final element (which reads the new
        # mt[0]); the xor partner mt[i+M mod N] is old for i < N-M and new
        # after — the new-partner region factors into two dependency-free
        # vector steps of stride N-M.
        mt = self._mt
        y = (mt & np.uint32(_UPPER)) | (np.roll(mt, -1) & np.uint32(_LOWER))
        tv = (y >> 1) ^ np.where(y & 1, np.uint32(_MATRIX_A), np.uint32(0))
        k = _N - _M  # 227
        new = np.empty_like(mt)
        new[:k] = mt[_M:] ^ tv[:k]
        new[k : 2 * k] = new[:k] ^ tv[k : 2 * k]
        new[2 * k : _N - 1] = new[k : _N - 1 - k] ^ tv[2 * k : _N - 1]
        y_last = (mt[_N - 1] & np.uint32(_UPPER)) | (new[0] & np.uint32(_LOWER))
        tv_last = (y_last >> np.uint32(1)) ^ (
            np.uint32(_MATRIX_A) if y_last & 1 else np.uint32(0)
        )
        new[_N - 1] = new[_M - 1] ^ tv_last
        self._mt = new
        self._idx = 0

    def draw(self, n: int) -> np.ndarray:
        """n tempered uint32 outputs."""
        out = np.empty(n, dtype=np.uint32)
        filled = 0
        while filled < n:
            if self._idx >= _N:
                self._twist()
            take = min(n - filled, _N - self._idx)
            y = self._mt[self._idx : self._idx + take].copy()
            y ^= y >> 11
            y ^= (y << 7) & np.uint32(0x9D2C5680)
            y ^= (y << 15) & np.uint32(0xEFC60000)
            y ^= y >> 18
            out[filled : filled + take] = y
            self._idx += take
            filled += take
        return out


def uniform_neg1_1(engine: MT19937, n: int) -> np.ndarray:
    """libstdc++ uniform_real_distribution<float>(-1, 1): one 32-bit draw,
    ret = float(u32)/2^32 clamped below 1, then -1 + 2*ret."""
    u = engine.draw(n)
    ret = u.astype(np.float32) / np.float32(2**32)
    ret = np.minimum(ret, np.nextafter(np.float32(1.0), np.float32(0.0)))
    return np.float32(-1.0) + ret * np.float32(2.0)


@functools.lru_cache(maxsize=4)
def ssao_noise_texture(size: int = 64, seed: int = 12512) -> np.ndarray:
    """[size, size, 4] float32 — normalized uniform(-1,1) vec4s, row-major
    in texel index order exactly like `SSAO.cpp:151-163`."""
    eng = MT19937(seed)
    vals = uniform_neg1_1(eng, size * size * 4).reshape(size * size, 4)
    # glm::normalize in float32
    norm = np.sqrt(np.sum(vals.astype(np.float32) ** 2, axis=-1, keepdims=True))
    vals = (vals / norm).astype(np.float32)
    return vals.reshape(size, size, 4)
