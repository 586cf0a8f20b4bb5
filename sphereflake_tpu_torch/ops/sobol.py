"""Sobol quasi-Monte-Carlo sampler (torch + NumPy).

Counterpart of the reference package's `ops/sobol.py`. The C++ app
vendors Gruenschloss' scalar implementation of Joe-Kuo (2008) direction
numbers — 1024 dims x 52 bits — and evaluates one sample at a time
(`Sobol.cpp:41-55`):

    result = scramble;  for each set bit i of index: result ^= M[dim][i]
    return result * 2^-32

Here the direction numbers are *constructed* from the standard
primitive-polynomial recurrence (`_joekuo.py` holds the published
(s, a, m) parameters), and evaluation is one [K, 64] bit table against
the direction row followed by a six-step XOR fold — about fifteen
device launches for any K, where a bit-by-bit loop would launch 52 x 5.
The renderer uses dims 0-1 (pixel x/y, `Sphereflake.cpp:139-140`).

torch has no usable uint32 arithmetic: every 32-bit quantity rides an
int64 tensor holding a value in [0, 2^32).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sphereflake_tpu_torch.ops._joekuo import JOE_KUO_PARAMS as _JOE_KUO

N_BITS = 52  # index bits supported, like the C++ table (Sobol.cpp:37)

NUM_DIMENSIONS = len(_JOE_KUO) + 1  # 1024, matching Sobol.cpp:35

_M32 = 0xFFFFFFFF
_FOLD = 64  # N_BITS padded to a power of two for the XOR tree


@functools.lru_cache(maxsize=1)
def direction_numbers() -> np.ndarray:
    """[NUM_DIMENSIONS, N_BITS] uint32 direction-number matrix.

    dim 0 is the van der Corput sequence (identity matrix,
    v_k = 2^(31-k)); dim j >= 1 uses the degree-s primitive polynomial
    with encoded coefficient `a` and initial odd values m_1..m_s:

        v_k = m_k << (32-k)                       for k <= s
        v_k = v_{k-s} ^ (v_{k-s} >> s) ^ XOR_{i=1}^{s-1} a_i * v_{k-i}
    """
    out = np.zeros((NUM_DIMENSIONS, N_BITS), dtype=np.uint32)
    # dim 0: van der Corput — identity bit matrix; bits past 32 are 0
    for k in range(min(32, N_BITS)):
        out[0, k] = np.uint32(1) << np.uint32(31 - k)
    for d, (s, a, m) in enumerate(_JOE_KUO, start=1):
        v = np.zeros(N_BITS, dtype=np.uint64)
        for k in range(N_BITS):
            if k < s:
                v[k] = np.uint64(m[k]) << np.uint64(31 - k)
            else:
                val = v[k - s] ^ (v[k - s] >> np.uint64(s))
                for i in range(1, s):
                    if (a >> (s - 1 - i)) & 1:
                        val ^= v[k - i]
                v[k] = val
        out[d] = v.astype(np.uint32)
    return out


def sobol_sample_np(index, dim: int, scramble=0) -> np.ndarray:
    """NumPy golden evaluation, bit-identical to `Sobol.cpp:41-55`."""
    index = np.asarray(index, dtype=np.uint64)
    scramble = np.asarray(scramble, dtype=np.uint32)
    dirs = direction_numbers()[dim]
    result = np.broadcast_to(scramble, index.shape).copy()
    for i in range(N_BITS):
        bit = ((index >> np.uint64(i)) & np.uint64(1)).astype(bool)
        result ^= np.where(bit, dirs[i], np.uint32(0))
    return result.astype(np.float64) * float(2.0**-32)


@functools.lru_cache(maxsize=8)
def _direction_row(dim: int, device: torch.device) -> torch.Tensor:
    """[64] int64: direction numbers of `dim`, zero past bit 51, on
    `device` (uploaded once per (dim, device))."""
    row = np.zeros(_FOLD, dtype=np.int64)
    row[:N_BITS] = direction_numbers()[dim]
    return torch.from_numpy(row).to(device)


def _as_u32(x):
    """A uint32 value as it takes part in int64 arithmetic: an integer
    tensor becomes int64, a Python int stays one (it broadcasts as a
    scalar, at no launch)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return int(x) & _M32


def sobol_sample(index_lo, dim: int, scramble=0, index_hi=0, device=None):
    """Vectorised torch evaluation.

    The 52-bit sample index is passed as two uint32 halves
    (index = index_hi * 2^32 + index_lo) held in int64 tensors (or
    Python ints); `dim` is a static int; `scramble` broadcasts as
    uint32. Runs on the device of `index_lo` (or `device` when every
    input is a Python int). Returns float32 in [0, 1]: the uint32 result
    is converted to float32 (round to nearest even) and then scaled by
    2^-32, so the top 128 values give exactly 1.0, as in the reference —
    callers clamp.
    """
    if device is None:
        device = next(
            (x.device for x in (index_lo, scramble, index_hi)
             if isinstance(x, torch.Tensor)),
            torch.device("cpu"),
        )
    device = torch.device(device)
    lo, hi, scr = _as_u32(index_lo), _as_u32(index_hi), _as_u32(scramble)
    row = _direction_row(dim, device)
    # Bits 52.. of the index select nothing (the table has 52 rows), so
    # only the low 20 bits of the hi word take part.
    index = ((hi & 0xFFFFF) << 32) | lo
    if not isinstance(index, torch.Tensor):
        index = torch.full((), index, dtype=torch.int64, device=device)
    shifts = torch.arange(_FOLD, dtype=torch.int64, device=device)
    bits = (index[..., None] >> shifts) & 1  # [..., 64]
    x = bits * row
    width = _FOLD
    while width > 1:  # XOR fold: 64 -> 32 -> ... -> 1
        width //= 2
        x = x[..., :width] ^ x[..., width:]
    result = x[..., 0] ^ scr
    return result.to(torch.float32) * float(2.0**-32)
