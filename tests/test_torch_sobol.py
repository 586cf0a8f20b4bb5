"""The port's Sobol sampler, scramble hash and stream cursor
(`sphereflake_tpu_torch/ops/sobol.py`, `runtime/progressive.py`) vs the
reference package's. Everything here is integer arithmetic followed by
one exact conversion, so every comparison is bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphereflake_tpu.ops import _joekuo as ref_joekuo
from sphereflake_tpu.ops import sobol as ref_sobol
from sphereflake_tpu.runtime import progressive as ref_prog
from sphereflake_tpu_torch.config import RenderConfig as PortConfig
from sphereflake_tpu_torch.ops import _joekuo as port_joekuo
from sphereflake_tpu_torch.ops import sobol as port_sobol
from sphereflake_tpu_torch.runtime import progressive as port_prog

import _torch_helpers  # noqa: F401  (one torch thread per test worker)


def _lo(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)


def test_direction_numbers_and_parameter_table_equal():
    assert port_joekuo.JOE_KUO_PARAMS == ref_joekuo.JOE_KUO_PARAMS
    got, want = port_sobol.direction_numbers(), ref_sobol.direction_numbers()
    assert got.dtype == want.dtype == np.uint32
    assert got.shape == (1024, 52)
    np.testing.assert_array_equal(got, want)
    assert port_sobol.NUM_DIMENSIONS == ref_sobol.NUM_DIMENSIONS
    assert port_sobol.N_BITS == ref_sobol.N_BITS


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("scramble", [0, 12345, 2**31 + 77, 2**32 - 1])
@pytest.mark.parametrize("index_hi", [0, 3, 2**20 - 1, 2**31 + 5])
def test_sobol_sample_matches_reference_bit_for_bit(dim, scramble, index_hi):
    lo = _lo(2048, 1000 * dim + index_hi % 97)
    want = np.asarray(ref_sobol.sobol_sample(
        jnp.asarray(lo), dim, np.uint32(scramble), np.uint32(index_hi)
    ))
    got = port_sobol.sobol_sample(
        torch.from_numpy(lo.astype(np.int64)), dim, scramble, index_hi
    )
    assert got.dtype == torch.float32 and got.shape == (2048,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dim", [0, 1, 7, 1023])
def test_sobol_sample_matches_numpy_golden(dim):
    """Against the scalar-loop golden (`Sobol.cpp:41-55` semantics) over
    52-bit indices: same uint32, then the f32 conversion the sampler
    documents (round to nearest even, then an exact scale by 2^-32)."""
    rng = np.random.default_rng(dim)
    index = rng.integers(0, 2**52, size=1024, dtype=np.uint64)
    scramble = 2**31 + 12345
    golden = port_sobol.sobol_sample_np(index, dim, scramble)
    np.testing.assert_array_equal(
        golden, ref_sobol.sobol_sample_np(index, dim, scramble)
    )
    as_uint = (golden * 2.0**32).astype(np.uint64)
    want = as_uint.astype(np.float32) * np.float32(2.0**-32)
    got = port_sobol.sobol_sample(
        torch.from_numpy((index & 0xFFFFFFFF).astype(np.int64)), dim,
        scramble, torch.from_numpy((index >> 32).astype(np.int64)),
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_top_values_round_to_exactly_one():
    """uint32 -> float32 rounds to nearest even, so the top 128 values
    give exactly 1.0 — in both packages; the callers clamp."""
    lo = np.asarray([2**32 - 1, 2**32 - 2, 1, 0], np.uint32)
    want = np.asarray(ref_sobol.sobol_sample(jnp.asarray(lo), 0))
    got = port_sobol.sobol_sample(torch.from_numpy(lo.astype(np.int64)), 0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0].item() == 1.0 and got[1].item() == 0.5
    # dim 0 reverses the bits: scramble 0xFFFFFF80 with index 0 is
    # 2^32 - 128, the smallest value that rounds up to 2^32.
    edge = port_sobol.sobol_sample(
        torch.zeros(2, dtype=torch.int64), 0,
        torch.tensor([2**32 - 128, 2**32 - 129]),
    )
    assert edge[0].item() == 1.0 and edge[1].item() < 1.0


def test_python_int_inputs_and_device_argument():
    got = port_sobol.sobol_sample(5, 1, 7, 0, device="cpu")
    want = np.asarray(ref_sobol.sobol_sample(5, 1, 7, 0))
    assert got.shape == () and got.item() == want.item()


@pytest.mark.parametrize(
    "seed", [0, 1, 7, 2**31 - 1, 2**31, 2**31 + 5, 2**32 - 1]
)
def test_hash_u32_matches_reference_for_ints(seed):
    want = int(ref_prog._hash_u32(jnp.uint32(seed)))
    assert port_prog._hash_u32(seed) == want
    assert port_prog._hash_u32(seed + 2**32) == want  # wraps like uint32


def test_hash_u32_matches_reference_for_tensors():
    x = np.concatenate([
        _lo(4096, 3),
        np.asarray([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32),
    ])
    want = np.asarray(ref_prog._hash_u32(jnp.asarray(x)))
    got = port_prog._hash_u32(torch.from_numpy(x.astype(np.int64)))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def _reference_tile_ids(seed, lo, hi, n, T):
    """`progressive_tiles_step`'s id computation, from the reference's
    own functions (`runtime/progressive.py:484-490`)."""
    lane = jnp.arange(n, dtype=jnp.uint32)
    sample_lo, sample_hi = jnp.uint32(lo), jnp.uint32(hi)
    idx_lo = sample_lo + lane
    carry = (idx_lo < sample_lo).astype(jnp.uint32)
    idx_hi = sample_hi + carry
    scr = jnp.broadcast_to(ref_prog._hash_u32(jnp.uint32(seed)), lane.shape)
    s = ref_sobol.sobol_sample(idx_lo, 0, scr, idx_hi)
    ids = jnp.minimum((s * T).astype(jnp.int32), T - 1)
    next_lo = idx_lo[-1] + jnp.uint32(1)
    next_hi = idx_hi[-1] + (next_lo == 0).astype(jnp.uint32)
    return np.asarray(ids), int(next_lo), int(next_hi)


@pytest.mark.parametrize(
    "seed,lo,hi,n",
    [
        (0, 0, 0, 1024),
        (1, 24 * 1024, 0, 1024),
        (2**31 + 5, 12345, 7, 256),
        (3, 2**32 - 4, 0, 4),  # lands exactly on the 2^32 boundary
        (3, 2**32 - 100, 5, 256),  # wraps inside the step
        (9, 2**32 - 1, 2**32 - 1, 8),  # both words wrap
    ],
)
def test_tile_ids_and_cursor_match_reference(seed, lo, hi, n):
    cfg = PortConfig(width=1920, height=1080, max_depth=2, tile_h=32,
                     tile_w=32, algorithm="binned")
    T = cfg.tiles_x * cfg.tiles_y
    state = port_prog.progressive_tiles_init(cfg, seed=seed, device="cpu")
    state.sample_lo, state.sample_hi = lo, hi
    ids, next_lo, next_hi = port_prog.progressive_tile_ids(state, cfg, n)
    want_ids, want_lo, want_hi = _reference_tile_ids(seed, lo, hi, n, T)
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    assert (next_lo, next_hi) == (want_lo, want_hi)
    assert 0 <= int(ids.min()) and int(ids.max()) <= T - 1


def test_cursor_indices_carry_into_the_hi_word():
    idx_lo, idx_hi, next_lo, next_hi = port_prog._cursor_indices(
        2**32 - 2, 4, 4, "cpu"
    )
    assert idx_lo.tolist() == [2**32 - 2, 2**32 - 1, 0, 1]
    assert idx_hi.tolist() == [4, 4, 5, 5]
    assert (next_lo, next_hi) == (2, 5)
