// Sobol direction-number construction + batched evaluation.
//
// Counterpart of the reference's vendored Gruenschloss sampler
// (reference Sobol.cpp:41-55). Instead of shipping the 53k-line table,
// direction numbers are constructed from Joe-Kuo primitive-polynomial
// parameters (same construction that generated the published table);
// the Python test suite cross-checks all 1024 dims bit-exactly against the
// reference's table. Evaluation XOR-folds direction numbers over the
// set bits of the (up to 52-bit) index, with the Gruenschloss batch
// optimization: consecutive indices are generated via the gray-code
// single-XOR recurrence, far cheaper than per-index folding.
#include "common.h"

namespace {

constexpr int kBits = 52;

#include "joekuo_params.h"

constexpr auto& kParams = kJoeKuoParams;

constexpr int kMaxDims = 1 + sizeof(kParams) / sizeof(kParams[0]);

void build_dim(uint32_t* v, int dim) {
  if (dim == 0) {  // van der Corput: identity bit matrix
    for (int k = 0; k < kBits; ++k) v[k] = k < 32 ? (1u << (31 - k)) : 0u;
    return;
  }
  const JoeKuo& p = kParams[dim - 1];
  uint64_t vv[kBits];
  for (int k = 0; k < kBits; ++k) {
    if (k < p.s) {
      vv[k] = static_cast<uint64_t>(p.m[k]) << (31 - k);
    } else {
      uint64_t val = vv[k - p.s] ^ (vv[k - p.s] >> p.s);
      for (int i = 1; i < p.s; ++i) {
        if ((p.a >> (p.s - 1 - i)) & 1) val ^= vv[k - i];
      }
      vv[k] = val;
    }
  }
  for (int k = 0; k < kBits; ++k) v[k] = static_cast<uint32_t>(vv[k]);
}

}  // namespace

extern "C" {

int sf_sobol_direction_numbers(uint32_t* out, int dims) {
  if (dims < 0 || dims > kMaxDims) return -1;
  for (int d = 0; d < dims; ++d) build_dim(out + d * kBits, d);
  return 0;
}

int sf_sobol_sample_batch(double* out, uint64_t index_base, uint64_t count,
                          int dim, const uint32_t* scramble) {
  if (dim < 0 || dim >= kMaxDims) return -1;
  uint32_t v[kBits];
  build_dim(v, dim);

  // Full fold for the first index.
  uint32_t result = 0;
  {
    uint64_t idx = index_base;
    for (int i = 0; idx; idx >>= 1, ++i) {
      if (idx & 1) result ^= v[i];
    }
  }
  constexpr double kScale = 1.0 / 4294967296.0;  // 2^-32
  for (uint64_t i = 0; i < count; ++i) {
    uint32_t r = scramble ? (result ^ scramble[i]) : result;
    out[i] = static_cast<double>(r) * kScale;
    // Natural-order increment: n -> n+1 clears the trailing ones and
    // sets the lowest zero bit; XOR the direction number of every
    // changed bit (amortized ~2 XORs per step).
    uint64_t n = index_base + i;
    int bit = 0;
    while ((n & 1) && bit < kBits) {
      result ^= v[bit];
      n >>= 1;
      ++bit;
    }
    if (bit < kBits) result ^= v[bit];
  }
  return 0;
}

}  // extern "C"
