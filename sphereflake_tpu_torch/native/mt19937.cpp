// std::mt19937-compatible engine (canonical MT19937 twist/temper),
// matching the reference's noise source (SSAO.cpp:147-148, seed 12512)
// and usable for reference-style per-sample scrambles
// (Sphereflake.cpp:88-90). Kept dependency-free (no <random>) so the
// output is pinned to the algorithm, not a stdlib implementation.
#include "common.h"

namespace {

constexpr int N = 624;
constexpr int M = 397;
constexpr uint32_t kMatrixA = 0x9908b0dfu;
constexpr uint32_t kUpper = 0x80000000u;
constexpr uint32_t kLower = 0x7fffffffu;

struct MT {
  uint32_t mt[N];
  int idx;

  explicit MT(uint32_t seed) {
    mt[0] = seed;
    for (int i = 1; i < N; ++i) {
      mt[i] = 1812433253u * (mt[i - 1] ^ (mt[i - 1] >> 30)) + i;
    }
    idx = N;
  }

  void twist() {
    for (int k = 0; k < N; ++k) {
      uint32_t y = (mt[k] & kUpper) | (mt[(k + 1) % N] & kLower);
      mt[k] = mt[(k + M) % N] ^ (y >> 1) ^ ((y & 1) ? kMatrixA : 0u);
    }
    idx = 0;
  }

  uint32_t next() {
    if (idx >= N) twist();
    uint32_t y = mt[idx++];
    y ^= y >> 11;
    y ^= (y << 7) & 0x9d2c5680u;
    y ^= (y << 15) & 0xefc60000u;
    y ^= y >> 18;
    return y;
  }
};

}  // namespace

extern "C" {

void sf_mt19937_draw(uint32_t* out, uint32_t seed, uint64_t skip,
                     uint64_t count) {
  MT eng(seed);
  for (uint64_t i = 0; i < skip; ++i) eng.next();
  for (uint64_t i = 0; i < count; ++i) out[i] = eng.next();
}

}  // extern "C"
