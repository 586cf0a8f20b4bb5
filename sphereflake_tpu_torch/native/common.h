// Shared declarations of the port's native host library.
//
// The port's own copy of the reference package's `native/` library
// (the sources are the same): the Sobol sampler (the C++ app's
// Sobol.cpp — Gruenschloss' scalar sampler over the Joe-Kuo table), the
// mt19937 noise source (SSAO.cpp:144-163), and the display path (GL
// window -> a PNG encoder, the renderer being headless). Built with the
// host C++ compiler at first use and loaded with ctypes by
// sphereflake_tpu_torch/runtime/native.py.
#ifndef SPHEREFLAKE_NATIVE_COMMON_H
#define SPHEREFLAKE_NATIVE_COMMON_H

#include <cstddef>
#include <cstdint>

extern "C" {

// ---- sobol.cpp ----
// Build direction numbers for `dims` dimensions x 52 bits into `out`
// (row-major uint32[dims][52]). Returns 0 on success, -1 if dims exceeds
// the built-in Joe-Kuo parameter table.
int sf_sobol_direction_numbers(uint32_t* out, int dims);

// Evaluate `count` scrambled Sobol samples for one dimension:
// out[i] = sobol(index_base + i, dim) ^ scramble[i], as float in [0,1).
// scramble may be null (no scrambling).
int sf_sobol_sample_batch(double* out, uint64_t index_base, uint64_t count,
                          int dim, const uint32_t* scramble);

// ---- mt19937.cpp ----
// std::mt19937-compatible engine; draws `count` tempered uint32 values
// for `seed` after discarding `skip` outputs.
void sf_mt19937_draw(uint32_t* out, uint32_t seed, uint64_t skip,
                     uint64_t count);

// ---- png.cpp ----
// Encode RGB8 (h x w x 3, row-major) into a PNG byte stream.
// Returns the number of bytes written, or -1 if `out_cap` is too small.
// Call with out == null to query the worst-case size.
int64_t sf_png_encode_rgb8(uint8_t* out, int64_t out_cap,
                           const uint8_t* rgb, int width, int height);

}  // extern "C"

#endif  // SPHEREFLAKE_NATIVE_COMMON_H
