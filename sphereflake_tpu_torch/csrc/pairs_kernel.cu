// Binned ray tests against the fat-row pair table: one kernel body, three
// launch modes.
//
// Replaces the reference package's TPU kernel body
// `sphereflake_tpu/ops/binned.py:make_pairs_kernel` in all three of its
// launch shapes:
//   - FULL   (wrapper `trace_pairs_fused_soa`): block t renders frame tile t;
//   - SUBSET (wrapper `trace_pairs_fused_subset`): block k renders frame tile
//     tile_ids[k] (the frameless refresh unit); starts / lens stay the
//     full-frame tables and the output row block is k. With SHADE_ONLY the
//     code rows are neither staged nor accumulated and the output is exactly
//     (min_t, pos3, nrm3);
//   - DIRS   (wrapper `trace_pairs_pallas_soa`): block b tests one bundle of
//     1024 arbitrary rays, whose unit directions come in as dirs[b, 0..2, r],
//     against the span pairs[:, starts[b] : starts[b] + lens[b]] (any length:
//     the union of many tiles' segments) and writes the raw winner
//     (t, code_lo[, code_hi], cx, cy, cz) with no shading.
//
// What it computes, per 1024-ray block (FULL / SUBSET: a tile_w x tile_h
// screen tile):
//   - raygen from the 16-float camera pack [tl(3), ex(3), ey(3), origin(3),
//     x_off, y_off, frame_w, frame_h]: u = (px + x_off) / frame_w,
//     v = (py + y_off) / frame_h, d = normalize((tl + (ex*u + ey*v)) - origin);
//   - a walk of the block's segment of the fat-row pair table (rows cx, cy,
//     cz, rc = r^2 - |c|^2, code_lo[, code_hi], lodr = lod^2 * r,
//     rc4 = 4 r^2 - |c|^2), keeping the nearest self-hit that passes the LOD
//     gate;
//   - the G-buffer epilogue: rows (min_t, code_lo[, code_hi], pos3, nrm3) in
//     in-tile order row * tile_w + col, zeros at sky, min_t = BIG at sky.
//
// Bound on this card: operations, not bytes. A 1080p depth-6 frame moves
// about 67 MB of output and 4 MB of pair table (about 21 us at 3.35 TB/s) but
// runs about 1.2e8 ray-sphere tests of about 25 f32 operations each (about
// 3 GFLOP: about 45 us at the 67 TFLOP/s non-tensor f32 peak); a 1,024-tile
// SHADE_ONLY refresh step is half of that on both sides. The work is a
// per-thread loop of data-dependent length with compares and selects, so the
// design keeps the loop free of global memory traffic.
//
// Design: one block per tile or bundle, one thread per ray (1024 threads,
// which caps a thread at 64 registers: one accumulator set, not the eight
// chains of the TPU body). The block reads its own indices (tile id, start,
// length), stages the segment through shared memory in CHUNK-pair pieces with
// coalesced loads, and every thread then reads each pair by shared-memory
// broadcast. Outputs are written once, coalesced (neighbouring rays,
// neighbouring addresses). The TPU wrappers' padding (tile lists and bundles
// to a multiple of 8, an 8th zero row, -BIG pad columns) has no counterpart.
//
// Tie rule. The TPU body sends candidate k of the segment to accumulator chain
// k mod 8 (a later candidate wins a chain only on strict <) and merges chains
// 0..7 on strict <, so among candidates with the same minimal t the winner is
// the one with the smallest (k mod 8, k), k counted from the segment start.
// The single accumulator here applies that order directly: replace when
// ts < bt, or ts == bt and (k & 7) < (bk & 7). With SHADE_ONLY the tie still
// decides the winner's centre, hence the normal.
//
// Build without FMA contraction (-fmad=false) and without fast math: the plain
// torch version of this function runs unfused f32 multiplies and adds, and a
// contracted tca / disc moves tangent grazes (disc ~ 0) between hit and miss.

#include <cuda_runtime.h>

namespace {

constexpr int kRays = 1024;   // rays (threads) per tile or bundle
constexpr int kChunk = 256;   // pairs staged through shared memory at a time
constexpr float kBig = 3.0e38f;

enum Mode { kFull = 0, kSubset = 1, kDirs = 2 };

// `index`: tile_ids (kSubset) or dirs (kDirs), unused for kFull.
template <int MODE, bool DEEP, bool SHADE_ONLY>
__global__ void __launch_bounds__(kRays)
trace_pairs_kernel(const float* __restrict__ cam,
                   const float* __restrict__ pairs,
                   const int* __restrict__ starts,
                   const int* __restrict__ lens,
                   const void* __restrict__ index,
                   float* __restrict__ out,
                   int* __restrict__ metrics,
                   int pair_stride, int tile_w_log2, int tile_h,
                   int tiles_x) {
  static_assert(!(SHADE_ONLY && MODE != kSubset), "shade_only is a subset mode");
  constexpr int ROWS = DEEP ? 8 : 7;
  constexpr int NCODE = SHADE_ONLY ? 0 : (DEEP ? 2 : 1);
  constexpr int NOUT = (MODE == kDirs ? 4 : 7) + NCODE;
  constexpr int R_LODR = DEEP ? 6 : 5;
  constexpr int R_RC4 = DEEP ? 7 : 6;

  __shared__ float seg[ROWS][kChunk];
  __shared__ float scam[16];

  const int blk = blockIdx.x;
  const int flat = threadIdx.x;
  // The frame tile (kFull, kSubset) or bundle (kDirs) whose segment is walked.
  const int t = MODE == kSubset ? static_cast<const int*>(index)[blk] : blk;
  if (MODE != kDirs && flat < 16) scam[flat] = cam[flat];
  const int start = starts[t];
  const int len = lens[t];
  __syncthreads();

  float dx, dy, dz;
  if constexpr (MODE == kDirs) {
    const float* d = static_cast<const float*>(index) + (size_t)blk * 3 * kRays;
    dx = d[flat];
    dy = d[kRays + flat];
    dz = d[2 * kRays + flat];
  } else {
    // Raygen: this tile's pixel block, corner interpolation. The association
    // order is the reference's: (tl + (ex*u + ey*v)) - origin.
    const int tile_w = 1 << tile_w_log2;
    const int txs = t % tiles_x;
    const int tys = t / tiles_x;
    const int col = flat & (tile_w - 1);
    const int row = flat >> tile_w_log2;
    const float fpx = (float)(txs * tile_w + col);
    const float fpy = (float)(tys * tile_h + row);
    const float u = (fpx + scam[12]) / scam[14];
    const float v = (fpy + scam[13]) / scam[15];
    dx = (scam[0] + (scam[3] * u + scam[6] * v)) - scam[9];
    dy = (scam[1] + (scam[4] * u + scam[7] * v)) - scam[10];
    dz = (scam[2] + (scam[5] * u + scam[8] * v)) - scam[11];
    const float dnorm = sqrtf(dx * dx + dy * dy + dz * dz);
    dx = dx / dnorm;
    dy = dy / dnorm;
    dz = dz / dnorm;
  }

  float bt = kBig;
  float blo = 0.0f, bhi = 0.0f;
  float bcx = 0.0f, bcy = 0.0f, bcz = 0.0f;
  int bk = 0;

  for (int base = 0; base < len; base += kChunk) {
    const int cnt = min(kChunk, len - base);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = flat; i < ROWS * kChunk; i += kRays) {
      const int r = i / kChunk;
      const int c = i - r * kChunk;
      // SHADE_ONLY never reads the code rows (4, and 5 when DEEP).
      const bool code_row = r == 4 || (DEEP && r == 5);
      if (c < cnt && !(SHADE_ONLY && code_row)) {
        seg[r][c] = pairs[(size_t)r * pair_stride + (start + base + c)];
      }
    }
    __syncthreads();

    for (int j = 0; j < cnt; ++j) {
      const float cx = seg[0][j];
      const float cy = seg[1][j];
      const float cz = seg[2][j];
      const float rc = seg[3][j];
      const float lodr = seg[R_LODR][j];
      const float rc4 = seg[R_RC4][j];
      const float tca = dx * cx + dy * cy + dz * cz;
      const float t2 = tca * tca;
      const float disc = t2 + rc;  // r^2 - d^2
      const float c1p = fmaxf(tca - lodr, 0.0f);
      const bool ok = (tca >= 0.0f) && (c1p * c1p < t2 + rc4) && (disc >= 0.0f);
      const float ts = tca - sqrtf(fmaxf(disc, 0.0f));
      const int k = base + j;
      const bool better =
          ok && ((ts < bt) || (ts == bt && (k & 7) < (bk & 7)));
      if (better) {
        bt = ts;
        bk = k;
        if constexpr (!SHADE_ONLY) blo = seg[4][j];
        if constexpr (!SHADE_ONLY && DEEP) bhi = seg[5][j];
        bcx = cx;
        bcy = cy;
        bcz = cz;
      }
    }
  }

  float* o = out + (size_t)blk * NOUT * kRays + flat;
  int c = 0;
  if constexpr (MODE == kDirs) {
    // The raw winner as accumulated: t stays BIG, codes and centre 0, where
    // no candidate passed.
    o[(c++) * kRays] = bt;
    o[(c++) * kRays] = blo;
    if constexpr (DEEP) o[(c++) * kRays] = bhi;
    o[(c++) * kRays] = bcx;
    o[(c++) * kRays] = bcy;
    o[(c++) * kRays] = bcz;
  } else {
    // Epilogue: G-buffer shading of the winner. position = dir * t
    // (camera-relative), normal = normalize(position - center), zeros at sky.
    // Without codes a hit is "some candidate beat the BIG init": every
    // accepted ts is a real distance, orders of magnitude below BIG.
    bool hit;
    if constexpr (SHADE_ONLY) {
      hit = bt < 0.5f * kBig;
    } else {
      hit = blo >= 1.0f;
      if constexpr (DEEP) hit = hit || (bhi >= 1.0f);
    }
    const float t0 = hit ? bt : 0.0f;
    const float px = dx * t0, py = dy * t0, pz = dz * t0;
    const float wx = px - bcx, wy = py - bcy, wz = pz - bcz;
    float nn = sqrtf(fmaxf(wx * wx + wy * wy + wz * wz, 0.0f));
    nn = nn > 0.0f ? nn : 1.0f;
    const float hf = hit ? 1.0f : 0.0f;

    o[(c++) * kRays] = SHADE_ONLY ? bt : (hit ? bt : kBig);
    if constexpr (!SHADE_ONLY) {
      o[(c++) * kRays] = blo;
      if constexpr (DEEP) o[(c++) * kRays] = bhi;
    }
    o[(c++) * kRays] = px;
    o[(c++) * kRays] = py;
    o[(c++) * kRays] = pz;
    o[(c++) * kRays] = hf * (wx / nn);
    o[(c++) * kRays] = hf * (wy / nn);
    o[(c++) * kRays] = hf * (wz / nn);
  }

  if (flat < 4) metrics[blk * 4 + flat] = (flat == 0) ? len : 0;
}

template <int MODE, bool DEEP, bool SHADE_ONLY>
int launch(const float* cam, const float* pairs, const int* starts,
           const int* lens, const void* index, float* out, int* metrics,
           int n_blocks, int pair_stride, int tile_w_log2, int tile_h,
           int tiles_x, void* stream) {
  if (n_blocks <= 0) return 0;
  trace_pairs_kernel<MODE, DEEP, SHADE_ONLY>
      <<<n_blocks, kRays, 0, static_cast<cudaStream_t>(stream)>>>(
          cam, pairs, starts, lens, index, out, metrics, pair_stride,
          tile_w_log2, tile_h, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

using LaunchFn = int (*)(const float*, const float*, const int*, const int*,
                        const void*, float*, int*, int, int, int, int, int,
                        void*);

}  // namespace

// Plain C entry points: each enqueues one launch on `stream` and returns
// cudaGetLastError() (0 on success). None synchronises or allocates; every
// pointer is device memory owned by the caller.

// Full tile grid: out [n_tiles, 8|9, 1024].
extern "C" int sf_trace_pairs_fused(const float* cam, const float* pairs,
                                    const int* starts, const int* lens,
                                    float* out, int* metrics, int n_tiles,
                                    int pair_stride, int tile_w_log2,
                                    int tile_h, int tiles_x, int deep,
                                    void* stream) {
  LaunchFn fn =
      deep ? &launch<kFull, true, false> : &launch<kFull, false, false>;
  return fn(cam, pairs, starts, lens, nullptr, out, metrics, n_tiles,
            pair_stride, tile_w_log2, tile_h, tiles_x, stream);
}

// Tile subset: block k renders frame tile tile_ids[k]; out
// [n_ids, 7 (shade_only) | 8 | 9, 1024]. Every id must lie in [0, n_tiles)
// of the starts / lens tables (the caller's contract).
extern "C" int sf_trace_pairs_fused_subset(
    const float* cam, const float* pairs, const int* starts, const int* lens,
    const int* tile_ids, float* out, int* metrics, int n_ids, int pair_stride,
    int tile_w_log2, int tile_h, int tiles_x, int deep, int shade_only,
    void* stream) {
  LaunchFn fn = shade_only
                     ? (deep ? &launch<kSubset, true, true>
                             : &launch<kSubset, false, true>)
                     : (deep ? &launch<kSubset, true, false>
                             : &launch<kSubset, false, false>);
  return fn(cam, pairs, starts, lens, tile_ids, out, metrics, n_ids,
            pair_stride, tile_w_log2, tile_h, tiles_x, stream);
}

// Ray bundles: dirs [n_bundles, 3, 1024], starts / lens [n_bundles] spans;
// out [n_bundles, 5|6, 1024].
extern "C" int sf_trace_pairs_dirs(const float* dirs, const float* pairs,
                                   const int* starts, const int* lens,
                                   float* out, int* metrics, int n_bundles,
                                   int pair_stride, int deep, void* stream) {
  LaunchFn fn =
      deep ? &launch<kDirs, true, false> : &launch<kDirs, false, false>;
  return fn(nullptr, pairs, starts, lens, dirs, out, metrics, n_bundles,
            pair_stride, 0, 0, 1, stream);
}
