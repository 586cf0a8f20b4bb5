// Binned ray tests against the fat-row pair table: three launch modes of one
// function, in one decomposition (bounded work items, `item_walk.cuh`).
//
// Replaces the reference package's TPU kernel body
// `sphereflake_tpu/ops/binned.py:make_pairs_kernel` in all three of its
// launch shapes:
//   - FULL   (wrapper `trace_pairs_fused_soa`): row t is frame tile t;
//   - SUBSET (wrapper `trace_pairs_fused_subset`): row k is frame tile
//     tile_ids[k] (the frameless refresh unit); starts / lens stay the
//     full-frame tables. With SHADE_ONLY the output is exactly (min_t, pos3,
//     nrm3) and the code rows of the table are never read;
//   - DIRS   (wrapper `trace_pairs_pallas_soa`): row b is one bundle of 1024
//     arbitrary rays, whose unit directions come in as dirs[b, 0..2, r],
//     against the span pairs[:, starts[b] : starts[b] + lens[b]] (any length:
//     the union of many tiles' segments); the output is the raw winner
//     (t, code_lo[, code_hi], cx, cy, cz) with no shading.
//
// What it computes, per row of 1024 rays (FULL / SUBSET: a tile_w x tile_h
// screen tile):
//   - raygen from the 16-float camera pack [tl(3), ex(3), ey(3), origin(3),
//     x_off, y_off, frame_w, frame_h]: u = (px + x_off) / frame_w,
//     v = (py + y_off) / frame_h, d = normalize((tl + (ex*u + ey*v)) - origin);
//   - a walk of the row's span of the fat-row pair table (rows cx, cy, cz,
//     rc = r^2 - |c|^2, code_lo[, code_hi], lodr = lod^2 * r,
//     rc4 = 4 r^2 - |c|^2), keeping the nearest self-hit that passes the LOD
//     gate;
//   - the G-buffer epilogue: rows (min_t, code_lo[, code_hi], pos3, nrm3) in
//     in-tile order row * tile_w + col, zeros at sky, min_t = BIG at sky.
//
// The function is a minimum over a total order. Candidate k of a span
// (counted from the span's start) passes `ok` or not; among those that pass,
// the winner is the one with the smallest (ts, k mod 8, k). (The TPU body
// sends candidate k to accumulator chain k mod 8, a later candidate wins a
// chain only on strict <, and chains 0..7 merge on strict <: the same order.)
// A minimum over a total order can be taken in any grouping and any order,
// and the decomposition below rests on that.
//
// Bound on this card: operations, not bytes. A 1080p depth-6 frame moves
// about 67 MB of output and 4 MB of pair table (about 21 us at 3.35 TB/s) but
// runs about 1.2e8 ray-sphere tests of about 25 f32 operations each (about
// 3 GFLOP: about 45 us at the 67 TFLOP/s non-tensor f32 peak, which counts a
// fused multiply-add as two; this build fuses none). A 1,024-tile SHADE_ONLY
// refresh step is a third of that; a 65,536-sample DIRS step writes 1.3 MB
// and tests 1.2e8 times. The work is a loop of data-dependent length with
// compares and selects, so the loop is kept free of global memory traffic.
// Tensor cores are not used: tca is a product of depth 3 whose f32 rounding
// decides hit or miss at grazes (disc ~ 0), and TF32 would change the
// function.
//
// Design, the same for the three modes. One block per row would make a
// launch last as long as its longest span on one SM (a frame's longest tile
// segment is 590 pairs against a mean of 59; a sample step's 64 bundles have
// spans up to 6,320 pairs and occupy 64 of 132 SMs), and a 1,024-thread block
// holds one ray a thread behind a chain of three dependent index loads. So
// the spans are cut into items of kItemLen = 64 pairs, drawn by a fixed grid
// of small blocks (`item_walk.cuh`), and:
//   - a thread's four rays share one 16-byte shared-memory broadcast of
//     (cx, cy, cz, rc) and, past the early out, one 8-byte broadcast of
//     (lodr, rc4); independent chains hide the square root's latency, and
//     eight small blocks an SM overlap each other's index loads and barriers;
//   - the walk carries one key per ray, (ts, k): codes and centres are read
//     from the table once per ray, by the finish, at pairs[:, start + k]. The
//     loop is the same for SHADE_ONLY, coded, shallow and deep, which differ
//     only in the rows that hold lodr and rc4;
//   - warp-uniform early out: tca and disc come first; the LOD gate, the
//     square root and the key update run only where __any_sync says that
//     some lane's disc >= 0 (13 % of a tile step's (warp, pair) tests, 5 %
//     of a sample step's). Lanes that pass do the same arithmetic as before;
//   - the merge key's low word is k mod 8 in bits 31..29 and k in bits 28..0
//     (the wrappers keep k below 2^29 - 1). The finish recomputes ts from the
//     winner's own column, so the output carries the winner's own sign of a
//     zero;
//   - an item is one staged piece, so there is no ring of asynchronous
//     copies: the other blocks of the SM cover an item's loads.
// On an NVIDIA H100 80GB HBM3 at 700 W (`chip_smoke.py`, `times` and
// `frameless_times`) the 2,040-tile FULL frame takes about 0.12 ms (one block
// per tile: 0.30), the 1,024-tile SHADE_ONLY step about 0.06 ms (0.17) and
// the 65,536-sample DIRS step about 0.08 ms (1.27): 0.38, 0.26 and 0.58 of
// bounds that count a fused multiply-add as two. Most of the time
// is the early-out path: 36 instructions for four tests, 28 of them
// the multiplies and adds of tca and disc, which fused would be 16. The
// constants are the fastest of the item sizes, block sizes, blocks an SM,
// rays a thread and warp footprints timed there (PERF.md, Findings).
//
// Build without FMA contraction (-fmad=false) and without fast math: the plain
// torch version of this function runs unfused f32 multiplies and adds, and a
// contracted tca / disc moves tangent grazes (disc ~ 0) between hit and miss.

#include <cuda_runtime.h>

#include "item_walk.cuh"

namespace {

using namespace item_walk;

enum Mode { kFull = 0, kSubset = 1, kDirs = 2 };

constexpr float kBig = 3.0e38f;
constexpr int kWalkUnroll = 4;  // pairs per trip of the walk
// Low word of a key: k mod 8 in bits 31..29, k in bits 28..0. All ones is
// "no candidate", so k stays below 2^29 - 1 (the wrappers check pair_cap).
constexpr int kKeyKBits = 29;
constexpr unsigned kKeyKMask = (1u << kKeyKBits) - 1u;

__device__ __forceinline__ unsigned key_low(int k) {
  return ((unsigned)(k & 7) << kKeyKBits) | (unsigned)k;
}

// Launch 1 of 2. Block 0: the prefix sum of items over the rows
// (`scan_items`). Blocks 1..: one warp per row writes the row's metrics and,
// for a row of several items, clears its merge keys and its arrival count.
template <bool SUBSET>
__global__ void __launch_bounds__(kPrologueThreads)
item_prologue_kernel(const int* __restrict__ starts,
                     const int* __restrict__ lens,
                     const int* __restrict__ tile_ids, int n_rows,
                     int4* __restrict__ rowinfo, int* __restrict__ arrived,
                     int* __restrict__ counter,
                     unsigned long long* __restrict__ keys,
                     int* __restrict__ metrics, int walk_blocks) {
  auto span = [&](int r) {
    const int t = SUBSET ? tile_ids[r] : r;
    return make_int4(0, starts[t], lens[t], t);
  };
  if (blockIdx.x == 0) {
    scan_items(span, n_rows, rowinfo, counter, walk_blocks);
    return;
  }
  const int lane = threadIdx.x & 31;
  const int r = (blockIdx.x - 1) * (kPrologueThreads / 32) + (threadIdx.x >> 5);
  if (r >= n_rows) return;
  const int len = span(r).z;
  if (lane < 4) metrics[r * 4 + lane] = (lane == 0) ? len : 0;
  clear_row(r, len, keys, arrived, lane);
}

// Launch 2 of 2: a fixed grid of blocks that walk items until none is left.
// `index`: the dirs (kDirs); unused for kFull / kSubset, whose tile ids are in
// rowinfo.
template <int MODE, bool DEEP, bool SHADE_ONLY>
__global__ void __launch_bounds__(kItemThreads, kBlocksPerSm)
walk_items_kernel(const float* __restrict__ cam,
                  const float* __restrict__ pairs,
                  const float* __restrict__ index,
                  const int4* __restrict__ rowinfo, int* __restrict__ arrived,
                  int* __restrict__ counter,
                  unsigned long long* __restrict__ keys,
                  float* __restrict__ out, int n_rows, int pair_stride,
                  int tile_w_log2, int tile_h, int tiles_x) {
  static_assert(!(SHADE_ONLY && MODE != kSubset), "shade_only is a subset mode");
  constexpr int NCODE = SHADE_ONLY ? 0 : (DEEP ? 2 : 1);
  constexpr int NOUT = (MODE == kDirs ? 4 : 7) + NCODE;
  constexpr int R_LODR = DEEP ? 6 : 5;
  constexpr int R_RC4 = DEEP ? 7 : 6;
  constexpr int RPT = kRaysPerThread;

  // The staged item, 32 bytes a pair: (cx, cy, cz, rc), (lodr, rc4, -, -).
  __shared__ float4 s_pair[kItemLen][2];
  __shared__ float scam[16];
  __shared__ int4 s_info;
  __shared__ int s_row, s_next, s_last;

  const int tid = threadIdx.x;
  if (MODE != kDirs && tid < 16) scam[tid] = cam[tid];
  const int total = rowinfo[n_rows].x;
  const int part_f0 = part_first_ray(tid);

  int work = blockIdx.x;
  while (work < total * kRowParts) {
    const int item = work / kRowParts;
    const int part = work % kRowParts;
    if (tid < 32) find_row(rowinfo, n_rows, item, tid, &s_info, &s_row);
    __syncthreads();
    const int4 info = s_info;
    const int row = s_row;
    const int f0 = part * (kItemThreads * RPT) + part_f0;
    const int start = info.y;
    const int len = info.z;
    const int base = (item - info.x) * kItemLen;
    const int cnt = max(0, min(kItemLen, len - base));

    // Stage the item: six rows of the table, interleaved per pair.
    for (int i = tid; i < 6 * kItemLen; i += kItemThreads) {
      const int r = i / kItemLen;
      const int c = i % kItemLen;
      if (c < cnt) {
        const int src = r < 4 ? r : (r == 4 ? R_LODR : R_RC4);
        const float v = pairs[(size_t)src * pair_stride + (start + base + c)];
        reinterpret_cast<float*>(&s_pair[c][0])[r] = v;
      }
    }

    float dx[RPT], dy[RPT], dz[RPT];
    if constexpr (MODE == kDirs) {
      const float* d = index + (size_t)row * 3 * kRays + f0;
      const float4 x = *reinterpret_cast<const float4*>(d);
      const float4 y = *reinterpret_cast<const float4*>(d + kRays);
      const float4 z = *reinterpret_cast<const float4*>(d + 2 * kRays);
      dx[0] = x.x; dx[1] = x.y; dx[2] = x.z; dx[3] = x.w;
      dy[0] = y.x; dy[1] = y.y; dy[2] = y.z; dy[3] = y.w;
      dz[0] = z.x; dz[1] = z.y; dz[2] = z.z; dz[3] = z.w;
    } else {
      // Raygen: this tile's pixel block, corner interpolation. The
      // association order is the reference's: (tl + (ex*u + ey*v)) - origin.
      const int t = info.w;
      const int tile_w = 1 << tile_w_log2;
      const int txs = t % tiles_x;
      const int tys = t / tiles_x;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int f = f0 + i;
        const int col = f & (tile_w - 1);
        const int prow = f >> tile_w_log2;
        const float fpx = (float)(txs * tile_w + col);
        const float fpy = (float)(tys * tile_h + prow);
        const float u = (fpx + scam[12]) / scam[14];
        const float v = (fpy + scam[13]) / scam[15];
        const float ax = (scam[0] + (scam[3] * u + scam[6] * v)) - scam[9];
        const float ay = (scam[1] + (scam[4] * u + scam[7] * v)) - scam[10];
        const float az = (scam[2] + (scam[5] * u + scam[8] * v)) - scam[11];
        const float dnorm = sqrtf(ax * ax + ay * ay + az * az);
        dx[i] = ax / dnorm;
        dy[i] = ay / dnorm;
        dz[i] = az / dnorm;
      }
    }
    __syncthreads();  // the item is staged

    // The walk: per ray the best (ts, low word of the key) so far.
    float bt[RPT];
    unsigned bl[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      bt[i] = kBig;
      bl[i] = kNoCandidate;
    }
    // One pointer walks the staged pairs: a loop-carried address cannot be
    // recomputed from the block's shared-memory window on every trip.
    const float4* pair = &s_pair[0][0];
#pragma unroll(kWalkUnroll)
    for (int j = 0; j < cnt; ++j, pair += 2) {
      const float4 g = pair[0];
      float tca[RPT], t2[RPT], disc[RPT];
      // The warp goes on where some ray's line meets the sphere: the largest
      // disc is >= 0 (-0.0 passes, as it does below). Spheres behind the
      // origin pass too; `ok` decides.
      float reach = -1.0f;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        tca[i] = dx[i] * g.x + dy[i] * g.y + dz[i] * g.z;
        t2[i] = tca[i] * tca[i];
        disc[i] = t2[i] + g.w;  // r^2 - d^2
        reach = fmaxf(reach, disc[i]);
      }
      if (__any_sync(kFullMask, reach >= 0.0f)) {
        const float2 l = *reinterpret_cast<const float2*>(pair + 1);
        const unsigned low = key_low(base + j);
        // Written without short-circuit operators: selects, not branches
        // that the lanes of a warp would take apart.
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float c1p = fmaxf(tca[i] - l.x, 0.0f);
          const bool ok = (tca[i] >= 0.0f) & (c1p * c1p < t2[i] + l.y) &
                          (disc[i] >= 0.0f);
          const float ts = tca[i] - sqrtf(fmaxf(disc[i], 0.0f));
          const bool better =
              ok & ((ts < bt[i]) | ((ts == bt[i]) & (low < bl[i])));
          bt[i] = better ? ts : bt[i];
          bl[i] = better ? low : bl[i];
        }
      }
    }

    // Merge: a row of one item keeps its winners in registers; a longer row
    // takes the minimum of its items' keys in device memory, and the last
    // item to arrive reads the result back.
    const int n_items = items_of(len);
    const bool finish =
        n_items == 1 ||
        merge_keys(keys + (size_t)row * kRays + f0, bt, bl,
                   arrived + row * kRowParts + part, n_items, &s_last);

    if (finish) {
      // The finish: the winner's column of the table, once per ray. ts is
      // recomputed from it by the walk's own expression (the same bits).
      float o[NOUT][RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        float wt = kBig, lo = 0.0f, hi = 0.0f;
        float cx = 0.0f, cy = 0.0f, cz = 0.0f;
        if (bl[i] != kNoCandidate) {
          const float* p = pairs + (start + (int)(bl[i] & kKeyKMask));
          cx = p[0];
          cy = p[(size_t)pair_stride];
          cz = p[(size_t)2 * pair_stride];
          const float rc = p[(size_t)3 * pair_stride];
          if constexpr (!SHADE_ONLY) lo = p[(size_t)4 * pair_stride];
          if constexpr (!SHADE_ONLY && DEEP) hi = p[(size_t)5 * pair_stride];
          const float tca = dx[i] * cx + dy[i] * cy + dz[i] * cz;
          const float t2 = tca * tca;
          const float disc = t2 + rc;
          wt = tca - sqrtf(fmaxf(disc, 0.0f));
        }
        int c = 0;
        if constexpr (MODE == kDirs) {
          // The raw winner: t stays BIG, codes and centre 0, where no
          // candidate passed.
          o[c++][i] = wt;
          o[c++][i] = lo;
          if constexpr (DEEP) o[c++][i] = hi;
          o[c++][i] = cx;
          o[c++][i] = cy;
          o[c++][i] = cz;
        } else {
          // G-buffer shading of the winner. position = dir * t
          // (camera-relative), normal = normalize(position - center), zeros
          // at sky. Without codes a hit is "some candidate beat the BIG
          // init": every accepted ts is a real distance, orders of magnitude
          // below BIG.
          bool hit;
          if constexpr (SHADE_ONLY) {
            hit = wt < 0.5f * kBig;
          } else {
            hit = lo >= 1.0f;
            if constexpr (DEEP) hit = hit || (hi >= 1.0f);
          }
          const float t0 = hit ? wt : 0.0f;
          const float px = dx[i] * t0, py = dy[i] * t0, pz = dz[i] * t0;
          const float wx = px - cx, wy = py - cy, wz = pz - cz;
          float nn = sqrtf(fmaxf(wx * wx + wy * wy + wz * wz, 0.0f));
          nn = nn > 0.0f ? nn : 1.0f;
          const float hf = hit ? 1.0f : 0.0f;
          o[c++][i] = SHADE_ONLY ? wt : (hit ? wt : kBig);
          if constexpr (!SHADE_ONLY) {
            o[c++][i] = lo;
            if constexpr (DEEP) o[c++][i] = hi;
          }
          o[c++][i] = px;
          o[c++][i] = py;
          o[c++][i] = pz;
          o[c++][i] = hf * (wx / nn);
          o[c++][i] = hf * (wy / nn);
          o[c++][i] = hf * (wz / nn);
        }
      }
      float* op = out + (size_t)row * NOUT * kRays + f0;
#pragma unroll
      for (int c = 0; c < NOUT; ++c) {
        *reinterpret_cast<float4*>(op + c * kRays) =
            make_float4(o[c][0], o[c][1], o[c][2], o[c][3]);
      }
    }

    // Next item, drawn only now: a block that held its next item while it
    // walked this one would take the items out of the draw in its first
    // microsecond, and the launch would be as unbalanced as a static split
    // (tried on an H100, items of 128 pairs: 0.121 ms against 0.092 on the
    // 1,024-tile step). The barriers keep the staged item and s_info alive
    // until every thread is done with them, and s_next until every thread
    // has read it.
    if (tid == 0) s_next = atomicAdd(counter, 1);
    __syncthreads();
    work = s_next;
    __syncthreads();
  }
}

// The scratch of one item launch, carved from `work` (int32, at least
// 8 * n_rows + 8 values, 16-byte aligned): rowinfo [n_rows + 1] int4,
// arrived [kRowParts * n_rows], counter [1].
template <int MODE, bool DEEP, bool SHADE_ONLY>
int launch_items(const float* cam, const float* pairs, const int* starts,
                 const int* lens, const int* tile_ids, const float* dirs,
                 float* out, int* metrics, unsigned long long* keys,
                 int* work, int n_rows, int pair_stride, int tile_w_log2,
                 int tile_h, int tiles_x, void* stream) {
  if (n_rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int4* rowinfo = reinterpret_cast<int4*>(work);
  int* arrived = work + 4 * (n_rows + 1);
  int* counter = arrived + kRowParts * n_rows;
  int grid = 0;
  const cudaError_t asked = walk_grid(&grid);
  if (asked != cudaSuccess) return static_cast<int>(asked);
  const int rows_per_block = kPrologueThreads / 32;
  const int fill_blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  item_prologue_kernel<MODE == kSubset>
      <<<1 + fill_blocks, kPrologueThreads, 0, s>>>(
          starts, lens, tile_ids, n_rows, rowinfo, arrived, counter, keys,
          metrics, grid);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  walk_items_kernel<MODE, DEEP, SHADE_ONLY><<<grid, kItemThreads, 0, s>>>(
      cam, pairs, dirs, rowinfo, arrived, counter, keys, out, n_rows,
      pair_stride, tile_w_log2, tile_h, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

using ItemLaunchFn = int (*)(const float*, const float*, const int*,
                             const int*, const int*, const float*, float*,
                             int*, unsigned long long*, int*, int, int, int,
                             int, int, void*);

}  // namespace

// Plain C entry points: each enqueues its launches on `stream` and returns
// cudaGetLastError() (0 on success). None synchronises or allocates; every
// pointer is device memory owned by the caller. Scratch: keys [n_rows, 1024]
// 64-bit, work [8 * n_rows + 8] int32; neither needs a value.

// Full tile grid: row t renders frame tile t; out [n_tiles, 8|9, 1024].
extern "C" int sf_trace_pairs_fused(const float* cam, const float* pairs,
                                    const int* starts, const int* lens,
                                    float* out, int* metrics,
                                    unsigned long long* keys, int* work,
                                    int n_tiles, int pair_stride,
                                    int tile_w_log2, int tile_h, int tiles_x,
                                    int deep, void* stream) {
  ItemLaunchFn fn = deep ? &launch_items<kFull, true, false>
                         : &launch_items<kFull, false, false>;
  return fn(cam, pairs, starts, lens, nullptr, nullptr, out, metrics, keys,
            work, n_tiles, pair_stride, tile_w_log2, tile_h, tiles_x, stream);
}

// Tile subset: row k renders frame tile tile_ids[k]; out
// [n_ids, 7 (shade_only) | 8 | 9, 1024]. Every id must lie in [0, n_tiles)
// of the starts / lens tables (the caller's contract).
extern "C" int sf_trace_pairs_fused_subset(
    const float* cam, const float* pairs, const int* starts, const int* lens,
    const int* tile_ids, float* out, int* metrics, unsigned long long* keys,
    int* work, int n_ids, int pair_stride, int tile_w_log2, int tile_h,
    int tiles_x, int deep, int shade_only, void* stream) {
  ItemLaunchFn fn = shade_only
                        ? (deep ? &launch_items<kSubset, true, true>
                                : &launch_items<kSubset, false, true>)
                        : (deep ? &launch_items<kSubset, true, false>
                                : &launch_items<kSubset, false, false>);
  return fn(cam, pairs, starts, lens, tile_ids, nullptr, out, metrics, keys,
            work, n_ids, pair_stride, tile_w_log2, tile_h, tiles_x, stream);
}

// Ray bundles: dirs [n_bundles, 3, 1024] (16-byte aligned), starts / lens
// [n_bundles] spans; out [n_bundles, 5|6, 1024].
extern "C" int sf_trace_pairs_dirs(const float* dirs, const float* pairs,
                                   const int* starts, const int* lens,
                                   float* out, int* metrics,
                                   unsigned long long* keys, int* work,
                                   int n_bundles, int pair_stride, int deep,
                                   void* stream) {
  ItemLaunchFn fn = deep ? &launch_items<kDirs, true, false>
                         : &launch_items<kDirs, false, false>;
  return fn(nullptr, pairs, starts, lens, nullptr, dirs, out, metrics, keys,
            work, n_bundles, pair_stride, 0, 0, 1, stream);
}
