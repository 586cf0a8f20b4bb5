// Binned ray tests against the fat-row pair table: three launch modes of one
// function, in two decompositions.
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
// and the two decompositions below rest on that.
//
// Bound on this card: operations, not bytes. A 1080p depth-6 frame moves
// about 67 MB of output and 4 MB of pair table (about 21 us at 3.35 TB/s) but
// runs about 1.2e8 ray-sphere tests of about 25 f32 operations each (about
// 3 GFLOP: about 45 us at the 67 TFLOP/s non-tensor f32 peak, which counts a
// fused multiply-add as two; this build fuses none). A 1,024-tile SHADE_ONLY
// refresh step is a third of that; a 65,536-sample DIRS step writes 1.3 MB
// and tests 1.2e8 times. The work is a loop of data-dependent length with
// compares and selects, so both designs keep the loop free of global memory
// traffic. Tensor cores are not used: tca is a product of depth 3 whose f32
// rounding decides hit or miss at grazes (disc ~ 0), and TF32 would change
// the function.
//
// FULL: one block per tile, one thread per ray (1024 threads, at most 64
// registers a thread), a single accumulator per ray with the tie rule applied
// directly; the block stages its segment through shared memory in 256-pair
// pieces and every thread reads each pair by broadcast. 2,040 blocks of
// about 59 pairs fill the card; the longest segment (590) is its tail.
//
// SUBSET and DIRS: work items of bounded size. One block per row makes a
// launch last as long as its longest span on one SM (a sample step's 64
// bundles have spans up to 6,320 pairs, mean 1,933, and occupy 64 of 132
// SMs), and a 1,024-thread block holds one ray a thread behind a chain of
// three dependent index loads. So:
//   - every span is cut into items of at most kItemPairs pairs. A prologue
//     launch (`item_prologue_kernel`) sums ceil(len / kItemPairs) over the
//     rows on the device (an empty span counts as one item, which writes
//     sky) and stores, per row, (first item, span start, span length, tile
//     id). No value comes back to the host;
//   - the walk launch (`walk_items_kernel`) is a fixed grid of kBlocksPerSm
//     blocks per SM, whatever the data. A block of 128 threads with four rays
//     each walks one item for one half of the row's rays; (item, half) is
//     the unit it draws. Block b
//     begins with unit b and then draws units from a counter in device
//     memory, so units of unequal length balance. Warp 0 finds an item's row
//     in the prefix sums by a 32-ary search (two dependent loads for 1,024
//     rows);
//   - a thread's rays have consecutive in-tile indices, so one 16-byte
//     shared-memory broadcast of (cx, cy, cz, rc) and, past the early out,
//     one 8-byte broadcast of (lodr, rc4) serve several tests, independent
//     chains hide the square root's latency, and eight small blocks an SM
//     overlap each other's index loads and barriers. A warp is 16 x 8
//     pixels of a 32-wide tile, and a store instruction writes 64-byte runs;
//   - the walk carries one key per ray, (ts, k): codes and centres are read
//     from the table once per ray, by the finish, at pairs[:, start + k]. The
//     loop is the same for SHADE_ONLY, coded, shallow and deep, which differ
//     only in the rows that hold lodr and rc4;
//   - warp-uniform early out: tca and disc come first; the LOD gate, the
//     square root and the key update run only where __any_sync says that
//     some lane's disc >= 0 (13 % of a tile step's (warp, pair) tests, 5 %
//     of a sample step's). Lanes that pass do the same arithmetic as before;
//   - a row of one item finishes in the blocks that walked it: no key leaves
//     the registers. A longer row merges its items' winners with atomicMin
//     on a 64-bit key per ray whose unsigned order is the function's order:
//     the order-preserving image of ts's f32 bits in the high word (sign bit
//     set for positive values, all bits flipped for negative ones), k mod 8
//     in bits 31..29 and k in bits 28..0 of the low word; all ones means no
//     candidate. The atomics may land in any order: the minimum is the same.
//     -0.0 and +0.0 compare equal in the plain version (`ts == bt`), so -0.0
//     is packed as +0.0 and (k mod 8, k) decides between them; the finish
//     recomputes ts from the winner's own column, so the output carries the
//     winner's own sign. The last item to arrive for a half of a row (a
//     counter per row and half behind __threadfence()) reads the merged keys
//     and finishes that half;
//   - an item is one staged piece, so there is no ring of asynchronous
//     copies: the other blocks of the SM cover an item's loads.
// On an NVIDIA H100 80GB HBM3 at 700 W (`chip_smoke.py`, `frameless_times`)
// the 1,024-tile SHADE_ONLY step takes about 0.06 ms (one block per tile:
// 0.17) and the 65,536-sample DIRS step about 0.08 ms (1.27), a quarter and
// a half of bounds that count a fused multiply-add as two. Most of the time
// is the early-out path: 36 instructions for four tests, 28 of them
// the multiplies and adds of tca and disc, which fused would be 16. The
// constants below are the fastest of the item sizes, block sizes, blocks an
// SM, rays a thread and warp footprints timed there (PERF.md, Findings).
//
// Build without FMA contraction (-fmad=false) and without fast math: the plain
// torch version of this function runs unfused f32 multiplies and adds, and a
// contracted tca / disc moves tangent grazes (disc ~ 0) between hit and miss.

#include <cuda_runtime.h>

namespace {

constexpr int kRays = 1024;   // rays per tile or bundle
constexpr int kChunk = 256;   // FULL: pairs staged through shared memory at a time
constexpr float kBig = 3.0e38f;

// ---------------------------------------------------------------------------
// FULL: one block per tile, one thread per ray.
// ---------------------------------------------------------------------------

template <bool DEEP>
__global__ void __launch_bounds__(kRays)
trace_pairs_kernel(const float* __restrict__ cam,
                   const float* __restrict__ pairs,
                   const int* __restrict__ starts,
                   const int* __restrict__ lens,
                   float* __restrict__ out,
                   int* __restrict__ metrics,
                   int pair_stride, int tile_w_log2, int tile_h,
                   int tiles_x) {
  constexpr int ROWS = DEEP ? 8 : 7;
  constexpr int NOUT = DEEP ? 9 : 8;
  constexpr int R_LODR = DEEP ? 6 : 5;
  constexpr int R_RC4 = DEEP ? 7 : 6;

  __shared__ float seg[ROWS][kChunk];
  __shared__ float scam[16];

  const int t = blockIdx.x;
  const int flat = threadIdx.x;
  if (flat < 16) scam[flat] = cam[flat];
  const int start = starts[t];
  const int len = lens[t];
  __syncthreads();

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
  float dx = (scam[0] + (scam[3] * u + scam[6] * v)) - scam[9];
  float dy = (scam[1] + (scam[4] * u + scam[7] * v)) - scam[10];
  float dz = (scam[2] + (scam[5] * u + scam[8] * v)) - scam[11];
  const float dnorm = sqrtf(dx * dx + dy * dy + dz * dz);
  dx = dx / dnorm;
  dy = dy / dnorm;
  dz = dz / dnorm;

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
      if (c < cnt) {
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
      // The single accumulator applies the order directly: k only grows, so
      // (k mod 8, k) is smaller exactly when k mod 8 is.
      const bool better =
          ok && ((ts < bt) || (ts == bt && (k & 7) < (bk & 7)));
      if (better) {
        bt = ts;
        bk = k;
        blo = seg[4][j];
        if constexpr (DEEP) bhi = seg[5][j];
        bcx = cx;
        bcy = cy;
        bcz = cz;
      }
    }
  }

  // Epilogue: G-buffer shading of the winner. position = dir * t
  // (camera-relative), normal = normalize(position - center), zeros at sky.
  float* o = out + (size_t)t * NOUT * kRays + flat;
  int c = 0;
  bool hit = blo >= 1.0f;
  if constexpr (DEEP) hit = hit || (bhi >= 1.0f);
  const float t0 = hit ? bt : 0.0f;
  const float px = dx * t0, py = dy * t0, pz = dz * t0;
  const float wx = px - bcx, wy = py - bcy, wz = pz - bcz;
  float nn = sqrtf(fmaxf(wx * wx + wy * wy + wz * wz, 0.0f));
  nn = nn > 0.0f ? nn : 1.0f;
  const float hf = hit ? 1.0f : 0.0f;

  o[(c++) * kRays] = hit ? bt : kBig;
  o[(c++) * kRays] = blo;
  if constexpr (DEEP) o[(c++) * kRays] = bhi;
  o[(c++) * kRays] = px;
  o[(c++) * kRays] = py;
  o[(c++) * kRays] = pz;
  o[(c++) * kRays] = hf * (wx / nn);
  o[(c++) * kRays] = hf * (wy / nn);
  o[(c++) * kRays] = hf * (wz / nn);

  if (flat < 4) metrics[t * 4 + flat] = (flat == 0) ? len : 0;
}

// ---------------------------------------------------------------------------
// SUBSET and DIRS: bounded work items, a key-only walk, an order-free merge.
// ---------------------------------------------------------------------------

enum Mode { kSubset = 1, kDirs = 2 };

// Pairs per work item; `ITEM_PAIRS` of ops/binned.py mirrors it.
constexpr int kItemPairs = 64;
constexpr int kRaysPerThread = 4;
constexpr int kItemThreads = 128;
// A block walks one item for kItemThreads * kRaysPerThread = 512 of the row's
// rays: the row's 1024 rays are two such halves, each a unit of work.
constexpr int kRowParts = kRays / (kItemThreads * kRaysPerThread);
static_assert(kRowParts == 2, "a row is two halves");
constexpr int kBlocksPerSm = 8;
constexpr int kWalkUnroll = 4;  // pairs per trip of the walk
constexpr int kPrologueThreads = 1024;
constexpr unsigned kFullMask = 0xFFFFFFFFu;
// Low word of a key: k mod 8 in bits 31..29, k in bits 28..0. All ones is
// "no candidate", so k stays below 2^29 - 1 (the wrappers check pair_cap).
constexpr int kKeyKBits = 29;
constexpr unsigned kKeyKMask = (1u << kKeyKBits) - 1u;
constexpr unsigned kNoCandidate = 0xFFFFFFFFu;
constexpr unsigned long long kEmptyKey = ~0ull;


__device__ __forceinline__ unsigned key_low(int k) {
  return ((unsigned)(k & 7) << kKeyKBits) | (unsigned)k;
}

// 64 bits whose unsigned order is the order of (ts, k mod 8, k).
__device__ __forceinline__ unsigned long long pack_key(float ts, unsigned low) {
  unsigned u = __float_as_uint(ts);
  if (u == 0x80000000u) u = 0u;  // -0.0 ties with +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | low;
}

__device__ __forceinline__ int items_of(int len) {
  return max(1, (len + kItemPairs - 1) / kItemPairs);
}

// Launch 1 of 2. Block 0: the prefix sum of items over the rows, into
// rowinfo[r] = (first item, span start, span length, tile id), the total in
// rowinfo[n_rows].x, and the walk's item counter. Blocks 1..: one warp per
// row writes the row's metrics and, for a row of several items, clears its
// merge keys and its arrival count.
template <bool SUBSET>
__global__ void __launch_bounds__(kPrologueThreads)
item_prologue_kernel(const int* __restrict__ starts,
                     const int* __restrict__ lens,
                     const int* __restrict__ tile_ids, int n_rows,
                     int4* __restrict__ rowinfo, int* __restrict__ arrived,
                     int* __restrict__ counter,
                     unsigned long long* __restrict__ keys,
                     int* __restrict__ metrics, int walk_blocks) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (blockIdx.x == 0) {
    __shared__ int warp_total[32];
    int carry = 0;
    for (int base = 0; base < n_rows; base += kPrologueThreads) {
      const int r = base + tid;
      int n = 0, st = 0, len = 0, t = 0;
      if (r < n_rows) {
        t = SUBSET ? tile_ids[r] : r;
        st = starts[t];
        len = lens[t];
        n = items_of(len);
      }
      int x = n;  // inclusive scan within the warp
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFullMask, x, o);
        if (lane >= o) x += y;
      }
      if (lane == 31) warp_total[warp] = x;
      __syncthreads();
      if (warp == 0) {
        int w = warp_total[lane];
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFullMask, w, o);
          if (lane >= o) w += y;
        }
        warp_total[lane] = w;
      }
      __syncthreads();
      const int first = carry + (warp ? warp_total[warp - 1] : 0) + x - n;
      if (r < n_rows) rowinfo[r] = make_int4(first, st, len, t);
      carry += warp_total[31];
      __syncthreads();  // warp_total is rewritten by the next piece
    }
    if (tid == 0) {
      rowinfo[n_rows] = make_int4(carry, 0, 0, 0);
      *counter = walk_blocks;  // block b of the walk begins with unit b
    }
  } else {
    const int r = (blockIdx.x - 1) * (kPrologueThreads / 32) + warp;
    if (r >= n_rows) return;
    const int t = SUBSET ? tile_ids[r] : r;
    const int len = lens[t];
    if (lane < 4) metrics[r * 4 + lane] = (lane == 0) ? len : 0;
    if (items_of(len) > 1) {
      ulonglong2* k2 = reinterpret_cast<ulonglong2*>(keys + (size_t)r * kRays);
      for (int i = lane; i < kRays / 2; i += 32) {
        k2[i] = make_ulonglong2(kEmptyKey, kEmptyKey);
      }
      if (lane < kRowParts) arrived[r * kRowParts + lane] = 0;
    }
  }
}

// Launch 2 of 2: a fixed grid of blocks that walk items until none is left.
// `index`: the dirs (kDirs); unused for kSubset, whose tile ids are in rowinfo.
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
  __shared__ float4 s_pair[kItemPairs][2];
  __shared__ float scam[16];
  __shared__ int4 s_info;
  __shared__ int s_row, s_next, s_last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (MODE == kSubset && tid < 16) scam[tid] = cam[tid];
  const int total = rowinfo[n_rows].x;

  // The thread's rays: four consecutive in-tile indices (a quad) from f0. A
  // 32-wide tile row is 8 quads, and a warp takes 4 of them on 8 rows (16 x 8
  // pixels): a small sphere then fails the early out for whole warps more
  // often than on a 32 x 4 strip. The block's four warps tile its half of
  // the row, 32 x 16 pixels; on a tile of another width the same map is
  // another permutation of the threads over the rays.
  const int warp = tid >> 5;
  const int qx = ((warp & 1) << 2) | (lane & 3);
  const int qy = (warp >> 1) * 8 + (lane >> 2);
  const int part_f0 = (qy * 8 + qx) * RPT;  // within the block's half

  int work = blockIdx.x;
  while (work < total * kRowParts) {
    const int item = work / kRowParts;
    const int part = work % kRowParts;
    // Warp 0 finds the row whose items hold `item`: the last row with
    // rowinfo[row].x <= item. Each round probes 32 evenly spaced rows.
    if (tid < 32) {
      int lo = 0, n = n_rows;
      while (true) {
        const int step = (n + 31) >> 5;
        const int p = lo + lane * step;
        const bool in = p < lo + n;
        int4 v = make_int4(0, 0, 0, 0);
        if (in) v = rowinfo[p];
        const unsigned m = __ballot_sync(kFullMask, in && v.x <= item);
        const int c = __popc(m) - 1;  // lane 0 always passes
        if (step == 1) {
          v.x = __shfl_sync(kFullMask, v.x, c);
          v.y = __shfl_sync(kFullMask, v.y, c);
          v.z = __shfl_sync(kFullMask, v.z, c);
          v.w = __shfl_sync(kFullMask, v.w, c);
          if (lane == 0) {
            s_info = v;
            s_row = lo + c;
          }
          break;
        }
        const int end = lo + n;
        lo += c * step;
        n = min(step, end - lo);
      }
    }
    __syncthreads();
    const int4 info = s_info;
    const int row = s_row;
    const int f0 = part * (kItemThreads * RPT) + part_f0;
    const int start = info.y;
    const int len = info.z;
    const int base = (item - info.x) * kItemPairs;
    const int cnt = max(0, min(kItemPairs, len - base));

    // Stage the item: six rows of the table, interleaved per pair.
    for (int i = tid; i < 6 * kItemPairs; i += kItemThreads) {
      const int r = i / kItemPairs;
      const int c = i % kItemPairs;
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
    bool finish = items_of(len) == 1;
    if (!finish) {
      unsigned long long* row_keys = keys + (size_t)row * kRays + f0;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        if (bl[i] != kNoCandidate) {
          atomicMin(row_keys + i, pack_key(bt[i], bl[i]));
        }
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) {
        s_last = atomicAdd(arrived + row * kRowParts + part, 1) ==
                 items_of(len) - 1;
      }
      __syncthreads();
      finish = s_last != 0;
      if (finish) {
        __threadfence();
#pragma unroll
        for (int i = 0; i < RPT; i += 2) {
          const ulonglong2 kk =
              __ldcg(reinterpret_cast<const ulonglong2*>(row_keys + i));
          bl[i] = (unsigned)kk.x;  // all ones where no item had a candidate
          bl[i + 1] = (unsigned)kk.y;
        }
      }
    }

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
  // The walk's grid follows the current device's SM count, asked at every
  // launch (an attribute query, no device work): cards may differ.
  int card = 0, sms = 0;
  cudaError_t asked = cudaGetDevice(&card);
  if (asked == cudaSuccess) {
    asked = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, card);
  }
  if (asked != cudaSuccess) return static_cast<int>(asked);
  const int grid = sms * kBlocksPerSm;
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
// pointer is device memory owned by the caller.

// Full tile grid: out [n_tiles, 8|9, 1024].
extern "C" int sf_trace_pairs_fused(const float* cam, const float* pairs,
                                    const int* starts, const int* lens,
                                    float* out, int* metrics, int n_tiles,
                                    int pair_stride, int tile_w_log2,
                                    int tile_h, int tiles_x, int deep,
                                    void* stream) {
  if (n_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (deep) {
    trace_pairs_kernel<true><<<n_tiles, kRays, 0, s>>>(
        cam, pairs, starts, lens, out, metrics, pair_stride, tile_w_log2,
        tile_h, tiles_x);
  } else {
    trace_pairs_kernel<false><<<n_tiles, kRays, 0, s>>>(
        cam, pairs, starts, lens, out, metrics, pair_stride, tile_w_log2,
        tile_h, tiles_x);
  }
  return static_cast<int>(cudaGetLastError());
}

// Tile subset: row k renders frame tile tile_ids[k]; out
// [n_ids, 7 (shade_only) | 8 | 9, 1024]. Every id must lie in [0, n_tiles)
// of the starts / lens tables (the caller's contract). Scratch: keys
// [n_ids, 1024] 64-bit, work [8 * n_ids + 8] int32; neither needs a value.
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
// [n_bundles] spans; out [n_bundles, 5|6, 1024]. Scratch as above.
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
