// The item decomposition shared by the pair kernel (`pairs_kernel.cu`, all
// three modes) and the ray launch of the traversal kernel
// (`traverse_kernel.cu`).
//
// A launch has rows of 1024 rays; row r walks a span of candidates (pair-table
// columns, or the row's packed node queue) and keeps, per ray, the smallest
// candidate in a total order. Every span is cut into work items of at most
// kItemLen positions:
//   - a prologue launch sums max(1, ceil(len / kItemLen)) over the rows on the
//     device (`scan_items`: rowinfo[r] = (first item, span start, span length,
//     row id), the total in rowinfo[n_rows].x, and the walk's draw counter),
//     and clears the merge keys and arrival counts of every row of several
//     items (`clear_row`). No value comes back to the host;
//   - the walk launch is a fixed grid of kBlocksPerSm blocks per SM
//     (`walk_grid`). A block of kItemThreads threads with kRaysPerThread rays
//     each walks one item for one half of the row's rays: (item, half) is the
//     unit it draws. Block b begins with unit b and then draws units from the
//     counter, so units of unequal length balance. Warp 0 finds an item's row
//     by a 32-ary search of the prefix sums (`find_row`);
//   - a thread's rays are four consecutive in-row indices (`part_first_ray`):
//     a warp is 16 x 8 pixels of a 32-wide tile;
//   - a row of one item finishes in the blocks that walked it. A longer row
//     merges its items' winners with atomicMin on a 64-bit key per ray whose
//     unsigned order is the function's order (`pack_key`: the
//     order-preserving image of ts's f32 bits in the high word, a tie-break
//     word in the low word; all ones is "no candidate"); the last item to
//     arrive for a half of a row reads the merged keys back (`merge_keys`).
//     The atomics may land in any order: the minimum is the same.

#pragma once

#include <cuda_runtime.h>

namespace item_walk {

constexpr int kRays = 1024;         // rays per row
constexpr int kItemLen = 64;        // span positions per work item
constexpr int kRaysPerThread = 4;
constexpr int kItemThreads = 128;
// A block walks one item for kItemThreads * kRaysPerThread = 512 of the row's
// rays: the row's 1024 rays are two such halves, each a unit of work.
constexpr int kRowParts = kRays / (kItemThreads * kRaysPerThread);
static_assert(kRowParts == 2, "a row is two halves");
constexpr int kBlocksPerSm = 8;
constexpr int kPrologueThreads = 1024;
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr unsigned kNoCandidate = 0xFFFFFFFFu;
constexpr unsigned long long kEmptyKey = ~0ull;

__device__ __forceinline__ int items_of(int len) {
  return max(1, (len + kItemLen - 1) / kItemLen);
}

// 64 bits whose unsigned order is the order of (ts, low): the
// order-preserving image of ts's bits (sign bit set for positive values, all
// bits flipped for negative ones) above the tie-break word. -0.0 and +0.0
// compare equal (`==`), so -0.0 is packed as +0.0 and `low` decides.
__device__ __forceinline__ unsigned long long pack_key(float ts, unsigned low) {
  unsigned u = __float_as_uint(ts);
  if (u == 0x80000000u) u = 0u;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | low;
}

// Block 0 of a prologue (kPrologueThreads threads): rowinfo[r] = span(r) with
// .x replaced by the row's first item, the total in rowinfo[n_rows].x, and the
// walk's counter (block b of the walk begins with unit b). `span(r)` returns
// (-, start, length, row id).
template <class Span>
__device__ void scan_items(Span span, int n_rows, int4* __restrict__ rowinfo,
                           int* __restrict__ counter, int walk_blocks) {
  __shared__ int warp_total[32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int carry = 0;
  for (int base = 0; base < n_rows; base += kPrologueThreads) {
    const int r = base + tid;
    int4 s = make_int4(0, 0, 0, 0);
    int n = 0;
    if (r < n_rows) {
      s = span(r);
      n = items_of(s.z);
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
    s.x = carry + (warp ? warp_total[warp - 1] : 0) + x - n;
    if (r < n_rows) rowinfo[r] = s;
    carry += warp_total[31];
    __syncthreads();  // warp_total is rewritten by the next piece
  }
  if (tid == 0) {
    rowinfo[n_rows] = make_int4(carry, 0, 0, 0);
    *counter = walk_blocks;
  }
}

// One warp of a prologue: a row of several items starts with every merge key
// all ones and its arrival counts at 0.
__device__ __forceinline__ void clear_row(int r, int len,
                                          unsigned long long* __restrict__ keys,
                                          int* __restrict__ arrived, int lane) {
  if (items_of(len) > 1) {
    ulonglong2* k2 = reinterpret_cast<ulonglong2*>(keys + (size_t)r * kRays);
    for (int i = lane; i < kRays / 2; i += 32) {
      k2[i] = make_ulonglong2(kEmptyKey, kEmptyKey);
    }
    if (lane < kRowParts) arrived[r * kRowParts + lane] = 0;
  }
}

// Warp 0 of a walk block: the row whose items hold `item`, the last row with
// rowinfo[row].x <= item, into *s_info and *s_row. Each round probes 32 evenly
// spaced rows.
__device__ __forceinline__ void find_row(const int4* __restrict__ rowinfo,
                                         int n_rows, int item, int lane,
                                         int4* s_info, int* s_row) {
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
        *s_info = v;
        *s_row = lo + c;
      }
      return;
    }
    const int end = lo + n;
    lo += c * step;
    n = min(step, end - lo);
  }
}

// The thread's first ray within its block's half of a row: four consecutive
// in-row indices (a quad). A 32-wide tile row is 8 quads, and a warp takes 4
// of them on 8 rows (16 x 8 pixels): a small sphere then fails the early out
// for whole warps more often than on a 32 x 4 strip. The block's four warps
// tile its half of the row, 32 x 16 pixels; on rays in another order the same
// map is another permutation of the threads over the rays.
__device__ __forceinline__ int part_first_ray(int tid) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qx = ((warp & 1) << 2) | (lane & 3);
  const int qy = (warp >> 1) * 8 + (lane >> 2);
  return (qy * 8 + qx) * kRaysPerThread;
}

// The merge of one walked item of a row of `n_items` items, for the thread's
// kRaysPerThread rays: atomicMin of each ray's key into `row_keys` (the row's
// keys at the thread's first ray), then the arrival count of this half of the
// row. Returns true in the block of the last item to arrive; its bl[] then
// holds the merged low words (all ones where no item had a candidate). Every
// thread of the block calls it.
__device__ __forceinline__ bool merge_keys(unsigned long long* row_keys,
                                           const float* bt, unsigned* bl,
                                           int* arrive, int n_items,
                                           int* s_last) {
#pragma unroll
  for (int i = 0; i < kRaysPerThread; ++i) {
    if (bl[i] != kNoCandidate) atomicMin(row_keys + i, pack_key(bt[i], bl[i]));
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *s_last = atomicAdd(arrive, 1) == n_items - 1;
  __syncthreads();
  const bool finish = *s_last != 0;
  if (finish) {
    __threadfence();
#pragma unroll
    for (int i = 0; i < kRaysPerThread; i += 2) {
      const ulonglong2 kk =
          __ldcg(reinterpret_cast<const ulonglong2*>(row_keys + i));
      bl[i] = (unsigned)kk.x;
      bl[i + 1] = (unsigned)kk.y;
    }
  }
  return finish;
}

// The walk's grid: kBlocksPerSm blocks per SM of the current device, asked at
// every launch (an attribute query, no device work): cards may differ.
inline cudaError_t walk_grid(int* grid) {
  int card = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&card);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, card);
  }
  *grid = sms * kBlocksPerSm;
  return err;
}

}  // namespace item_walk
