// Per-bundle traversal of the 9-ary sphere tree: one block traces one bundle
// of 1024 rays on its own, from the root frame down.
//
// Replaces the reference package's TPU kernel body
// `sphereflake_tpu/ops/pallas_traversal.py:make_trace_kernel` (launched by
// `trace_tiles_pallas_soa`); wrapper and plain torch version:
// `sphereflake_tpu_torch/ops/pallas_traversal.py`.
//
// What it computes, per bundle (a screen tile, or 1024 tile-sorted Sobol
// pixels) with its 4 inward frustum plane normals:
//   - phase 1, node work, level by level from the root: the live nodes of the
//     level are walked in chunks of 128 parents; the 1152 children of a chunk
//     lie child-major (lane j * 128 + p for child j of parent p). A child's
//     frame is parent frame o template, the template's displacement scaled by
//     the level's tangent distance:
//       t'[a]   = ((R[a,0]*sd[0] + R[a,1]*sd[1]) + R[a,2]*sd[2]) + t[a]
//       R'[a,b] = (R[a,0]*rot[0,b] + R[a,1]*rot[1,b]) + R[a,2]*rot[2,b]
//       code'   = 9 * code + j                (root code 1)
//     A child is kept iff |c|^2 < (lod^2*r + 2r)^2 (conservative LOD bound) and
//     n.c >= -2r for each of the 4 planes (the bundle's frustum dilated by the
//     bounding radius 2r) and its parent lane is live. Survivors keep lane
//     order, chunk after chunk; the level holds at most caps[level+1] of them,
//     later ones are dropped and counted as overflow. caps[l] =
//     min(round_up_128(9^l), cap): the caps are part of the function, not a
//     storage detail.
//   - every level's live nodes, the root included, form the queue in frontier
//     order;
//   - phase 2, ray work: each ray tests exactly the queued nodes, levels
//     ascending, in queue order: tca = d.c, d2 = |c|^2 - tca^2,
//     c1 = tca - lod^2*r, ok = tca >= 0 and (c1 < 0 or c1^2 < 4r^2 - d2) and
//     d2 <= r^2, ts = tca - sqrt(max(r^2 - d2, 0)); the winner is replaced on
//     strict ts < bt only, so the first candidate in queue order wins a tie.
//   - out [T, 2, 1024] = (t, code): BIG and 0 at a miss. metrics [T, 8] =
//     (queue length, overflow, deepest level with a live node, live count of
//     the last level, 0, 0, 0, 0).
//
// Bound on this card: operations. A bundle reads 12 KB of directions and
// writes 8 KB; its queue of a few hundred nodes costs each of 1024 rays about
// 25 f32 operations per node. Neither phase touches device memory between the
// loads at the start and the stores at the end.
//
// Design: one block per bundle, 1024 threads. In phase 1 a thread is a child
// lane (two rounds cover the 1152 lanes of a chunk): it composes the child's
// centre in registers, culls it, and the block ranks the survivors in lane
// order with a warp ballot + popcount and the per-warp totals in shared
// memory; a survivor composes its rotation (not needed for the last level) and
// writes frame and queue entry straight to its rank. The TPU body's one
// [144,16]@[16,128] product and one-hot selection product have no counterpart
// here. In phase 2 a thread is a ray and every thread reads the same queue
// entry by broadcast. A bundle's working set is two 9-row rotation panels of
// the widest level (ping-pong) and the 5-row queue of all levels (x, y, z,
// |c|^2, code: a node's translation and code live only there), beside 1024
// words of tables. Two instantiations of one body differ in where the working
// set lives:
//   - in shared memory (182,784 bytes with the tables at max_frontier 1024,
//     depth 7, so one block per SM), one block per bundle — whenever it fits
//     the 232,448 bytes a block may use;
//   - else in a region of a workspace in device memory that the wrapper
//     allocates, one region per block, the blocks (one per SM) striding over
//     the bundles. __syncthreads() orders a block's own global writes and
//     reads.
// The wrapper picks by size; the arithmetic and the order are the same.
//
// Build without FMA contraction (-fmad=false) and without fast math, like
// pairs_kernel.cu: the plain torch version rounds every multiply and add.

#include <cuda_runtime.h>

namespace {

constexpr int kRays = 1024;       // rays of a bundle = threads of a block
constexpr int kLanes = 128;       // parents per chunk
constexpr int kChildW = 9 * kLanes;
constexpr int kMaxLevels = 8;     // max_depth <= 7 (f32 path codes stay exact)
constexpr float kBig = 3.0e38f;

// GLOBAL_WS: the working set lives in `workspace` (one region per block) and
// not in shared memory.
template <bool GLOBAL_WS>
__global__ void __launch_bounds__(kRays)
trace_tiles_kernel(const float* __restrict__ dirs,       // [T, 3, 1024]
                   const float* __restrict__ planes,     // [T, 4, 3]
                   const float* __restrict__ root,       // [3, 4]
                   const float* __restrict__ expand,     // [depth|1, 9, 12]
                   const float* __restrict__ level_tab,  // [4, depth + 1]
                   float* __restrict__ out,              // [T, 2, 1024]
                   int* __restrict__ metrics,            // [T, 8]
                   float* workspace,  // [gridDim.x, 18 * cap + 5 * sum(caps)]
                   int n_bundles, int depth, int cap) {
  extern __shared__ float smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_levels = depth + 1;

  int caps[kMaxLevels];
  int offs[kMaxLevels + 1];
  {
    int pow9 = 1;
    offs[0] = 0;
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      const int want = ((pow9 + kLanes - 1) / kLanes) * kLanes;
      caps[l] = l < n_levels ? min(want, cap) : 0;
      offs[l + 1] = offs[l] + caps[l];
      if (l < kMaxLevels - 1) pow9 *= 9;
    }
  }
  const int qtot = offs[kMaxLevels];
  const int ws_words = 18 * cap + 5 * qtot;

  float* const ws =
      GLOBAL_WS ? workspace + (size_t)blockIdx.x * ws_words : smem;
  float* const panel0 = ws;
  float* const panel1 = ws + 9 * cap;
  float* const qx = ws + 18 * cap;
  float* const qy = qx + qtot;
  float* const qz = qy + qtot;
  float* const qcc = qz + qtot;
  float* const qcode = qcc + qtot;
  float* const s_tab = GLOBAL_WS ? smem : smem + ws_words;  // [4][n_levels]
  float* const s_expand = s_tab + 32;       // [depth][9][12], 756 words
  float* const s_planes = s_expand + 756;   // 12 words
  int* const s_warp = reinterpret_cast<int*>(s_planes + 12);  // 32 words
  int* const s_live = s_warp + 32;          // 8 words

  for (int i = tid; i < 4 * n_levels; i += kRays) s_tab[i] = level_tab[i];
  for (int i = tid; i < depth * 108; i += kRays) s_expand[i] = expand[i];

  // One bundle per block, or (GLOBAL_WS) the blocks stride over the bundles.
#pragma unroll 1
  for (int blk = blockIdx.x; blk < n_bundles; blk += gridDim.x) {
    if (tid < 12) s_planes[tid] = planes[(size_t)blk * 12 + tid];
    if (tid == 0) {
      for (int a = 0; a < 3; ++a)
        for (int b = 0; b < 3; ++b) panel0[(3 * a + b) * cap] = root[4 * a + b];
      const float x = root[3], y = root[7], z = root[11];
      qx[0] = x;
      qy[0] = y;
      qz[0] = z;
      qcc[0] = x * x + y * y + z * z;
      qcode[0] = 1.0f;
    }
    __syncthreads();

    // ---- phase 1: levelwise expansion into the queue (node work) ----------
    // live, total, overflow are the same in every thread of the block.
    int live = 1, overflow = 0, max_level = 0, qlen = 0;
#pragma unroll 1
    for (int level = 0; level < n_levels; ++level) {
      if (live > 0) max_level = level;
      if (tid == 0) s_live[level] = live;
      qlen += live;
      if (level == depth) break;

      const float* cur = (level & 1) ? panel1 : panel0;
      float* nxt = (level & 1) ? panel0 : panel1;
      const int cap_n = caps[level + 1];
      const int off_p = offs[level];
      const int off_n = offs[level + 1];
      const float r_c = s_tab[level + 1];
      const float lod_rc = s_tab[3 * n_levels + level + 1];
      const float lim = lod_rc + 2.0f * r_c;
      const float lim2 = lim * lim;
      const float neg2r = -2.0f * r_c;
      const float* ex = s_expand + level * 108;
      const bool with_rot = level + 1 < depth;
      const int n_chunks = (live + kLanes - 1) / kLanes;

      int total = 0;
#pragma unroll 1
      for (int c = 0; c < n_chunks; ++c) {
#pragma unroll 1
        for (int base = 0; base < kChildW; base += kRays) {
          const int i = base + tid;        // child lane of this chunk
          const int j = i >> 7;            // child index 0..8
          const int pidx = c * kLanes + (i & (kLanes - 1));
          bool keep = false;
          float cx = 0.0f, cy = 0.0f, cz = 0.0f, cc = 0.0f;
          const float* e = ex + j * 12;
          if (i < kChildW && pidx < live) {
            const float sd0 = e[9], sd1 = e[10], sd2 = e[11];
            cx = ((cur[0 * cap + pidx] * sd0 + cur[1 * cap + pidx] * sd1) +
                  cur[2 * cap + pidx] * sd2) + qx[off_p + pidx];
            cy = ((cur[3 * cap + pidx] * sd0 + cur[4 * cap + pidx] * sd1) +
                  cur[5 * cap + pidx] * sd2) + qy[off_p + pidx];
            cz = ((cur[6 * cap + pidx] * sd0 + cur[7 * cap + pidx] * sd1) +
                  cur[8 * cap + pidx] * sd2) + qz[off_p + pidx];
            cc = cx * cx + cy * cy + cz * cz;
            keep = cc < lim2;
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              const float d_p = s_planes[3 * p] * cx +
                                s_planes[3 * p + 1] * cy +
                                s_planes[3 * p + 2] * cz;
              keep = keep && (d_p >= neg2r);
            }
          }
          // Rank of a survivor among the survivors of the level so far, in
          // lane order: ballot within the warp, totals of the warps before.
          const unsigned ballot = __ballot_sync(0xffffffffu, keep);
          if (lane == 0) s_warp[warp] = __popc(ballot);
          __syncthreads();
          int before = 0, round_total = 0;
#pragma unroll
          for (int w = 0; w < 32; ++w) {
            const int v = s_warp[w];
            before += w < warp ? v : 0;
            round_total += v;
          }
          const int rank =
              total + before + __popc(ballot & ((1u << lane) - 1u));
          if (keep && rank < cap_n) {
            qx[off_n + rank] = cx;
            qy[off_n + rank] = cy;
            qz[off_n + rank] = cz;
            qcc[off_n + rank] = cc;
            qcode[off_n + rank] = 9.0f * qcode[off_p + pidx] + (float)j;
            if (with_rot) {
#pragma unroll
              for (int a = 0; a < 3; ++a) {
                const float r0 = cur[(3 * a) * cap + pidx];
                const float r1 = cur[(3 * a + 1) * cap + pidx];
                const float r2 = cur[(3 * a + 2) * cap + pidx];
#pragma unroll
                for (int b = 0; b < 3; ++b) {
                  nxt[(3 * a + b) * cap + rank] =
                      (r0 * e[b] + r1 * e[3 + b]) + r2 * e[6 + b];
                }
              }
            }
          }
          total += round_total;
          __syncthreads();  // s_warp is reused; the writes are visible
        }
      }
      live = min(total, cap_n);
      overflow += max(total - cap_n, 0);
    }
    __syncthreads();

    // ---- phase 2: every ray tests exactly the queued nodes (ray work) ------
    const float* d = dirs + (size_t)blk * 3 * kRays;
    const float dx = d[tid];
    const float dy = d[kRays + tid];
    const float dz = d[2 * kRays + tid];
    float bt = kBig;
    float bc = 0.0f;
#pragma unroll 1
    for (int level = 0; level < n_levels; ++level) {
      const int n = s_live[level];
      const int off = offs[level];
      const float r2 = s_tab[n_levels + level];
      const float lodr = s_tab[3 * n_levels + level];
      const float four_r2 = 4.0f * r2;
      for (int q = off; q < off + n; ++q) {
        const float cx = qx[q];
        const float cy = qy[q];
        const float cz = qz[q];
        const float tca = dx * cx + dy * cy + dz * cz;
        const float d2 = qcc[q] - tca * tca;
        const float c1 = tca - lodr;
        const bool lod_ok = (c1 < 0.0f) || (c1 * c1 < four_r2 - d2);
        const bool ok = (tca >= 0.0f) && lod_ok && (d2 <= r2);
        const float ts = tca - sqrtf(fmaxf(r2 - d2, 0.0f));
        if (ok && ts < bt) {
          bt = ts;
          bc = qcode[q];
        }
      }
    }

    float* o = out + (size_t)blk * 2 * kRays;
    o[tid] = bt;
    o[kRays + tid] = bc;
    if (tid < 8) {
      const int m = tid == 0 ? qlen
                  : tid == 1 ? overflow
                  : tid == 2 ? max_level
                  : tid == 3 ? live
                             : 0;
      metrics[(size_t)blk * 8 + tid] = m;
    }
    __syncthreads();  // the next bundle reuses planes, panels and queue
  }
}

}  // namespace

// Plain C entry point: enqueues one launch on `stream` and returns the CUDA
// error code (0 on success). It neither synchronises nor allocates; every
// pointer is device memory owned by the caller. `cap` is the widest level cap.
// With n_blocks == 0 the working set lives in shared memory, one block per
// bundle, and `shared_bytes` = 4 * (18 * cap + 5 * sum(caps) + 1024); with
// n_blocks > 0 it lives in `workspace` ([n_blocks, 18 * cap + 5 * sum(caps)]
// floats), n_blocks blocks stride over the bundles, and `shared_bytes` = 4096
// holds the tables.
extern "C" int sf_trace_tiles(const float* dirs, const float* planes,
                              const float* root, const float* expand,
                              const float* level_tab, float* out, int* metrics,
                              float* workspace, int n_bundles, int depth,
                              int cap, int shared_bytes, int n_blocks,
                              void* stream) {
  if (n_bundles <= 0) return 0;
  if (depth < 0 || depth >= kMaxLevels) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_blocks > 0) {
    trace_tiles_kernel<true><<<n_blocks, kRays, shared_bytes, s>>>(
        dirs, planes, root, expand, level_tab, out, metrics, workspace,
        n_bundles, depth, cap);
    return (int)cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(
      trace_tiles_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      shared_bytes);
  if (err != cudaSuccess) return (int)err;
  trace_tiles_kernel<false><<<n_bundles, kRays, shared_bytes, s>>>(
      dirs, planes, root, expand, level_tab, out, metrics, nullptr, n_bundles,
      depth, cap);
  return (int)cudaGetLastError();
}
