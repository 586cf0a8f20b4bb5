// Per-bundle traversal of the 9-ary sphere tree: every bundle of 1024 rays
// walks the tree on its own, from the root frame down, in two launches — a
// node launch that builds each bundle's queue, and a ray launch that tests
// the queues on the item walk of `item_walk.cuh`.
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
// writes 8 KB; its queue of a few dozen to a few thousand nodes costs each of
// 1024 rays about 25 f32 operations per node, and the expansion about 55 per
// child examined.
//
// Design. One block of 1024 threads per bundle, with the bundle's working set
// in shared memory sized for the level caps (162 KB at max_frontier 1024,
// depth 6), would hold one block per SM and run a 1080p frame's 2,040
// bundles in 16 serial waves, each mostly a chain of barriers over child
// lanes that have no parent (a frame's mean queue is 52 nodes); and 64 Sobol
// bundles would leave half the SMs idle. So the two phases are two launches:
//   - node launch (`expand_kernel`): a persistent grid of small blocks, as
//     many as fit on the card, each drawing bundles from a counter. A level of
//     `live` parents enumerates only its 9 * live valid lanes: flat lane e
//     lies in chunk c = e / 1152 and, with m = the chunk's live parents, is
//     child j = (e mod 1152) / m of parent p = (e mod 1152) mod m — the same
//     order as lane j * 128 + p over the valid lanes, so a level costs
//     ceil(9 * live / kNodeThreads) rounds. A round ranks its survivors by a
//     ballot and the per-warp totals (one barrier a round: the totals are
//     double-buffered). The working set lives in device memory, where only
//     the touched part is read and stays in L2: the bundle's queue region
//     (x, y, z, |c|^2, code of every queued node, packed from position 0:
//     level l's nodes follow level l - 1's) and, per resident block, two
//     9-row rotation panels (ping-pong between levels). A node's level is not
//     stored: a level-l code lies in [9^l, 2 * 9^l);
//   - ray launch (`queue_prologue_kernel` + `walk_queue_kernel`): the item
//     walk with the bundle as the row and its packed queue [0, qlen) as the
//     span, qlen read on the device from the node launch's metrics. A stage
//     of an item holds (x, y, z, |c|^2) and (r^2, lod^2 r, 4 r^2, code) per
//     node; tca and d2 come first and the LOD gate, the square root and the
//     update run only where some lane of the warp has d2 <= r^2. The merge
//     key's low word is the queue position q: the smallest (ts, q), which is
//     the first in queue order among equal t. The finish reads the winner's
//     node once and recomputes ts by the walk's own expression.
// On an NVIDIA H100 80GB HBM3 at 700 W (`chip_smoke.py`, `pallas_times`) the
// frame's 2,040 bundles take about 0.13 ms (node launch 0.04, ray launch
// 0.09; one block per bundle: 0.46) and the 64 Sobol bundles about 0.14
// (0.06 + 0.08; 0.64). kNodeThreads is the best over both of the block sizes
// 128, 256, 512 and 1024 timed there (PERF.md, Findings).
//
// Build without FMA contraction (-fmad=false) and without fast math, like
// pairs_kernel.cu: the plain torch version rounds every multiply and add.

#include <cuda_runtime.h>

#include "item_walk.cuh"

namespace {

using namespace item_walk;

constexpr int kLanes = 128;       // parents per chunk
constexpr int kChildW = 9 * kLanes;
constexpr int kMaxLevels = 8;     // max_depth <= 7 (f32 path codes stay exact)
constexpr int kQueueRows = 5;     // x, y, z, |c|^2, code
constexpr int kNodeThreads = 256;
constexpr int kNodeWarps = kNodeThreads / 32;
// At least 1024 threads of the node launch an SM: at most 64 registers.
constexpr int kNodeMinBlocks = 1024 / kNodeThreads;
constexpr float kBig = 3.0e38f;

// Level l's cap, min(round_up_128(9^l), cap), from pow9 = 9^l.
__device__ __forceinline__ int level_cap(int pow9, int cap) {
  return min(((pow9 + kLanes - 1) / kLanes) * kLanes, cap);
}

// The sum of the level caps: the length of a bundle's queue region.
__device__ __forceinline__ int queue_cap(int n_levels, int cap) {
  int pow9 = 1, sum = 0;
  for (int l = 0; l < n_levels; ++l, pow9 *= 9) sum += level_cap(pow9, cap);
  return sum;
}

// The level of a sentinel-prefixed path code (exact in f32 below 2 * 9^7).
__device__ __forceinline__ int level_of(float code) {
  int level = 0;
  float pow9 = 9.0f;
#pragma unroll
  for (int l = 1; l < kMaxLevels; ++l) {
    level += code >= pow9 ? 1 : 0;
    pow9 *= 9.0f;
  }
  return level;
}

// Node launch: a persistent grid; block b begins with bundle b and then draws
// bundles from `counter` (0 on entry). The queue pool is [T, 5, sum(caps)],
// the panels [gridDim.x, 2, 9, cap].
__global__ void __launch_bounds__(kNodeThreads, kNodeMinBlocks)
expand_kernel(const float* __restrict__ planes,     // [T, 4, 3]
              const float* __restrict__ root,       // [3, 4]
              const float* __restrict__ expand,     // [depth|1, 9, 12]
              const float* __restrict__ level_tab,  // [4, depth + 1]
              float* pool, float* panels,
              int* __restrict__ metrics,            // [T, 8]
              int* __restrict__ counter, int n_bundles, int depth, int cap) {
  __shared__ float s_lim2[kMaxLevels], s_neg2r[kMaxLevels];
  __shared__ float s_expand[(kMaxLevels - 1) * 108];
  __shared__ float s_planes[12];
  __shared__ int s_warp[2][kNodeWarps];
  __shared__ int s_next;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_levels = depth + 1;
  const int qcap = queue_cap(n_levels, cap);

  if (tid < n_levels) {
    const float r_c = level_tab[tid];
    const float lim = level_tab[3 * n_levels + tid] + 2.0f * r_c;
    s_lim2[tid] = lim * lim;
    s_neg2r[tid] = -2.0f * r_c;
  }
  for (int i = tid; i < depth * 108; i += kNodeThreads) s_expand[i] = expand[i];
  float* const panel0 = panels + (size_t)blockIdx.x * 18 * cap;
  float* const panel1 = panel0 + 9 * cap;

  int n_round = 0;
  int blk = blockIdx.x;
#pragma unroll 1
  while (blk < n_bundles) {
    float* const qx = pool + (size_t)blk * kQueueRows * qcap;
    float* const qy = qx + qcap;
    float* const qz = qy + qcap;
    float* const qcc = qz + qcap;
    float* const qcode = qcc + qcap;
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

    // live, qlen, overflow are the same in every thread of the block.
    int live = 1, overflow = 0, max_level = 0, qlen = 0;
    int pow9n = 9;  // 9^(level + 1)
#pragma unroll 1
    for (int level = 0; level < n_levels; ++level, pow9n *= 9) {
      if (live > 0) max_level = level;
      const int off_p = qlen;  // this level's nodes: [off_p, off_p + live)
      qlen += live;
      if (level == depth) break;

      const float* cur = (level & 1) ? panel1 : panel0;
      float* nxt = (level & 1) ? panel0 : panel1;
      const int cap_n = level_cap(pow9n, cap);
      const int off_n = qlen;  // the children follow
      const float lim2 = s_lim2[level + 1];
      const float neg2r = s_neg2r[level + 1];
      const float* ex = s_expand + level * 108;
      const bool with_rot = level + 1 < depth;
      const int n_lanes = 9 * live;

      int total = 0;
#pragma unroll 1
      for (int base = 0; base < n_lanes; base += kNodeThreads) {
        const int e_all = base + tid;
        bool keep = false;
        int j = 0, pidx = 0;
        float cx = 0.0f, cy = 0.0f, cz = 0.0f, cc = 0.0f;
        if (e_all < n_lanes) {
          const int c = e_all / kChildW;
          const int e = e_all - c * kChildW;
          const int m = min(kLanes, live - c * kLanes);
          j = e / m;
          pidx = c * kLanes + (e - j * m);
          const float* sd = ex + j * 12 + 9;
          const int pq = off_p + pidx;
          cx = ((cur[0 * cap + pidx] * sd[0] + cur[1 * cap + pidx] * sd[1]) +
                cur[2 * cap + pidx] * sd[2]) + qx[pq];
          cy = ((cur[3 * cap + pidx] * sd[0] + cur[4 * cap + pidx] * sd[1]) +
                cur[5 * cap + pidx] * sd[2]) + qy[pq];
          cz = ((cur[6 * cap + pidx] * sd[0] + cur[7 * cap + pidx] * sd[1]) +
                cur[8 * cap + pidx] * sd[2]) + qz[pq];
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
        const unsigned ballot = __ballot_sync(kFullMask, keep);
        int* const sw = s_warp[n_round & 1];
        ++n_round;
        if (lane == 0) sw[warp] = __popc(ballot);
        __syncthreads();
        int before = 0, round_total = 0;
#pragma unroll
        for (int w = 0; w < kNodeWarps; ++w) {
          const int v = sw[w];
          before += w < warp ? v : 0;
          round_total += v;
        }
        const int rank = total + before + __popc(ballot & ((1u << lane) - 1u));
        if (keep && rank < cap_n) {
          const int nq = off_n + rank;
          qx[nq] = cx;
          qy[nq] = cy;
          qz[nq] = cz;
          qcc[nq] = cc;
          qcode[nq] = 9.0f * qcode[off_p + pidx] + (float)j;
          if (with_rot) {
            const float* e = ex + j * 12;
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
      }
      __syncthreads();  // the level's queue and panel are written
      live = min(total, cap_n);
      overflow += max(total - cap_n, 0);
    }

    if (tid < 8) {
      const int m = tid == 0 ? qlen
                  : tid == 1 ? overflow
                  : tid == 2 ? max_level
                  : tid == 3 ? live
                             : 0;
      metrics[(size_t)blk * 8 + tid] = m;
    }
    // The next bundle. The barriers keep planes, panels and s_next alive
    // until every thread is done with them.
    if (tid == 0) s_next = gridDim.x + atomicAdd(counter, 1);
    __syncthreads();
    blk = s_next;
    __syncthreads();
  }
}

// Ray launch 1 of 2: block 0 sums the items of the queues [0, qlen) over the
// bundles (`scan_items`); blocks 1..: one warp per bundle clears the merge
// keys and arrival counts of a queue of several items.
__global__ void __launch_bounds__(kPrologueThreads)
queue_prologue_kernel(const int* __restrict__ metrics, int n_rows,
                      int4* __restrict__ rowinfo, int* __restrict__ arrived,
                      int* __restrict__ counter,
                      unsigned long long* __restrict__ keys, int walk_blocks) {
  auto span = [&](int r) { return make_int4(0, 0, metrics[(size_t)r * 8], r); };
  if (blockIdx.x == 0) {
    scan_items(span, n_rows, rowinfo, counter, walk_blocks);
    return;
  }
  const int r = (blockIdx.x - 1) * (kPrologueThreads / 32) + (threadIdx.x >> 5);
  if (r >= n_rows) return;
  clear_row(r, span(r).z, keys, arrived, threadIdx.x & 31);
}

// Ray launch 2 of 2: a fixed grid of blocks that walk items of the queues
// until none is left. out [T, 2, 1024] = (t, code).
__global__ void __launch_bounds__(kItemThreads, kBlocksPerSm)
walk_queue_kernel(const float* __restrict__ dirs,       // [T, 3, 1024]
                  const float* __restrict__ pool,       // [T, 5, sum(caps)]
                  const float* __restrict__ level_tab,  // [4, depth + 1]
                  const int4* __restrict__ rowinfo, int* __restrict__ arrived,
                  int* __restrict__ counter,
                  unsigned long long* __restrict__ keys,
                  float* __restrict__ out, int n_rows, int depth, int cap) {
  constexpr int RPT = kRaysPerThread;
  // The staged item, 32 bytes a node: (x, y, z, |c|^2), (r^2, lodr, 4r^2, code).
  __shared__ float4 s_node[kItemLen][2];
  __shared__ float s_r2[kMaxLevels], s_lodr[kMaxLevels];
  __shared__ int4 s_info;
  __shared__ int s_row, s_next, s_last;

  const int tid = threadIdx.x;
  const int n_levels = depth + 1;
  const int qcap = queue_cap(n_levels, cap);
  if (tid < n_levels) {
    s_r2[tid] = level_tab[n_levels + tid];
    s_lodr[tid] = level_tab[3 * n_levels + tid];
  }
  const int total = rowinfo[n_rows].x;
  const int part_f0 = part_first_ray(tid);

  int work = blockIdx.x;
  while (work < total * kRowParts) {
    const int item = work / kRowParts;
    const int part = work % kRowParts;
    if (tid < 32) find_row(rowinfo, n_rows, item, tid, &s_info, &s_row);
    __syncthreads();
    const int row = s_row;
    const int len = s_info.z;
    const int f0 = part * (kItemThreads * RPT) + part_f0;
    const int base = (item - s_info.x) * kItemLen;
    const int cnt = max(0, min(kItemLen, len - base));
    const float* q = pool + (size_t)row * kQueueRows * qcap;

    // Stage the item: a thread per node.
    for (int c = tid; c < cnt; c += kItemThreads) {
      const int n = base + c;
      const float code = q[4 * qcap + n];
      const int level = level_of(code);
      const float r2 = s_r2[level];
      s_node[c][0] = make_float4(q[n], q[qcap + n], q[2 * qcap + n],
                                 q[3 * qcap + n]);
      s_node[c][1] = make_float4(r2, s_lodr[level], 4.0f * r2, code);
    }

    float dx[RPT], dy[RPT], dz[RPT];
    {
      const float* d = dirs + (size_t)row * 3 * kRays + f0;
      const float4 x = *reinterpret_cast<const float4*>(d);
      const float4 y = *reinterpret_cast<const float4*>(d + kRays);
      const float4 z = *reinterpret_cast<const float4*>(d + 2 * kRays);
      dx[0] = x.x; dx[1] = x.y; dx[2] = x.z; dx[3] = x.w;
      dy[0] = y.x; dy[1] = y.y; dy[2] = y.z; dy[3] = y.w;
      dz[0] = z.x; dz[1] = z.y; dz[2] = z.z; dz[3] = z.w;
    }
    __syncthreads();  // the item is staged

    // The walk: per ray the best (ts, queue position) so far. Positions only
    // grow within an item, so strict < keeps the first of equal t.
    float bt[RPT];
    unsigned bl[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      bt[i] = kBig;
      bl[i] = kNoCandidate;
    }
    const float4* node = &s_node[0][0];
#pragma unroll 4
    for (int j = 0; j < cnt; ++j, node += 2) {
      const float4 g = node[0];
      const float r2 = node[1].x;
      float tca[RPT], d2[RPT];
      // The warp goes on where some ray passes within the sphere's radius of
      // its centre: the smallest d2 is <= r^2.
      float near = kBig;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        tca[i] = dx[i] * g.x + dy[i] * g.y + dz[i] * g.z;
        d2[i] = g.w - tca[i] * tca[i];
        near = fminf(near, d2[i]);
      }
      if (__any_sync(kFullMask, near <= r2)) {
        const float4 h = node[1];
        const unsigned pos = (unsigned)(base + j);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float c1 = tca[i] - h.y;
          const bool lod_ok = (c1 < 0.0f) | (c1 * c1 < h.z - d2[i]);
          const bool ok = (tca[i] >= 0.0f) & lod_ok & (d2[i] <= h.x);
          const float ts = tca[i] - sqrtf(fmaxf(h.x - d2[i], 0.0f));
          const bool better = ok & (ts < bt[i]);
          bt[i] = better ? ts : bt[i];
          bl[i] = better ? pos : bl[i];
        }
      }
    }

    const int n_items = items_of(len);
    const bool finish =
        n_items == 1 ||
        merge_keys(keys + (size_t)row * kRays + f0, bt, bl,
                   arrived + row * kRowParts + part, n_items, &s_last);

    if (finish) {
      // The winner's node, once per ray; ts recomputed by the walk's own
      // expression (the same bits).
      float ot[RPT], oc[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        ot[i] = kBig;
        oc[i] = 0.0f;
        if (bl[i] != kNoCandidate) {
          const int n = (int)bl[i];
          const float cx = q[n], cy = q[qcap + n], cz = q[2 * qcap + n];
          const float cc = q[3 * qcap + n];
          const float code = q[4 * qcap + n];
          const float r2 = s_r2[level_of(code)];
          const float tca = dx[i] * cx + dy[i] * cy + dz[i] * cz;
          const float d2 = cc - tca * tca;
          ot[i] = tca - sqrtf(fmaxf(r2 - d2, 0.0f));
          oc[i] = code;
        }
      }
      float* op = out + (size_t)row * 2 * kRays + f0;
      *reinterpret_cast<float4*>(op) = make_float4(ot[0], ot[1], ot[2], ot[3]);
      *reinterpret_cast<float4*>(op + kRays) =
          make_float4(oc[0], oc[1], oc[2], oc[3]);
    }

    // Next item, drawn only now (see pairs_kernel.cu). The barriers keep the
    // staged item and s_info alive until every thread is done with them.
    if (tid == 0) s_next = atomicAdd(counter, 1);
    __syncthreads();
    work = s_next;
    __syncthreads();
  }
}

}  // namespace

// Plain C entry points: each enqueues on `stream` and returns the CUDA error
// code (0 on success). None synchronises or allocates; every pointer is
// device memory owned by the caller. `cap` is the widest level cap.

// Resident blocks of the node launch on the current device (> 0), or minus a
// CUDA error code: the wrapper sizes the panels by it, at every launch.
extern "C" int sf_trace_tiles_node_slots(void) {
  int card = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&card);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, card);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, expand_kernel, kNodeThreads, 0);
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  return sms * per_sm;
}

// Node launch: pool [n_bundles, 5, sum(caps)] (the queues), panels
// [n_blocks, 2, 9, cap], metrics [n_bundles, 8]; `counter` one int of
// scratch. n_blocks <= sf_trace_tiles_node_slots().
extern "C" int sf_trace_tiles_nodes(const float* planes, const float* root,
                                    const float* expand,
                                    const float* level_tab, float* pool,
                                    float* panels, int* metrics, int* counter,
                                    int n_bundles, int depth, int cap,
                                    int n_blocks, void* stream) {
  if (n_bundles <= 0) return 0;
  if (depth < 0 || depth >= kMaxLevels || n_blocks <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  expand_kernel<<<n_blocks, kNodeThreads, 0, s>>>(
      planes, root, expand, level_tab, pool, panels, metrics, counter,
      n_bundles, depth, cap);
  return (int)cudaGetLastError();
}

// Ray launch: dirs [n_bundles, 3, 1024] (16-byte aligned), the node launch's
// pool and metrics; out [n_bundles, 2, 1024]. Scratch: keys
// [n_bundles, 1024] 64-bit, work [8 * n_bundles + 8] int32; neither needs a
// value.
extern "C" int sf_trace_tiles_rays(const float* dirs, const float* pool,
                                   const float* level_tab, const int* metrics,
                                   float* out, unsigned long long* keys,
                                   int* work, int n_bundles, int depth,
                                   int cap, void* stream) {
  if (n_bundles <= 0) return 0;
  if (depth < 0 || depth >= kMaxLevels) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int4* rowinfo = reinterpret_cast<int4*>(work);
  int* arrived = work + 4 * (n_bundles + 1);
  int* counter = arrived + kRowParts * n_bundles;
  int grid = 0;
  const cudaError_t asked = walk_grid(&grid);
  if (asked != cudaSuccess) return (int)asked;
  const int rows_per_block = kPrologueThreads / 32;
  const int fill_blocks = (n_bundles + rows_per_block - 1) / rows_per_block;
  queue_prologue_kernel<<<1 + fill_blocks, kPrologueThreads, 0, s>>>(
      metrics, n_bundles, rowinfo, arrived, counter, keys, grid);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  walk_queue_kernel<<<grid, kItemThreads, 0, s>>>(
      dirs, pool, level_tab, rowinfo, arrived, counter, keys, out, n_bundles,
      depth, cap);
  return (int)cudaGetLastError();
}
