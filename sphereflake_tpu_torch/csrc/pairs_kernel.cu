// Fused raygen + binned ray tests + G-buffer shading, one launch per frame.
//
// Replaces the reference package's TPU kernel
// `sphereflake_tpu/ops/binned.py:make_pairs_kernel` in its fused full-frame
// mode (wrapper `trace_pairs_fused_soa`).
//
// What it computes, per 1024-ray screen tile t (tile_w x tile_h pixels):
//   - raygen from the 16-float camera pack [tl(3), ex(3), ey(3), origin(3),
//     x_off, y_off, frame_w, frame_h]: u = (px + x_off) / frame_w,
//     v = (py + y_off) / frame_h, d = normalize((tl + (ex*u + ey*v)) - origin);
//   - a walk of the tile's segment pairs[:, starts[t] : starts[t] + lens[t]]
//     of the fat-row pair table (rows cx, cy, cz, rc = r^2 - |c|^2,
//     code_lo[, code_hi], lodr = lod^2 * r, rc4 = 4 r^2 - |c|^2), keeping the
//     nearest self-hit that passes the LOD gate;
//   - the G-buffer epilogue: rows (min_t, code_lo[, code_hi], pos3, nrm3) in
//     in-tile order row * tile_w + col, zeros at sky, min_t = BIG at sky.
//
// Bound on this card: operations, not bytes. A 1080p depth-6 frame moves
// about 67 MB of output and 4 MB of pair table (about 21 us at 3.35 TB/s) but
// runs about 1.2e8 ray-sphere tests of about 25 f32 operations each (about
// 3 GFLOP: about 45 us at the 67 TFLOP/s non-tensor f32 peak). The work is a
// per-thread loop of data-dependent length with compares and selects, so the
// design keeps the loop free of global memory traffic.
//
// Design: one block per tile, one thread per ray (1024 threads, which caps a
// thread at 64 registers: one accumulator set, not the eight chains of the TPU
// body). The block reads its own starts[t] / lens[t], stages the segment
// through shared memory in CHUNK-pair pieces with coalesced loads, and every
// thread then reads each pair by shared-memory broadcast. Outputs are written
// once, coalesced (neighbouring rays, neighbouring addresses).
//
// Tie rule. The TPU body sends candidate k of the segment to accumulator chain
// k mod 8 (a later candidate wins a chain only on strict <) and merges chains
// 0..7 on strict <, so among candidates with the same minimal t the winner is
// the one with the smallest (k mod 8, k). The single accumulator here applies
// that order directly: replace when ts < bt, or ts == bt and
// (k & 7) < (bk & 7).
//
// Build without FMA contraction (-fmad=false) and without fast math: the plain
// torch version of this function runs unfused f32 multiplies and adds, and a
// contracted tca / disc moves tangent grazes (disc ~ 0) between hit and miss.

#include <cuda_runtime.h>

namespace {

constexpr int kRays = 1024;   // rays (threads) per tile
constexpr int kChunk = 256;   // pairs staged through shared memory at a time
constexpr float kBig = 3.0e38f;

template <bool DEEP>
__global__ void __launch_bounds__(kRays)
trace_pairs_fused_kernel(const float* __restrict__ cam,
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
  bool hit = blo >= 1.0f;
  if constexpr (DEEP) hit = hit || (bhi >= 1.0f);
  const float t0 = hit ? bt : 0.0f;
  const float px = dx * t0, py = dy * t0, pz = dz * t0;
  const float wx = px - bcx, wy = py - bcy, wz = pz - bcz;
  float nn = sqrtf(fmaxf(wx * wx + wy * wy + wz * wz, 0.0f));
  nn = nn > 0.0f ? nn : 1.0f;
  const float hf = hit ? 1.0f : 0.0f;

  float* o = out + (size_t)t * NOUT * kRays + flat;
  int c = 0;
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

}  // namespace

// Plain C entry point: enqueues one launch on `stream` and returns
// cudaGetLastError() (0 on success). It does not synchronise and allocates
// nothing; every pointer is device memory owned by the caller.
extern "C" int sf_trace_pairs_fused(const float* cam, const float* pairs,
                                    const int* starts, const int* lens,
                                    float* out, int* metrics, int n_tiles,
                                    int pair_stride, int tile_w_log2,
                                    int tile_h, int tiles_x, int deep,
                                    void* stream) {
  if (n_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (deep) {
    trace_pairs_fused_kernel<true><<<n_tiles, kRays, 0, s>>>(
        cam, pairs, starts, lens, out, metrics, pair_stride, tile_w_log2,
        tile_h, tiles_x);
  } else {
    trace_pairs_fused_kernel<false><<<n_tiles, kRays, 0, s>>>(
        cam, pairs, starts, lens, out, metrics, pair_stride, tile_w_log2,
        tile_h, tiles_x);
  }
  return static_cast<int>(cudaGetLastError());
}
