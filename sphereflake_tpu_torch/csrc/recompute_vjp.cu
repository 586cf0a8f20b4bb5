// The fit's backward of one band in one pass over its rays: the recompute
// of each ray's winner from its path code and the vector-Jacobian product of
// that recompute, with the block's leaf gradients reduced in a fixed order.
//
// Replaces no TPU kernel. The reference differentiates the same function by
// tracing `sphereflake_tpu/ops/pallas_traversal.py:resolve_codes_soa` and the
// shading tail of its binned backward under XLA, which fuses the graph. In
// eager PyTorch that graph is ~370 launches a level forward and twice that
// backward (one-hot masks, 108 selects of the template table a level, and
// their `select_backward`s), ~12,000 launches a band: the launches were the
// fit's step. This kernel computes the same straight-through gradient:
//
//   per ray i, hit (code lo >= 1 or hi >= 1), at level L from its code:
//     frame walk   R_0, t_0 = root; for k < L, digit d_k of the code:
//                  E = templates[d_k][:, :3], disp = templates[d_k][:, 3] *
//                  scale_k, scale_k = (1 + ratio) * radius0 * ratio^k,
//                  R_{k+1} = R_k E, t_{k+1} = R_k disp + t_k;  c = t_L;
//     distance     tca = d.c, d2 = |c|^2 - tca^2, q = rhit[L]^2 - d2,
//                  t = tca - sqrt(q) (0 for q <= 0, with zero gradient);
//     shading      p = d t, w = p - c, n = w / |w| (|w| := 1 where it is 0);
//   outputs (min_t, p, n), BIG and zeros where the ray missed.
//
// mode kVjp takes the 7 outputs' upstream gradients and writes the gradient
// of each ray's direction and, per block, partial sums of the gradients of
// root [3, 4], templates [9, 3, 4], each level's scale and each level's
// rhit. The frame walk's product is differentiated in closed form: with
// u_k = R_k^T g_c (forward: u_{k+1} = E_k^T u_k) and w_k the displacement
// of the winner from level k down (backward: w_L = 0, w_k = disp_k +
// E_k w_{k+1}), the gradient of E_k is u_k w_{k+1}^T, of disp_k is u_k, and
// of root is g_c w_0^T beside g_c itself. mode kForward writes the 7 outputs
// instead; the checks hold it bit for bit against the plain chain.
//
// Reductions are deterministic, with no float atomics: each thread adds its
// rays' terms into its own column of shared memory, in ray order; a block
// sums its 128 columns by a fixed tree and writes one partial row; the
// finish kernel sums the rows, lane by lane in row order and then by a fixed
// shuffle tree, and differentiates the scale chain (scale_k from ratio and
// radius0) on the sums. Two calls on the same inputs give the same bits.
//
// Bound on this card: bytes. A 4K band of 2,088,960 rays reads the
// direction, both code lanes and the 7 gradients (48 B a ray) and writes the
// direction's gradient (12 B): ~125 MB, ~37 us at 3.35 TB/s. Its ~1,500 f32
// operations a hit ray at depth 8 are ~3 GFLOP, ~45 us at 67 TFLOP/s. The
// per-thread columns (121 + 2 depth floats x 128 threads) hold ~70 KB of
// shared memory at depth 8, three blocks an SM; the depth is a template
// argument, so the level loops unroll and the per-level vectors stay in
// registers. The digit of every level comes from one packed decode of the
// two lanes (4 bits a digit), not from a division a level.
//
// Build without FMA contraction (-fmad=false) and without fast math: the
// plain chain it is held to runs unfused f32 multiplies and adds, IEEE
// division and square root.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;     // rays in flight a block
constexpr int kGridBlocks = 396;  // 3 blocks on each of the H100's 132 SMs
constexpr int kFinishThreads = 1024;
constexpr int kMaxDepth = 13;  // DEEP_MAX_DEPTH of the two-lane code
constexpr float kBig = 3.0e38f;

// Slots of a row of partial sums: root (12), templates (108), scale (D),
// rhit (D + 1).
constexpr int kRootSlot = 0;
constexpr int kTemplateSlot = 12;
constexpr int kScaleSlot = 120;
__host__ __device__ constexpr int rhit_slot(int depth) {
  return kScaleSlot + depth;
}
__host__ __device__ constexpr int n_slots(int depth) {
  return kScaleSlot + 2 * depth + 1;
}

enum Mode { kVjp = 0, kForward = 1 };

struct Rays {
  const float* dx;
  const float* dy;
  const float* dz;
  const float* lo;  // path code lanes, f32-exact integers
  const float* hi;  // read only at depth >= 7
};

struct Grads {  // upstream gradients of (min_t, px, py, pz, nx, ny, nz)
  const float* g[7];
};

struct Scene {
  const float* root;       // [3, 4]
  const float* templates;  // [9, 3, 4]
  const float* ratio;      // radius_ratio, 0-d
  const float* radius0;    // root_radius, 0-d
  const float* rhit;       // [depth + 1] radius of each level
};

__device__ __forceinline__ int pow9(int k) {
  int p = 1;
  for (int i = 0; i < k; ++i) p *= 9;
  return p;
}

// Level of the code (floor(log9) of hi * 9^7 + lo) and its base-9 digits,
// 4 bits each, the least significant first, as `resolve_codes_soa` counts
// and extracts them.
template <int D>
__device__ __forceinline__ int decode(int lo, int hi,
                                      unsigned long long* digits) {
  constexpr int kLoLevels = D < 7 ? D : 7;
  int level = 0;
#pragma unroll
  for (int k = 1; k <= kLoLevels; ++k) level += (hi == 0 && lo >= pow9(k));
  if (D >= 7) {
    level += (hi >= 1) ? 7 : 0;
#pragma unroll
    for (int k = 1; k <= D - 7; ++k) level += (hi >= pow9(k));
  }
  unsigned long long packed = 0ull;
  int x = lo;
#pragma unroll
  for (int m = 0; m < kLoLevels; ++m) {
    packed |= (unsigned long long)(x % 9) << (4 * m);
    x /= 9;
  }
  x = hi;
#pragma unroll
  for (int m = 7; m < D; ++m) {
    packed |= (unsigned long long)(x % 9) << (4 * m);
    x /= 9;
  }
  *digits = packed;
  return level;
}

// Digit of expansion step k (most significant first) of a level-L code.
__device__ __forceinline__ int digit(unsigned long long digits, int level,
                                     int k) {
  return (int)((digits >> (4 * (level - 1 - k))) & 15ull);
}

template <int D, int MODE>
__global__ void __launch_bounds__(kThreads)
recompute_kernel(Rays rays, Grads grads, Scene scene, float* __restrict__ gdx,
                 float* __restrict__ gdy, float* __restrict__ gdz,
                 float* __restrict__ partials, float* __restrict__ out, int n) {
  constexpr int kSlots = n_slots(D);
  extern __shared__ float smem[];
  float* tmpl = smem;        // [108] the template table
  float* acc = smem + 108;   // [kSlots][kThreads] one column a thread
  const int tid = threadIdx.x;
  for (int j = tid; j < 108; j += kThreads) tmpl[j] = scene.templates[j];
  if (MODE == kVjp) {
    for (int p = 0; p < kSlots; ++p) acc[p * kThreads + tid] = 0.0f;
  }
  __syncthreads();

  const float ratio = *scene.ratio;
  float scale[D > 0 ? D : 1];
  {
    float radius = *scene.radius0;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      scale[k] = (1.0f + ratio) * radius;
      radius = radius * ratio;
    }
  }
  float root[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) root[j] = scene.root[j];

  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + tid; i < n; i += stride) {
    const int lo = (int)rays.lo[i];
    const int hi = D >= 7 ? (int)rays.hi[i] : 0;
    const float dx = rays.dx[i], dy = rays.dy[i], dz = rays.dz[i];
    if (!(lo >= 1 || hi >= 1)) {
      if (MODE == kVjp) {
        gdx[i] = 0.0f;
        gdy[i] = 0.0f;
        gdz[i] = 0.0f;
      } else {
        out[i] = kBig;
        for (int r = 1; r < 7; ++r) out[(size_t)r * n + i] = 0.0f;
      }
      continue;
    }
    unsigned long long digits;
    const int level = decode<D>(lo, hi, &digits);

    // The frame walk: R (rows a = 0..2, columns 0..2), t.
    float R[9], t[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) R[3 * a + b] = root[4 * a + b];
      t[a] = root[4 * a + 3];
    }
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (k < level) {
        const float* e = tmpl + 12 * digit(digits, level, k);
        float nr[9], nt[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            nr[3 * a + b] = (R[3 * a] * e[b] + R[3 * a + 1] * e[4 + b]) +
                            R[3 * a + 2] * e[8 + b];
          }
          nt[a] = ((R[3 * a] * (e[3] * scale[k]) +
                    R[3 * a + 1] * (e[7] * scale[k])) +
                   R[3 * a + 2] * (e[11] * scale[k])) +
                  t[a];
        }
#pragma unroll
        for (int j = 0; j < 9; ++j) R[j] = nr[j];
#pragma unroll
        for (int a = 0; a < 3; ++a) t[a] = nt[a];
      }
    }
    const float cx = t[0], cy = t[1], cz = t[2];
    const float rh = scene.rhit[level];
    const float tca = (dx * cx + dy * cy) + dz * cz;
    const float d2 = ((cx * cx + cy * cy) + cz * cz) - tca * tca;
    const float q = rh * rh - d2;
    const float s = q > 0.0f ? sqrtf(q) : 0.0f;
    const float tt = tca - s;
    const float px = dx * tt, py = dy * tt, pz = dz * tt;
    const float wx = px - cx, wy = py - cy, wz = pz - cz;
    const float m = (wx * wx + wy * wy) + wz * wz;
    const float nn0 = m > 0.0f ? sqrtf(m) : 0.0f;
    const float nn = nn0 > 0.0f ? nn0 : 1.0f;
    if (MODE == kForward) {
      out[i] = tt;
      out[(size_t)1 * n + i] = px;
      out[(size_t)2 * n + i] = py;
      out[(size_t)3 * n + i] = pz;
      out[(size_t)4 * n + i] = wx / nn;
      out[(size_t)5 * n + i] = wy / nn;
      out[(size_t)6 * n + i] = wz / nn;
      continue;
    }

    // The shading tail backward, in the order autograd takes it.
    const float g_t = grads.g[0][i];
    const float g_px = grads.g[1][i], g_py = grads.g[2][i],
                g_pz = grads.g[3][i];
    const float g_nx = grads.g[4][i], g_ny = grads.g[5][i],
                g_nz = grads.g[6][i];
    // n = w / nn
    const float nn2 = nn * nn;
    float g_wx = g_nx / nn, g_wy = g_ny / nn, g_wz = g_nz / nn;
    const float g_nn =
        ((-g_nx * wx) / nn2 + (-g_ny * wy) / nn2) + (-g_nz * wz) / nn2;
    // nn = nn0 > 0 ? nn0 : 1;  nn0 = m > 0 ? sqrt(m) : 0
    const float g_m = (nn0 > 0.0f && m > 0.0f) ? g_nn / (2.0f * nn0) : 0.0f;
    g_wx = g_wx + (g_m * wx + g_m * wx);
    g_wy = g_wy + (g_m * wy + g_m * wy);
    g_wz = g_wz + (g_m * wz + g_m * wz);
    // w = p - c;  p = d t
    const float gp_x = g_px + g_wx, gp_y = g_py + g_wy, gp_z = g_pz + g_wz;
    float g_cx = -g_wx, g_cy = -g_wy, g_cz = -g_wz;
    float g_dx = gp_x * tt, g_dy = gp_y * tt, g_dz = gp_z * tt;
    const float g_tt = g_t + ((gp_x * dx + gp_y * dy) + gp_z * dz);
    // t = tca - s;  s = q > 0 ? sqrt(q) : 0
    const float g_q = q > 0.0f ? (-g_tt) / (2.0f * s) : 0.0f;
    // q = rh^2 - d2;  d2 = |c|^2 - tca^2
    const float g_rh = g_q * rh + g_q * rh;
    const float g_d2 = -g_q;
    const float g_tca = g_tt + ((-g_d2) * tca + (-g_d2) * tca);
    g_cx = g_cx + (g_d2 * cx + g_d2 * cx);
    g_cy = g_cy + (g_d2 * cy + g_d2 * cy);
    g_cz = g_cz + (g_d2 * cz + g_d2 * cz);
    // tca = d.c
    g_dx = g_dx + g_tca * cx;
    g_dy = g_dy + g_tca * cy;
    g_dz = g_dz + g_tca * cz;
    g_cx = g_cx + g_tca * dx;
    g_cy = g_cy + g_tca * dy;
    g_cz = g_cz + g_tca * dz;
    gdx[i] = g_dx;
    gdy[i] = g_dy;
    gdz[i] = g_dz;

    // The frame walk backward. u_k = R_k^T g_c, forward.
    float u[D > 0 ? D : 1][3];
    float v0 = (root[0] * g_cx + root[4] * g_cy) + root[8] * g_cz;
    float v1 = (root[1] * g_cx + root[5] * g_cy) + root[9] * g_cz;
    float v2 = (root[2] * g_cx + root[6] * g_cy) + root[10] * g_cz;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (k < level) {
        u[k][0] = v0;
        u[k][1] = v1;
        u[k][2] = v2;
        const float* e = tmpl + 12 * digit(digits, level, k);
        const float n0 = (e[0] * v0 + e[4] * v1) + e[8] * v2;
        const float n1 = (e[1] * v0 + e[5] * v1) + e[9] * v2;
        const float n2 = (e[2] * v0 + e[6] * v1) + e[10] * v2;
        v0 = n0;
        v1 = n1;
        v2 = n2;
      }
    }
    // w_k backward, adding each level's terms into this thread's column.
    float w0 = 0.0f, w1 = 0.0f, w2 = 0.0f;
#pragma unroll
    for (int k = D - 1; k >= 0; --k) {
      if (k < level) {
        const int d = digit(digits, level, k);
        const float* e = tmpl + 12 * d;
        float* col = acc + (kTemplateSlot + 12 * d) * kThreads + tid;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          col[(4 * a + 0) * kThreads] += u[k][a] * w0;
          col[(4 * a + 1) * kThreads] += u[k][a] * w1;
          col[(4 * a + 2) * kThreads] += u[k][a] * w2;
          col[(4 * a + 3) * kThreads] += u[k][a] * scale[k];
        }
        acc[(kScaleSlot + k) * kThreads + tid] +=
            (u[k][0] * e[3] + u[k][1] * e[7]) + u[k][2] * e[11];
        const float n0 = e[3] * scale[k] + ((e[0] * w0 + e[1] * w1) + e[2] * w2);
        const float n1 = e[7] * scale[k] + ((e[4] * w0 + e[5] * w1) + e[6] * w2);
        const float n2 =
            e[11] * scale[k] + ((e[8] * w0 + e[9] * w1) + e[10] * w2);
        w0 = n0;
        w1 = n1;
        w2 = n2;
      }
    }
    const float gc[3] = {g_cx, g_cy, g_cz};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float* col = acc + (kRootSlot + 4 * a) * kThreads + tid;
      col[0] += gc[a] * w0;
      col[kThreads] += gc[a] * w1;
      col[2 * kThreads] += gc[a] * w2;
      col[3 * kThreads] += gc[a];
    }
    acc[(rhit_slot(D) + level) * kThreads + tid] += g_rh;
  }
  if (MODE == kForward) return;

  // The block's columns by a fixed tree; one partial row, slot-major.
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (tid < half) {
      for (int p = 0; p < kSlots; ++p) {
        acc[p * kThreads + tid] += acc[p * kThreads + tid + half];
      }
    }
    __syncthreads();
  }
  for (int p = tid; p < kSlots; p += kThreads) {
    partials[(size_t)p * gridDim.x + blockIdx.x] = acc[p * kThreads];
  }
}

// One block: out[p] = the sum of partials[p, :] (lane l adds rows l, l + 32,
// ... in order, then a shuffle tree), then the scale chain differentiated:
// out[slots] = d/d ratio, out[slots + 1] = d/d radius0 through the scales.
template <int D>
__global__ void __launch_bounds__(kFinishThreads)
finish_kernel(const float* __restrict__ partials, int rows,
              const float* __restrict__ ratio_p,
              const float* __restrict__ radius0_p, float* __restrict__ out) {
  constexpr int kSlots = n_slots(D);
  __shared__ float sums[n_slots(kMaxDepth)];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int p = warp; p < kSlots; p += kFinishThreads / 32) {
    float s = 0.0f;
    for (int b = lane; b < rows; b += 32) s += partials[(size_t)p * rows + b];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, off);
    }
    if (lane == 0) sums[p] = s;
  }
  __syncthreads();
  if (threadIdx.x < kSlots) out[threadIdx.x] = sums[threadIdx.x];
  if (threadIdx.x == 0) {
    const float ratio = *ratio_p;
    float radius[D > 0 ? D : 1];
    float r = *radius0_p;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      radius[k] = r;
      r = r * ratio;
    }
    float g_ratio = 0.0f, g_next = 0.0f;  // g_next: d/d radius_{k+1}
#pragma unroll
    for (int k = D - 1; k >= 0; --k) {
      const float g = sums[kScaleSlot + k];
      g_ratio = g_ratio + (g * radius[k] + g_next * radius[k]);
      g_next = g * (1.0f + ratio) + g_next * ratio;
    }
    out[kSlots] = g_ratio;
    out[kSlots + 1] = g_next;
  }
}

int grid_blocks(int n) {
  const int blocks = (n + kThreads - 1) / kThreads;
  return blocks < kGridBlocks ? blocks : kGridBlocks;
}

template <int D>
int launch_vjp(Rays rays, Grads grads, Scene scene, float* gdx, float* gdy,
               float* gdz, float* partials, float* out, int n,
               cudaStream_t s) {
  const int blocks = grid_blocks(n);
  const size_t smem = (108 + (size_t)n_slots(D) * kThreads) * sizeof(float);
  if (blocks > 0) {
    cudaFuncSetAttribute(recompute_kernel<D, kVjp>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    recompute_kernel<D, kVjp><<<blocks, kThreads, smem, s>>>(
        rays, grads, scene, gdx, gdy, gdz, partials, nullptr, n);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  finish_kernel<D><<<1, kFinishThreads, 0, s>>>(partials, blocks, scene.ratio,
                                                scene.radius0, out);
  return (int)cudaGetLastError();
}

template <int D>
int launch_forward(Rays rays, Scene scene, float* out, int n,
                   cudaStream_t s) {
  const int blocks = grid_blocks(n);
  if (blocks > 0) {
    recompute_kernel<D, kForward><<<blocks, kThreads, 108 * sizeof(float), s>>>(
        rays, Grads{}, scene, nullptr, nullptr, nullptr, nullptr, out, n);
  }
  return (int)cudaGetLastError();
}

using VjpFn = int (*)(Rays, Grads, Scene, float*, float*, float*, float*,
                      float*, int, cudaStream_t);
using ForwardFn = int (*)(Rays, Scene, float*, int, cudaStream_t);

template <int... Ds>
struct Table {
  static constexpr VjpFn vjp[] = {&launch_vjp<Ds>...};
  static constexpr ForwardFn forward[] = {&launch_forward<Ds>...};
};
using Depths = Table<0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13>;

}  // namespace

// Backward: partials [slots, min(ceil(n / 128), 396)] is scratch, with
// slots = 121 + 2 depth; per-ray gdx / gdy / gdz [n]; out [slots + 2] =
// [root (12), templates (108),
// scale (depth), rhit (depth + 1), d ratio, d radius0 (both through the
// scales)]. Returns cudaGetLastError() (0 on success); 1 for a depth
// outside 0..13. Neither mode synchronises or allocates.
extern "C" int sf_recompute_vjp(
    const float* dx, const float* dy, const float* dz, const float* lo,
    const float* hi, const float* g_min_t, const float* g_px,
    const float* g_py, const float* g_pz, const float* g_nx,
    const float* g_ny, const float* g_nz, const float* root,
    const float* templates, const float* ratio, const float* radius0,
    const float* rhit, float* gdx, float* gdy, float* gdz, float* partials,
    float* out, int n, int depth, void* stream) {
  if (depth < 0 || depth > kMaxDepth) return 1;
  const Rays rays{dx, dy, dz, lo, hi};
  const Grads grads{{g_min_t, g_px, g_py, g_pz, g_nx, g_ny, g_nz}};
  const Scene scene{root, templates, ratio, radius0, rhit};
  return Depths::vjp[depth](rays, grads, scene, gdx, gdy, gdz, partials, out,
                            n, static_cast<cudaStream_t>(stream));
}

// Forward: out [7, n] = (min_t, px, py, pz, nx, ny, nz).
extern "C" int sf_recompute_forward(
    const float* dx, const float* dy, const float* dz, const float* lo,
    const float* hi, const float* root, const float* templates,
    const float* ratio, const float* radius0, const float* rhit, float* out,
    int n, int depth, void* stream) {
  if (depth < 0 || depth > kMaxDepth) return 1;
  const Rays rays{dx, dy, dz, lo, hi};
  const Scene scene{root, templates, ratio, radius0, rhit};
  return Depths::forward[depth](rays, scene, out, n,
                                static_cast<cudaStream_t>(stream));
}
