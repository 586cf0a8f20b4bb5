// The post chain of a frame in three passes: SSAO into the AO target, the
// horizontal gated blur into one AO plane, and the vertical gated blur fused
// with the final composite into the RGB image (`ops/post.py`).
//
// Replaces no TPU kernel. The reference's post (`sphereflake_tpu/ops/post.py`)
// is plain XLA, which fuses each pass into a few loops. In eager PyTorch the
// same chain is ~1,430 launches a frame (texture taps as gathers with int64
// index planes, each f32 intermediate a whole plane in device memory), which
// at 1080p was the frame's largest layer after the G-buffer.
//
// Bound on this card: bytes. Each pass is a stencil over f32 planes with no
// matrix work: SSAO reads position and normal (24 B a pixel of its target)
// and writes AO (4 B); the horizontal blur reads the G-buffer and the AO
// target (28 B) and writes a plane (4 B); the vertical blur with the
// composite reads the G-buffer and that plane (28 B) and writes RGB (12 B).
// ~100 B a full-resolution pixel: 0.06 ms at 1080p, 0.25 ms at 4K at
// 3.35 TB/s. The design keeps everything between those reads and writes in
// registers: one thread an output pixel, 32x8 threads a block so that a
// warp's taps (all within the SSAO radius or the blur's 3.2 texels) fall on
// nearby rows held in L1 and L2; the 64x64 noise texture stays in cache; no
// fragcoord grid, index plane or intermediate is written. Every size, block
// origin, weight and offset is an argument; the scene's SSAO uniforms, the
// closest distance and the camera position are read where they lie (0-d or
// [3] device tensors), so a pass needs no host sync.
//
// Bit for bit equal to the plain version (`ops/post.py:_*_plain`): built
// without FMA contraction (-fmad=false) and without fast math, it repeats
// the plain version's f32 operations in their order: IEEE division and
// square root; floor, then the clamp, then the integer cast for each
// NEAREST tap; the LINEAR lerps as p00 * (1 - fx) + p01 * fx; the channel
// sums as (x0 + x1) + x2; the where-gates as selects. Constants that no f32
// holds exactly (0.707, 0.1, 1e-20, 1e30, the blur's weights and offsets)
// arrive as f32 arguments rounded once from the Python double, as torch
// rounds a wrapped scalar; the others are exact binary fractions.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

// The shader's four kernel directions (`post_ssao.glsl:15`).
__constant__ float kDirX[4] = {1.0f, -1.0f, 0.0f, 0.0f};
__constant__ float kDirY[4] = {0.0f, 0.0f, 1.0f, -1.0f};

// torch.clamp_min / clamp_max: NaN passes through.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

// `texture.py:_texel`: floor, clamp to [0, n - 1] in float, integer cast.
__device__ __forceinline__ int texel(float x, int n) {
  return static_cast<int>(fminf(fmaxf(floorf(x), 0.0f),
                                static_cast<float>(n - 1)));
}

// NEAREST + CLAMP_TO_EDGE: the texel index (row-major) of (u, v) in h x w.
__device__ __forceinline__ long long nearest(float u, float v, int h, int w) {
  const int xi = texel(u * static_cast<float>(w), w);
  const int yi = texel(v * static_cast<float>(h), h);
  return static_cast<long long>(yi) * w + xi;
}

// LINEAR + CLAMP_TO_EDGE on an [h, w] plane.
__device__ __forceinline__ float bilinear_clamp(const float* __restrict__ img,
                                                int h, int w, float u,
                                                float v) {
  const float x = u * static_cast<float>(w) - 0.5f;
  const float y = v * static_cast<float>(h) - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  const long long xa = texel(x0, w), xb = texel(x0 + 1.0f, w);
  const long long ya = texel(y0, h), yb = texel(y0 + 1.0f, h);
  const float p00 = img[ya * w + xa], p01 = img[ya * w + xb];
  const float p10 = img[yb * w + xa], p11 = img[yb * w + xb];
  const float top = p00 * (1.0f - fx) + p01 * fx;
  const float bot = p10 * (1.0f - fx) + p11 * fx;
  return top * (1.0f - fy) + bot * fy;
}

// Python's (and torch.remainder's) modulo of an int64 by n > 0.
__device__ __forceinline__ long long wrap(long long a, int n) {
  const long long r = a % n;
  return r < 0 ? r + n : r;
}

// LINEAR + REPEAT on the [h, w, 4] noise texture, channels 0 and 1.
__device__ __forceinline__ void bilinear_repeat2(const float* __restrict__ img,
                                                 int h, int w, float u,
                                                 float v, float& r0,
                                                 float& r1) {
  const float x = u * static_cast<float>(w) - 0.5f;
  const float y = v * static_cast<float>(h) - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  const long long xi = static_cast<long long>(x0);
  const long long yi = static_cast<long long>(y0);
  const long long xa = wrap(xi, w), xb = wrap(xi + 1, w);
  const long long ya = wrap(yi, h), yb = wrap(yi + 1, h);
  const float* p00 = img + (ya * w + xa) * 4;
  const float* p01 = img + (ya * w + xb) * 4;
  const float* p10 = img + (yb * w + xa) * 4;
  const float* p11 = img + (yb * w + xb) * 4;
  float r[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float top = p00[c] * (1.0f - fx) + p01[c] * fx;
    const float bot = p10[c] * (1.0f - fx) + p11[c] * fx;
    r[c] = top * (1.0f - fy) + bot * fy;
  }
  r0 = r[0];
  r1 = r[1];
}

struct Target {
  int out_h, out_w;  // the whole target, for the uv normalisation
  int y0, x0;        // the block's top-left pixel in the target
  int bh, bw;        // the block this launch writes
};

struct SSAOConsts {
  float c0707, c01, eps, rmax;
};

// `post_ssao.glsl` at one pixel of the AO target.
__global__ void __launch_bounds__(kBlockX * kBlockY) ssao_kernel(
    const float* __restrict__ pos, const float* __restrict__ nrm, int H,
    int W, const float* __restrict__ noise, int nh, int nw,
    const float* __restrict__ intensity_p, const float* __restrict__ scale_p,
    const float* __restrict__ bias_p, const float* __restrict__ multiplier,
    const float* __restrict__ distance, Target t, SSAOConsts k,
    float* __restrict__ out) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= t.bw || y >= t.bh) return;
  const float fb_w = static_cast<float>(t.out_w);
  const float fb_h = static_cast<float>(t.out_h);
  const float fx = (static_cast<float>(x) + 0.5f) + static_cast<float>(t.x0);
  const float fy = (static_cast<float>(y) + 0.5f) + static_cast<float>(t.y0);
  const float uv_x = fx / fb_w, uv_y = fy / fb_h;

  const long long c = nearest(uv_x, uv_y, H, W) * 3;
  const float p0 = pos[c], p1 = pos[c + 1], p2 = pos[c + 2];
  const float n0 = nrm[c], n1 = nrm[c + 1], n2 = nrm[c + 2];
  const bool sky = ((p0 * p0 + p1 * p1) + p2 * p2) == 0.0f;

  const float radius = *multiplier * *distance;
  const float rad =
      clamp_max(radius / sqrtf(clamp_min(fabsf(p2), k.eps)), k.rmax);

  float nz0, nz1;
  bilinear_repeat2(noise, nh, nw, uv_x * k.c01, uv_y * k.c01, nz0, nz1);
  nz0 = nz0 * 2.0f - 1.0f;
  nz1 = nz1 * 2.0f - 1.0f;
  const float nlen = sqrtf(clamp_min(nz0 * nz0 + nz1 * nz1, k.eps));
  nz0 = nz0 / nlen;
  nz1 = nz1 / nlen;

  const float bias = *bias_p, scale = *scale_p, intensity = *intensity_p;
  auto occlude = [&](float off_x, float off_y) -> float {
    const float su = (fx + off_x) / fb_w;
    const float sv = (fy + off_y) / fb_h;
    const long long s = nearest(su, sv, H, W) * 3;
    const float d0 = pos[s] - p0, d1 = pos[s + 1] - p1, d2 = pos[s + 2] - p2;
    const float dist2 = (d0 * d0 + d1 * d1) + d2 * d2;
    const float dist = sqrtf(clamp_min(dist2, k.eps));
    const float d = ((n0 * d0 + n1 * d1) + n2 * d2) / dist;
    float occ = clamp_min(d - bias, 0.0f);
    occ = occ * (1.0f / (dist2 * scale + 1.0f)) * intensity;
    return dist2 > 0.0f ? occ : 0.0f;
  };

  float ao = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // reflect(kernel[i], nz) * rad
    const float dot2 = (kDirX[i] * nz0 + kDirY[i] * nz1) * 2.0f;
    const float c1x = (kDirX[i] - dot2 * nz0) * rad;
    const float c1y = (kDirY[i] - dot2 * nz1) * rad;
    const float c2x = c1x * k.c0707 - c1y * k.c0707;
    const float c2y = c1x * k.c0707 + c1y * k.c0707;
    ao = ao + occlude(c1x * 0.25f, c1y * 0.25f);
    ao = ao + occlude(c1x * 0.75f, c1y * 0.75f);
    ao = ao + occlude(c2x * 0.5f, c2y * 0.5f);
    ao = ao + occlude(c2x, c2y);
  }
  ao = 1.0f - ao * 0.0625f;
  out[static_cast<long long>(y) * t.bw + x] = sky ? 0.0f : ao;
}

struct BlurConsts {
  float w0, w1, w2;  // centre, first and second tap pair
  float o1x, o1y, o2x, o2y;  // the tap pairs' uv offsets
};

// `post_ssao_blur.glsl` at one pixel; with COMPOSITE, `post_final.glsl` on
// its result at the same pixel (the composite reads the blurred AO NEAREST
// at the pixel's own texel) and the RGB image is written instead.
template <bool COMPOSITE>
__global__ void __launch_bounds__(kBlockX * kBlockY) blur_kernel(
    const float* __restrict__ src, int sh, int sw,
    const float* __restrict__ pos, const float* __restrict__ nrm, int H,
    int W, const float* __restrict__ nthr_p,
    const float* __restrict__ dthr_p, const float* __restrict__ cam,
    Target t, BlurConsts k, float* __restrict__ out) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= t.bw || y >= t.bh) return;
  const float fb_w = static_cast<float>(t.out_w);
  const float fb_h = static_cast<float>(t.out_h);
  const float fx = (static_cast<float>(x) + 0.5f) + static_cast<float>(t.x0);
  const float fy = (static_cast<float>(y) + 0.5f) + static_cast<float>(t.y0);
  const float uv_x = fx / fb_w, uv_y = fy / fb_h;

  const long long c = nearest(uv_x, uv_y, H, W) * 3;
  const float p0 = pos[c], p1 = pos[c + 1], p2 = pos[c + 2];
  const float n0 = nrm[c], n1 = nrm[c + 1], n2 = nrm[c + 2];
  const float nthr = *nthr_p, dthr = *dthr_p;

  float color = 0.0f, leftover = 0.0f;
  auto tap = [&](float ox, float oy, float wgt) {
    const float su = uv_x + ox, sv = uv_y + oy;
    const long long s = nearest(su, sv, H, W) * 3;
    const bool gate =
        ((n0 * nrm[s] + n1 * nrm[s + 1]) + n2 * nrm[s + 2]) >= nthr &&
        fabsf(pos[s + 2] - p2) >= dthr;
    const float v = bilinear_clamp(src, sh, sw, su, sv);
    color = color + (gate ? v * wgt : 0.0f);
    leftover = leftover + (gate ? 0.0f : wgt);
  };
  tap(k.o1x, k.o1y, k.w1);
  tap(-k.o1x, -k.o1y, k.w1);
  tap(k.o2x, k.o2y, k.w2);
  tap(-k.o2x, -k.o2y, k.w2);
  const float center = bilinear_clamp(src, sh, sw, uv_x, uv_y);
  const float ao = color + center * (leftover + k.w0);

  const long long o = static_cast<long long>(y) * t.bw + x;
  if (!COMPOSITE) {
    out[o] = ao;
    return;
  }
  const bool sky = ((p0 * p0 + p1 * p1) + p2 * p2) == 0.0f;
  const float p[3] = {p0, p1, p2};
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float col = ((p[ch] + cam[ch]) * 0.5f + 0.5f) * ao;
    out[o * 3 + ch] = sky ? 0.0f : col;
  }
}

dim3 grid_of(const Target& t) {
  return dim3((t.bw + kBlockX - 1) / kBlockX, (t.bh + kBlockY - 1) / kBlockY);
}

bool bad_target(const Target& t) {
  return t.bh < 1 || t.bw < 1 || t.y0 < 0 || t.x0 < 0 ||
         t.y0 + t.bh > t.out_h || t.x0 + t.bw > t.out_w ||
         (t.bh + kBlockY - 1) / kBlockY > 65535;
}

}  // namespace

// SSAO: out [bh, bw] = rows y0.. and columns x0.. of the [out_h, out_w] AO
// target of the [H, W, 3] G-buffer. The sample radius is the radius law's
// multiplier times the closest distance, rounded once as the eager multiply
// does.
extern "C" int sf_post_ssao(
    const float* pos, const float* nrm, const float* noise,
    const float* intensity, const float* scale, const float* bias,
    const float* multiplier, const float* distance, float* out, int H, int W,
    int nh, int nw, int out_h, int out_w, int y0, int x0, int bh, int bw,
    float c0707, float c01, float eps, float rmax, void* stream) {
  const Target t{out_h, out_w, y0, x0, bh, bw};
  if (bad_target(t) || H < 1 || W < 1 || nh < 1 || nw < 1) return 1;
  ssao_kernel<<<grid_of(t), dim3(kBlockX, kBlockY), 0,
                static_cast<cudaStream_t>(stream)>>>(
      pos, nrm, H, W, noise, nh, nw, intensity, scale, bias, multiplier,
      distance, t, SSAOConsts{c0707, c01, eps, rmax}, out);
  return cudaGetLastError();
}

// Blur: out [bh, bw] of the [out_h, out_w] target, LINEAR taps of the
// [sh, sw] source plane.
extern "C" int sf_post_blur(
    const float* src, const float* pos, const float* nrm, const float* nthr,
    const float* dthr, float* out, int sh, int sw, int H, int W, int out_h,
    int out_w, int y0, int x0, int bh, int bw, float w0, float w1, float w2,
    float o1x, float o1y, float o2x, float o2y, void* stream) {
  const Target t{out_h, out_w, y0, x0, bh, bw};
  if (bad_target(t) || H < 1 || W < 1 || sh < 1 || sw < 1) return 1;
  blur_kernel<false><<<grid_of(t), dim3(kBlockX, kBlockY), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      src, sh, sw, pos, nrm, H, W, nthr, dthr, nullptr, t,
      BlurConsts{w0, w1, w2, o1x, o1y, o2x, o2y}, out);
  return cudaGetLastError();
}

// Blur and composite: out [bh, bw, 3], the image's block; cam [3].
extern "C" int sf_post_blur_composite(
    const float* src, const float* pos, const float* nrm, const float* nthr,
    const float* dthr, const float* cam, float* out, int sh, int sw, int H,
    int W, int out_h, int out_w, int y0, int x0, int bh, int bw, float w0,
    float w1, float w2, float o1x, float o1y, float o2x, float o2y,
    void* stream) {
  const Target t{out_h, out_w, y0, x0, bh, bw};
  if (bad_target(t) || H < 1 || W < 1 || sh < 1 || sw < 1) return 1;
  blur_kernel<true><<<grid_of(t), dim3(kBlockX, kBlockY), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      src, sh, sw, pos, nrm, H, W, nthr, dthr, cam, t,
      BlurConsts{w0, w1, w2, o1x, o1y, o2x, o2y}, out);
  return cudaGetLastError();
}
