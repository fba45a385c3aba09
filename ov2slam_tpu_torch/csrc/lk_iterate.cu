// Lucas-Kanade Gauss-Newton iteration loop for a batch of keypoints.
//
// Replaces ov2slam_tpu/ops/pallas_lk.py::_lk_kernel (launched by
// lk_iterate), the only Pallas kernel of the JAX package, with the same
// contract: up to n_iters GN steps per keypoint, bilinear sampling of a
// win x win patch inside the keypoint's integer-aligned ws x ws window (hat
// weights, zero outside the window), b = sum (I - T) grad T, step
// delta = -G^-1 b from the precomputed gxx/gxy/gyy/inv_det; a point
// converges when |delta|^2 < eps^2 and pauses when it drifts more than
// `margin` from the window centre. Inactive points are frozen.
//
// What bounds it on the card: latency and launch, not bytes or FLOPs. The
// slice calls it with N = 192 keypoints (a few kB of window and template
// per point, ~0.5 MB in all) and ~10-30 dependent iterations of ~1k FLOPs
// per point. The design answers that with one warp per keypoint: the
// window is staged once in shared memory, the template rows stay in
// registers (81 samples spread over the 32 lanes), bx/by are reduced by
// warp shuffles, every lane computes the 2x2 step, and a warp leaves its
// loop as soon as its point is inactive — the per-point form of the Pallas
// kernel's block-wide early exit (an inactive point never changes). No
// tensor cores, TMA or fusion of the window extraction yet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxSamplesPerLane = 8;   // win*win <= 256

__global__ void lk_iterate_kernel(
    const float* __restrict__ nwin,     // (N, ws, ws)
    const float* __restrict__ tmpl,     // (N, win*win)
    const float* __restrict__ gx,       // (N, win*win)
    const float* __restrict__ gy,       // (N, win*win)
    const float* __restrict__ gxx,      // (N,)
    const float* __restrict__ gxy,
    const float* __restrict__ gyy,
    const float* __restrict__ inv_det,
    const int32_t* __restrict__ origins,  // (N, 2) x, y
    const float* __restrict__ ctr,        // (N, 2)
    const float* __restrict__ pts,        // (N, 2)
    const uint8_t* __restrict__ active,   // (N,)
    float* __restrict__ out_pts,          // (N, 2)
    uint8_t* __restrict__ out_active,     // (N,)
    uint8_t* __restrict__ out_conv,       // (N,)
    int N, int ws, int win, int n_iters, float eps2, float margin) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarpsPerBlock + warp;
  if (n >= N) return;   // whole warp leaves together; no block barrier below

  float* W = smem + warp * ws * ws;
  const float* src = nwin + (size_t)n * ws * ws;
  for (int i = lane; i < ws * ws; i += 32) W[i] = src[i];

  const int P = win * win;
  float t_[kMaxSamplesPerLane], gx_[kMaxSamplesPerLane], gy_[kMaxSamplesPerLane];
#pragma unroll
  for (int s = 0; s < kMaxSamplesPerLane; ++s) {
    const int idx = lane + 32 * s;
    const bool ok = idx < P;
    t_[s] = ok ? tmpl[(size_t)n * P + idx] : 0.f;
    gx_[s] = ok ? gx[(size_t)n * P + idx] : 0.f;
    gy_[s] = ok ? gy[(size_t)n * P + idx] : 0.f;
  }
  __syncwarp();

  const float Gxx = gxx[n], Gxy = gxy[n], Gyy = gyy[n], invd = inv_det[n];
  const float ox = (float)origins[2 * n], oy = (float)origins[2 * n + 1];
  const float cx = ctr[2 * n], cy = ctr[2 * n + 1];
  const float r = (win - 1) * 0.5f;
  float px = pts[2 * n], py = pts[2 * n + 1];
  bool act = active[n] != 0;
  bool conv_acc = false;

  for (int it = 0; it < n_iters && act; ++it) {
    const float qx = px - ox, qy = py - oy;
    float bx = 0.f, by = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSamplesPerLane; ++s) {
      const int idx = lane + 32 * s;
      if (idx < P) {
        const int a = idx / win, b = idx - a * win;
        // hat weights max(0, 1 - |j - q|) at the two taps around q
        const float yq = qy + ((float)a - r);
        const float xq = qx + ((float)b - r);
        const float y0f = floorf(yq), x0f = floorf(xq);
        const int y0 = (int)y0f, x0 = (int)x0f;
        const float wy0 = fmaxf(0.f, 1.f - fabsf(y0f - yq));
        const float wy1 = fmaxf(0.f, 1.f - fabsf(y0f + 1.f - yq));
        const float wx0 = fmaxf(0.f, 1.f - fabsf(x0f - xq));
        const float wx1 = fmaxf(0.f, 1.f - fabsf(x0f + 1.f - xq));
        const bool iy0 = y0 >= 0 && y0 < ws, iy1 = y0 + 1 >= 0 && y0 + 1 < ws;
        const bool ix0 = x0 >= 0 && x0 < ws, ix1 = x0 + 1 >= 0 && x0 + 1 < ws;
        float row0 = 0.f, row1 = 0.f;
        if (iy0) {
          if (ix0) row0 += wx0 * W[y0 * ws + x0];
          if (ix1) row0 += wx1 * W[y0 * ws + x0 + 1];
        }
        if (iy1) {
          if (ix0) row1 += wx0 * W[(y0 + 1) * ws + x0];
          if (ix1) row1 += wx1 * W[(y0 + 1) * ws + x0 + 1];
        }
        const float d = wy0 * row0 + wy1 * row1 - t_[s];
        bx += d * gx_[s];
        by += d * gy_[s];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      bx += __shfl_xor_sync(0xffffffffu, bx, off);
      by += __shfl_xor_sync(0xffffffffu, by, off);
    }
    // one value for the whole warp, so every lane takes the same exit
    bx = __shfl_sync(0xffffffffu, bx, 0);
    by = __shfl_sync(0xffffffffu, by, 0);
    const float dx = -(Gyy * bx - Gxy * by) * invd;
    const float dy = -(-Gxy * bx + Gxx * by) * invd;
    px += dx;
    py += dy;
    const bool conv = dx * dx + dy * dy < eps2;
    const float dev = fmaxf(fabsf(px - cx), fabsf(py - cy));
    conv_acc = conv_acc || conv;
    act = !conv && dev <= margin;
  }

  if (lane == 0) {
    out_pts[2 * n] = px;
    out_pts[2 * n + 1] = py;
    out_active[n] = act ? 1 : 0;
    out_conv[n] = conv_acc ? 1 : 0;
  }
}

}  // namespace

extern "C" int lk_iterate_launch(
    const void* nwin, const void* tmpl, const void* gx, const void* gy,
    const void* gxx, const void* gxy, const void* gyy, const void* inv_det,
    const void* origins, const void* ctr, const void* pts, const void* active,
    void* out_pts, void* out_active, void* out_conv,
    int N, int ws, int win, int n_iters, float eps, float margin,
    void* stream) {
  if (N <= 0) return 0;
  if (win * win > 32 * kMaxSamplesPerLane) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kWarpsPerBlock * ws * ws * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  lk_iterate_kernel<<<blocks, kWarpsPerBlock * 32, smem,
                      (cudaStream_t)stream>>>(
      (const float*)nwin, (const float*)tmpl, (const float*)gx,
      (const float*)gy, (const float*)gxx, (const float*)gxy,
      (const float*)gyy, (const float*)inv_det, (const int32_t*)origins,
      (const float*)ctr, (const float*)pts, (const uint8_t*)active,
      (float*)out_pts, (uint8_t*)out_active, (uint8_t*)out_conv,
      N, ws, win, n_iters, eps * eps, margin);
  return (int)cudaGetLastError();
}
