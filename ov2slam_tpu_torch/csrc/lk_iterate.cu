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
// kernel's block-wide early exit (an inactive point never changes). The
// sampling and the GN step live in lk_common.cuh. The slice's tracking no
// longer calls this kernel: klt_track.cu runs the whole forward-backward
// KLT in one launch. This one stays as the direct counterpart of the
// Pallas contract.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lk_common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

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

  constexpr int S = lkc::kMaxSamplesPerLane;
  float t_[S], gx_[S], gy_[S];
  const int P = win * win;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int idx = lane + 32 * s;
    const bool ok = idx < P;
    t_[s] = ok ? tmpl[(size_t)n * P + idx] : 0.f;
    gx_[s] = ok ? gx[(size_t)n * P + idx] : 0.f;
    gy_[s] = ok ? gy[(size_t)n * P + idx] : 0.f;
  }
  __syncwarp();

  float px = pts[2 * n], py = pts[2 * n + 1];
  bool act = active[n] != 0;
  const bool conv_acc = lkc::gn_steps(
      W, ws, lkc::lane_layout<S>(win, lane), (win - 1) * 0.5f, t_, gx_, gy_,
      gxx[n], gxy[n], gyy[n], inv_det[n], (float)origins[2 * n],
      (float)origins[2 * n + 1], ctr[2 * n], ctr[2 * n + 1], n_iters, eps2,
      margin, px, py, act);

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
  if (win * win > 32 * lkc::kMaxSamplesPerLane)
    return (int)cudaErrorInvalidValue;
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
