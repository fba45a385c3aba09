// Device code shared by the LK kernels (lk_iterate.cu, klt_track.cu).
//
// One warp works on one keypoint. The win x win patch is spread over the 32
// lanes (sample idx = lane + 32 * s, at most kMaxSamplesPerLane per lane),
// the keypoint's integer-aligned ws x ws window lies in shared memory, and
// every scalar of the keypoint (position, masks, sums) is the same on all
// lanes, so the warp takes every branch together.
//
// Sampling is the hat-weight bilinear form of the JAX package
// (ov2slam_tpu/ops/klt.py::_sample_in_windows): weight max(0, 1 - |j - q|)
// on the two taps around q, zero outside the window (not clamped). The GN
// step is the one of ov2slam_tpu/ops/pallas_lk.py::_lk_kernel.

#pragma once

#include <cuda_runtime.h>

namespace lkc {

constexpr int kMaxSamplesPerLane = 8;   // win*win <= 256

// Bilinear value at window position (xq, yq) of the ws x ws window W.
__device__ __forceinline__ float hat_sample(const float* W, int ws, float xq,
                                            float yq) {
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
  return wy0 * row0 + wy1 * row1;
}

// Sum over the warp by a butterfly. Floating-point addition is
// commutative, so at every stage a lane and its partner add the same two
// values and get the same bits: all lanes end with one identical total and
// take the same exit.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// This lane's patch samples: sample idx = lane + 32 * s sits at row
// a = idx / win, column b = idx % win, i.e. (b - r, a - r) from the patch
// centre, r = (win - 1) / 2. `n` is how many of the lane's slots hold a
// sample (the rest pass idx >= win*win). Computed once per kernel, so the
// sampling loops need no integer division.
struct LaneSamples {
  float dx[kMaxSamplesPerLane], dy[kMaxSamplesPerLane];
  int n;
};

__device__ __forceinline__ LaneSamples lane_samples(int win, int lane) {
  LaneSamples ls;
  const int P = win * win;
  const float r = (win - 1) * 0.5f;
  ls.n = 0;
#pragma unroll
  for (int s = 0; s < kMaxSamplesPerLane; ++s) {
    const int idx = lane + 32 * s;
    const int a = idx / win, b = idx - a * win;
    ls.dx[s] = (float)b - r;
    ls.dy[s] = (float)a - r;
    if (idx < P) ls.n = s + 1;
  }
  return ls;
}

// This lane's samples of the win x win patch centred at window position
// (qx, qy); zero in the lane's slots past win*win.
__device__ __forceinline__ void sample_patch(
    const float* W, int ws, const LaneSamples& ls, float qx, float qy,
    float (&out)[kMaxSamplesPerLane]) {
#pragma unroll
  for (int s = 0; s < kMaxSamplesPerLane; ++s)
    out[s] = s < ls.n ? hat_sample(W, ws, qx + ls.dx[s], qy + ls.dy[s]) : 0.f;
}

// Up to n_iters Gauss-Newton steps of one keypoint inside window W
// (origin ox, oy; centre cx, cy): b = sum (I - T) grad T,
// delta = -G^-1 b from gxx/gxy/gyy/inv_det. (px, py) and `act` are updated
// in place; a point stops when |delta|^2 < eps2 (converged) or when it
// drifts past `margin` from the centre (paused). An inactive point is
// frozen. Returns whether the point converged while active.
__device__ __forceinline__ bool gn_steps(
    const float* W, int ws, const LaneSamples& ls,
    const float (&t)[kMaxSamplesPerLane], const float (&gx)[kMaxSamplesPerLane],
    const float (&gy)[kMaxSamplesPerLane], float Gxx, float Gxy, float Gyy,
    float invd, float ox, float oy, float cx, float cy, int n_iters,
    float eps2, float margin, float& px, float& py, bool& act) {
  bool conv_acc = false;
  for (int it = 0; it < n_iters && act; ++it) {
    const float qx = px - ox, qy = py - oy;
    float bx = 0.f, by = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSamplesPerLane; ++s) {
      if (s < ls.n) {
        const float d =
            hat_sample(W, ws, qx + ls.dx[s], qy + ls.dy[s]) - t[s];
        bx += d * gx[s];
        by += d * gy[s];
      }
    }
    bx = warp_sum(bx);
    by = warp_sum(by);
    const float dx = -(Gyy * bx - Gxy * by) * invd;
    const float dy = -(-Gxy * bx + Gxx * by) * invd;
    px += dx;
    py += dy;
    const bool conv = dx * dx + dy * dy < eps2;
    const float dev = fmaxf(fabsf(px - cx), fabsf(py - cy));
    conv_acc = conv_acc || conv;
    act = !conv && dev <= margin;
  }
  return conv_acc;
}

}  // namespace lkc
