// Device code shared by the LK kernels (lk_iterate.cu, klt_track.cu).
//
// One warp works on one keypoint. The win x win patch is spread over the 32
// lanes (sample idx = lane + 32 * s, S slots per lane), the keypoint's
// integer-aligned ws x ws window lies in shared memory, and every scalar of
// the keypoint (position, masks, sums) is the same on all lanes, so the
// warp takes every branch together.
//
// Sampling is the hat-weight bilinear form of the JAX package
// (ov2slam_tpu/ops/klt.py::_sample_in_windows): weight max(0, 1 - |j - q|)
// on the two taps around q, zero outside the window (not clamped). The GN
// step is the one of ov2slam_tpu/ops/pallas_lk.py::_lk_kernel. Nothing
// here branches on a lane's own data: on the card a branch that lanes take
// differently, and the reconvergence it forces, costs more than the
// arithmetic it skips (PERF.md §6).

#pragma once

#include <cuda_runtime.h>

namespace lkc {

constexpr int kMaxSamplesPerLane = 8;   // win*win <= 256

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
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
// a = idx / win, column b = idx % win of the patch, at (b - r, a - r) from
// its centre, r = (win - 1) / 2; `n` of the S slots hold one (the rest
// pass idx >= win*win). Computed once per kernel, so the sampling loops
// need no integer division.
template <int S>
struct Lane {
  int ab[S];   // a << 8 | b
  int n;
  __device__ __forceinline__ int a(int s) const { return ab[s] >> 8; }
  __device__ __forceinline__ int b(int s) const { return ab[s] & 255; }
};

template <int S>
__device__ __forceinline__ Lane<S> lane_layout(int win, int lane) {
  Lane<S> ln;
  ln.n = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int idx = lane + 32 * s;
    const int a = idx / win;
    ln.ab[s] = a << 8 | (idx - a * win);
    if (idx < win * win) ln.n = s + 1;
  }
  return ln;
}

// A ws x ws float window in shared memory.
struct FloatWin {
  const float* p;
  int pitch;
  __device__ __forceinline__ float at(int r, int c) const {
    return p[r * pitch + c];
  }
};

// Bilinear value at window position (xq, yq) of the ws x ws window behind
// accessor w. Every tap is loaded, at an index clamped into the window, and
// a tap outside the window adds wx * 0 to its row, which leaves the row's
// bits as skipping the tap would: the lane's loads are all in flight at
// once and no lane branches.
template <typename Win>
__device__ __forceinline__ float hat_sample(const Win& w, int ws, float xq,
                                            float yq) {
  const float y0f = floorf(yq), x0f = floorf(xq);
  const int y0 = (int)y0f, x0 = (int)x0f;
  const float wy0 = fmaxf(0.f, 1.f - fabsf(y0f - yq));
  const float wy1 = fmaxf(0.f, 1.f - fabsf(y0f + 1.f - yq));
  const float wx0 = fmaxf(0.f, 1.f - fabsf(x0f - xq));
  const float wx1 = fmaxf(0.f, 1.f - fabsf(x0f + 1.f - xq));
  const bool iy0 = y0 >= 0 && y0 < ws, iy1 = y0 + 1 >= 0 && y0 + 1 < ws;
  const bool ix0 = x0 >= 0 && x0 < ws, ix1 = x0 + 1 >= 0 && x0 + 1 < ws;
  const int ya = clampi(y0, 0, ws - 1), yb = clampi(y0 + 1, 0, ws - 1);
  const int xa = clampi(x0, 0, ws - 1), xb = clampi(x0 + 1, 0, ws - 1);
  const float v00 = w.at(ya, xa), v01 = w.at(ya, xb);
  const float v10 = w.at(yb, xa), v11 = w.at(yb, xb);
  float row0 = 0.f, row1 = 0.f;
  row0 += wx0 * (iy0 && ix0 ? v00 : 0.f);
  row0 += wx1 * (iy0 && ix1 ? v01 : 0.f);
  row1 += wx0 * (iy1 && ix0 ? v10 : 0.f);
  row1 += wx1 * (iy1 && ix1 ? v11 : 0.f);
  return wy0 * row0 + wy1 * row1;
}

// This lane's samples of the win x win patch centred at window position
// (qx, qy) (r = (win - 1) / 2); zero in the slots past win*win.
template <int S, typename Win>
__device__ __forceinline__ void sample_patch(const Win& w, int ws,
                                             const Lane<S>& ln, float r,
                                             float qx, float qy,
                                             float (&out)[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    // more than 3 slots: one slot's taps in flight at a time, or the
    // registers run out
    if (S > 3) asm volatile("" ::: "memory");
    const float h = hat_sample(w, ws, qx + ((float)ln.b(s) - r),
                               qy + ((float)ln.a(s) - r));
    out[s] = s < ln.n ? h : 0.f;
  }
}

// Up to n_iters Gauss-Newton steps of one keypoint inside window W
// (origin ox, oy; centre cx, cy): b = sum (I - T) grad T,
// delta = -G^-1 b from gxx/gxy/gyy/inv_det. A slot past win*win holds zero
// template and gradients, so it adds d * 0, which leaves the sums as
// skipping it would. (px, py) and `act` are updated in place; a point stops
// when |delta|^2 < eps2 (converged) or when it drifts past `margin` from
// the centre (paused). An inactive point is frozen. Returns whether the
// point converged while active.
template <int S>
__device__ __forceinline__ bool gn_steps(
    const float* W, int ws, const Lane<S>& ln, float r, const float (&t)[S],
    const float (&gx)[S], const float (&gy)[S], float Gxx, float Gxy,
    float Gyy, float invd, float ox, float oy, float cx, float cy,
    int n_iters, float eps2, float margin, float& px, float& py, bool& act) {
  const FloatWin w{W, ws};
  bool conv_acc = false;
  for (int it = 0; it < n_iters && act; ++it) {
    const float qx = px - ox, qy = py - oy;
    float bx = 0.f, by = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float d = hat_sample(w, ws, qx + ((float)ln.b(s) - r),
                                 qy + ((float)ln.a(s) - r)) -
                      t[s];
      bx += d * gx[s];
      by += d * gy[s];
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
