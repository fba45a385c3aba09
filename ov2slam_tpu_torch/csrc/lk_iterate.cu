// Lucas-Kanade Gauss-Newton iteration loop for a batch of keypoints.
//
// Replaces ov2slam_tpu/ops/pallas_lk.py::_lk_kernel (body :37, wrapper
// lk_iterate :125, pl.pallas_call :175), the only Pallas kernel of the JAX
// package, with the same contract: up to n_iters GN steps per keypoint,
// bilinear sampling of a win x win patch inside the keypoint's
// integer-aligned ws x ws window (hat weights, zero outside the window),
// b = sum (I - T) grad T, step delta = -G^-1 b from the precomputed
// gxx/gxy/gyy/inv_det; a point converges when |delta|^2 < eps^2 and pauses
// when it drifts more than `margin` from the window centre. Inactive points
// are frozen. The slice's tracking does not call this kernel (klt_track.cu
// runs the whole forward-backward KLT in one launch); it stays as the
// direct counterpart of the Pallas contract.
//
// What bounds it on the card: the launch and the latency of one point's
// chain, not bytes or FLOPs. At N = 192 a call moves ~0.3 MB (0.085 us of
// HBM time) and its arithmetic is as small, while one warp tracks one
// keypoint through up to n_iters dependent steps, and the call takes as
// long as its slowest warp. The first version staged the window with
// plain loads, then loaded the template, then ran per-sample steps, each a
// chain of patch sampling (8 slots per lane) and two 5-stage butterflies.
// Its N = 1 chain (scripts/torch_klt_latency.py: the slowest point of the
// N = 192 case alone, NVIDIA H100 80GB HBM3 at 700 W) took 0.59 us per GN
// step with a 2.2 us intercept, 5.2 us per N = 192 call at n_iters 10,
// over a launch floor (an empty kernel) of 1.0-1.1 us. This design takes
// 0.11-0.12 us per step with a 1.9 us intercept, 2.9 us per call
// (PERF.md §6).
//
// The design:
//
// (a) A GN step that reads cached correlations. All win x win samples of
// the patch sit at integer offsets d from the point's cell (cx, cy) =
// floor(q - r), so they share one fractional part (fx, fy) and four
// bilinear weights w_jk that sum to 1, and
//
//     b_x = sum_d (I(d) - T(d)) gx(d) = sum_jk w_jk C^x(cx + j, cy + k),
//     C^x(s) = sum_d (W[s + d] - T(d)) gx(d),  W zero outside the window,
//
// and the same for b_y with gy. A refresh computes the 32 correlations
// C^{x,y} at the 4 x 4 integer shifts around the cell, which cover its 3 x 3
// block of cells: each lane sums its samples' share of all 32, and one
// transposing reduction (5 stages, 31 shuffles) leaves correlation i on
// lane i. A step whose cell lies in the block fetches its 2 x 4 corner
// correlations from fixed lanes by __shfl_sync and blends them: no patch
// sampling and no butterfly on the chain. A step that leaves the block
// refreshes first; the first step of a call is a refresh too (a
// per-sample first step with the refresh issued beside it measured 0.4 us
// slower per call, PERF.md §6).
// tests/test_torch_klt_cell.py holds this arithmetic and this policy to
// the per-sample step of lk_iterate_plain.
//
// (b) The window off the chain. Each warp issues its window first, as one
// bulk copy completing on an mbarrier (cp.async.bulk, where ws*ws*4 bytes
// are a multiple of 16 and the window 16-byte aligned: ws = 20, the
// presets') or as 4-byte cp.async copies (any other shape), then loads its
// template, gradients and scalars and lays out its lanes while the window
// is in flight. (4-byte copies on ws = 20 measured 0.15 us slower.)
//
// (c) No local memory: every per-lane array is indexed only in unrolled
// loops, the samples per lane are a template parameter (3 up to win = 9,
// 8 up to win = 16), and ptxas reports 0 stack and spill bytes.
//
// (d) Four warps to a block: one and two measured the same at n_iters 10
// and 0.1-0.4 us slower at n_iters 1 (PERF.md §6).
//
// Everything is float32: no TF32, no fast-math, no tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lk_common.cuh"

namespace {

using lkc::Lane;

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// ---- staging ---------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// into shared memory, completing on the mbarrier `bar`. Issued by one lane.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait for the first phase of `bar` to complete (the bulk copy landed).
__device__ __forceinline__ void bulk_wait(uint64_t* bar) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// ---- the cell-block step ---------------------------------------------------

// Stage OFF of the transposing reduction: lanes with bit OFF set keep the
// upper half of their OFF * 2 values and send the lower half to the partner
// lane, which keeps the lower half; each adds what it receives. After the
// stages 16, 8, 4, 2, 1, c[0] on lane i holds the warp's sum of value i.
template <int OFF>
__device__ __forceinline__ void transpose_stage(float (&c)[32], int lane) {
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int j = 0; j < OFF; ++j) {
    const float send = upper ? c[j] : c[j + OFF];
    const float keep = upper ? c[j + OFF] : c[j];
    c[j] = keep + __shfl_xor_sync(kFull, send, OFF);
  }
  if constexpr (OFF > 1) transpose_stage<OFF / 2>(c, lane);
}

// The refresh: correlation `lane` of the 32 C^{x,y} at the shifts
// (bx0 + i, by0 + k), i, k in 0..3, lane = g * 16 + k * 4 + i (g = 0: x,
// 1: y), summed over the warp. off[s] is slot s's sample offset a * ws + b
// from the patch's top-left tap. Where the block's footprint (rows by0 to
// by0 + win + 2, columns bx0 to bx0 + win + 2) lies inside the window, as
// it does but for a point at the high end of its margin, a tap is read at
// that offset plus the shift; elsewhere it is loaded at an index clamped
// into the window and replaced by 0 outside it. Where both apply they read the same
// taps. A slot past win*win (off 0) holds zero template and gradients and
// adds d * 0.
template <int S>
__device__ __forceinline__ float refresh(const float* W, int ws, int win,
                                         const Lane<S>& ln,
                                         const int (&off)[S],
                                         const float (&t)[S],
                                         const float (&gx)[S],
                                         const float (&gy)[S], int bx0,
                                         int by0, int lane) {
  float c[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) c[i] = 0.f;
  if (by0 >= 0 && bx0 >= 0 && by0 + win + 2 < ws && bx0 + win + 2 < ws) {
    const float* block = W + by0 * ws + bx0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float* row = block + off[s] + k * ws;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float d = row[i] - t[s];
          c[k * 4 + i] += d * gx[s];
          c[16 + k * 4 + i] += d * gy[s];
        }
      }
    }
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      // the tap's row at shift k and column at shift i, for k, i = m
      int roff[4], col[4];
      bool rin[4], cin[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int row = by0 + m + ln.a(s), cl = bx0 + m + ln.b(s);
        rin[m] = row >= 0 && row < ws;
        cin[m] = cl >= 0 && cl < ws;
        roff[m] = lkc::clampi(row, 0, ws - 1) * ws;
        col[m] = lkc::clampi(cl, 0, ws - 1);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = W[roff[k] + col[i]];
          const float d = (rin[k] && cin[i] ? v : 0.f) - t[s];
          c[k * 4 + i] += d * gx[s];
          c[16 + k * 4 + i] += d * gy[s];
        }
      }
    }
  }
  transpose_stage<16>(c, lane);
  return c[0];
}

// Up to n_iters GN steps of one keypoint inside window W (origin ox, oy;
// centre cx, cy) by the cell-block step, in gn_steps' order of tests:
// (px, py) and `act` are updated in place; returns whether the point
// converged while active. An inactive point is frozen.
template <int S>
__device__ __forceinline__ bool cell_steps(
    const float* W, int ws, int win, const Lane<S>& ln, const int (&off)[S],
    const float (&t)[S], const float (&gx)[S], const float (&gy)[S],
    float Gxx, float Gxy, float Gyy, float invd, float ox, float oy,
    float cx, float cy, int n_iters, float eps2, float margin, float& px,
    float& py, bool& act, int lane) {
  const float r = (win - 1) * 0.5f;
  bool conv_acc = false, cached = false;
  int bx0 = 0, by0 = 0;
  float corr = 0.f;
  for (int it = 0; it < n_iters && act; ++it) {
    const float ax = (px - ox) - r, ay = (py - oy) - r;
    const float fcx = floorf(ax), fcy = floorf(ay);
    const int cellx = (int)fcx, celly = (int)fcy;
    // the warp takes this branch together: every lane holds the point
    if (!cached || cellx - bx0 < 0 || cellx - bx0 > 2 || celly - by0 < 0 ||
        celly - by0 > 2) {
      bx0 = cellx - 1;
      by0 = celly - 1;
      corr = refresh(W, ws, win, ln, off, t, gx, gy, bx0, by0, lane);
      cached = true;
    }
    const int i00 = (celly - by0) * 4 + (cellx - bx0);
    const float x00 = __shfl_sync(kFull, corr, i00);
    const float x01 = __shfl_sync(kFull, corr, i00 + 1);
    const float x10 = __shfl_sync(kFull, corr, i00 + 4);
    const float x11 = __shfl_sync(kFull, corr, i00 + 5);
    const float y00 = __shfl_sync(kFull, corr, 16 + i00);
    const float y01 = __shfl_sync(kFull, corr, 16 + i00 + 1);
    const float y10 = __shfl_sync(kFull, corr, 16 + i00 + 4);
    const float y11 = __shfl_sync(kFull, corr, 16 + i00 + 5);
    const float fx = ax - fcx, fy = ay - fcy;
    const float bx = (1.f - fy) * ((1.f - fx) * x00 + fx * x01) +
                     fy * ((1.f - fx) * x10 + fx * x11);
    const float by = (1.f - fy) * ((1.f - fx) * y00 + fx * y01) +
                     fy * ((1.f - fx) * y10 + fx * y11);
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

// ---- the kernel ------------------------------------------------------------

// Per-warp shared memory: an 8-byte mbarrier padded to 16 bytes, then the
// ws x ws float window (16-byte aligned).
__host__ __device__ constexpr int warp_bytes(int ws) {
  return 16 + (ws * ws * 4 + 15) / 16 * 16;
}

template <int S>
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
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + warp;
  if (n >= N) return;   // whole warp leaves together; no block barrier below

  // the window first: one bulk copy where its shape allows, else 4-byte
  // copies, in flight while the rest is loaded
  uint64_t* bar = (uint64_t*)(smem + warp * warp_bytes(ws));
  float* W = (float*)(smem + warp * warp_bytes(ws) + 16);
  const float* src = nwin + (size_t)n * ws * ws;
  const unsigned bytes = (unsigned)(ws * ws * 4);
  const bool bulk = bytes % 16 == 0 && ((uintptr_t)src & 15) == 0;
  if (bulk) {
    if (lane == 0) bulk_load(W, src, bytes, bar);
  } else {
    for (int i = lane; i < ws * ws; i += 32) cp_async4(W + i, src + i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

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
  float px = pts[2 * n], py = pts[2 * n + 1];
  bool act = active[n] != 0;
  const float Gxx = gxx[n], Gxy = gxy[n], Gyy = gyy[n], invd = inv_det[n];
  const float ox = (float)origins[2 * n], oy = (float)origins[2 * n + 1];
  const float cx = ctr[2 * n], cy = ctr[2 * n + 1];
  const Lane<S> ln = lkc::lane_layout<S>(win, lane);
  int off[S];
#pragma unroll
  for (int s = 0; s < S; ++s) off[s] = s < ln.n ? ln.a(s) * ws + ln.b(s) : 0;

  if (bulk) {
    __syncwarp();   // the mbarrier's init precedes every lane's wait
    bulk_wait(bar);
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
  }

  const bool conv_acc =
      cell_steps(W, ws, win, ln, off, t_, gx_, gy_, Gxx, Gxy, Gyy, invd, ox,
                 oy, cx, cy, n_iters, eps2, margin, px, py, act, lane);

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
  if (win < 1 || win * win > 32 * lkc::kMaxSamplesPerLane)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kWarpsPerBlock * warp_bytes(ws);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
#define LK_LAUNCH(S)                                                         \
  lk_iterate_kernel<S><<<blocks, kWarpsPerBlock * 32, smem,                  \
                         (cudaStream_t)stream>>>(                            \
      (const float*)nwin, (const float*)tmpl, (const float*)gx,              \
      (const float*)gy, (const float*)gxx, (const float*)gxy,                \
      (const float*)gyy, (const float*)inv_det, (const int32_t*)origins,     \
      (const float*)ctr, (const float*)pts, (const uint8_t*)active,          \
      (float*)out_pts, (uint8_t*)out_active, (uint8_t*)out_conv, N, ws, win, \
      n_iters, eps * eps, margin)
  if (win * win <= 32 * 3)
    LK_LAUNCH(3);
  else
    LK_LAUNCH(8);
#undef LK_LAUNCH
  return (int)cudaGetLastError();
}
