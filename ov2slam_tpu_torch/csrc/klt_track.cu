// Forward-backward pyramidal KLT for a batch of keypoints, in one launch.
//
// Computes ov2slam_tpu_torch/ops/klt.py::fb_klt_tracking_plain (the port of
// ov2slam_tpu/ops/klt.py::fb_klt_tracking), whose GN loop is the JAX
// package's Pallas kernel ov2slam_tpu/ops/pallas_lk.py::_lk_kernel. Per
// keypoint, coarse to fine over the pyramid levels:
//   - template window at origin = clamp(rint(p) - ws/2) in the previous
//     image and its Scharr gradients; G, min-eigenvalue / win^2 gating,
//     inv_det with the |det| > 1e-12 guard, in-bounds test;
//     track = valid & well_cond & in_bounds0 (valid is the caller's mask at
//     every level);
//   - n_chunks chunks at the top level and one below it, each re-staging the
//     next image's window at the re-centred origin and running
//     ceil(max_iters / n_chunks) GN steps; a point paused at the margin
//     resumes at the next chunk, a converged one stays converged;
//   - ok = track & in_bounds1, status = AND over the levels, guess * 2
//     between levels; the level-0 error sampled in the last chunk's window;
// then good = status & err < max_err, the backward level-0 track from the
// forward points seeded at prev_pts with min(n_chunks, 2) chunks, and the
// forward-backward distance gate.
//
// What bounds it on the card: latency, not bytes or FLOPs. At the slice's
// N = 192, 3 levels and win = 9 the pixels its patches read come to under
// 1 MB (about 0.3 us of HBM time) and its arithmetic to about as much at
// the f32 peak, while each keypoint runs up to ~150 dependent GN steps.
// The design answers that by doing the
// whole per-keypoint computation in one warp with no device-memory round
// trip between steps: the kernel reads the pyramid levels in place (all of
// them fit in the 50 MB L2), stages each window into the warp's shared
// memory with row-coalesced cp.async copies (origins are arbitrary, so no
// 16-byte vector loads), issuing a level's three template planes and its
// first next-image window together so they cost one round trip, keeps the
// template and its gradients in registers, and reduces with warp
// shuffles. A level that cannot track the point and samples no error is
// skipped. The per-chunk path (lk_iterate.cu inside the PyTorch glue of
// fb_klt_tracking_plain) takes ~580 eager launches of glue around its 8
// kernel launches per call; this is one launch.
//
// Plane types. The front end stores its pyramids and gradient pyramids in
// float16, as the JAX package does (frontend.PYR_DT), and the kernel reads
// them as they are: it is instantiated for float and for __half planes,
// and the table's elem_bytes picks one at launch. Only the staging
// differs. Everything after it is float32: the windows in shared memory,
// the samples, the sums and the GN steps, as the JAX package casts each
// gathered window to float32. cp.async copies 4, 8 or 16 bytes from a
// source aligned to that size, and a 2-byte element at an odd column, or
// in a row of a plane with an odd row stride (the KITTI rig's levels are
// 1241, 621 and 311 wide), is not 4-byte aligned. So a float16 window is
// not copied by cp.async: each lane loads its elements through the
// read-only path (ld.global.nc, __ldg) into registers, all the windows of
// one staging at once so that they cost about one round trip, and stores
// them converted by __half2float into the float32 window. That takes any
// origin and any row stride and keeps shared memory at the float32
// windows' 4 warps x 4 x ws^2 x 4 B (25.6 KB at win = 9). Staging aligned
// 4-byte words and dropping a leading half by parity would need a float16
// copy of each window beside the float32 one; TMA would need 16-byte row
// strides, which these widths do not have.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lk_common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxLevels = 8;
constexpr int kMaxSmemBytes = 48 * 1024;

// One row-major image plane in device memory (float or __half elements,
// the table's elem_bytes).
struct Plane {
  const void* data;
  int h, w, stride;   // rows, columns, elements between rows
};

// The pyramids the kernel reads, passed by value. Levels 0..nlevels of the
// previous image, its gradients and the next image; level 0 of the next
// image's gradients (the backward pass's template).
struct LevelTable {
  Plane prev_img[kMaxLevels];
  Plane prev_gx[kMaxLevels];
  Plane prev_gy[kMaxLevels];
  Plane next_img[kMaxLevels];
  Plane next_gx0;
  Plane next_gy0;
  int elem_bytes;     // 4: float planes, 2: __half planes
};

// Start copying the ws x ws window at (ox, oy) of a plane into shared
// memory: 4-byte cp.async copies, lanes along rows (window origins are
// arbitrary, so wider vector copies would be misaligned). Nothing waits
// here; wait_staged() does.
__device__ __forceinline__ void stage_window(float* dst, const Plane& p,
                                             int ox, int oy, int ws,
                                             int lane) {
  const float* src = (const float*)p.data + (size_t)oy * p.stride + ox;
  int r = lane / ws, c = lane - r * ws;
  for (int i = lane; i < ws * ws; i += 32) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + i);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src + (size_t)r * p.stride + c)
                 : "memory");
    c += 32;
    while (c >= ws) {
      c -= ws;
      ++r;
    }
  }
}

// Wait for this lane's copies, then make every lane's visible to the warp.
__device__ __forceinline__ void wait_staged() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

// NW ws x ws windows of __half planes into float32 windows in shared
// memory (window w at (ox[w], oy[w]) of p[w] into dst[w]): each round
// loads 32 / NW elements per lane of every window into registers, then
// stores them converted; at ws = 20 the four windows of a level's first
// staging take two rounds, a single window one. Returns when the warp's
// stores are visible to the warp.
template <int NW>
__device__ __forceinline__ void stage_half(float* const (&dst)[NW],
                                           const Plane (&p)[NW],
                                           const int (&ox)[NW],
                                           const int (&oy)[NW], int ws,
                                           int lane) {
  constexpr int kSlots = 32 / NW;
  const int wsz = ws * ws;
  for (int base = lane; base < wsz; base += 32 * kSlots) {
    float v[NW][kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int i = base + 32 * s;
      const int r = i / ws, c = i - r * ws;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const __half* src = (const __half*)p[w].data +
                            (size_t)(oy[w] + r) * p[w].stride + ox[w] + c;
        v[w][s] = i < wsz ? __half2float(__ldg(src)) : 0.f;
      }
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int i = base + 32 * s;
      if (i < wsz) {
#pragma unroll
        for (int w = 0; w < NW; ++w) dst[w][i] = v[w][s];
      }
    }
  }
  __syncwarp();
}

// Staging by plane type: the three template planes at (ox0, oy0) and the
// first next-image window at (ox1, oy1) in one round trip (`level`), or
// one next-image window (`window`). Both return with the windows visible
// to the warp.
template <typename T>
struct Stage;

template <>
struct Stage<float> {
  static __device__ __forceinline__ void level(
      float* sm_t, float* sm_n, const Plane& img0, const Plane& gx0,
      const Plane& gy0, const Plane& img1, int ox0, int oy0, int ox1,
      int oy1, int ws, int lane) {
    const int wsz = ws * ws;
    stage_window(sm_t, img0, ox0, oy0, ws, lane);
    stage_window(sm_t + wsz, gx0, ox0, oy0, ws, lane);
    stage_window(sm_t + 2 * wsz, gy0, ox0, oy0, ws, lane);
    stage_window(sm_n, img1, ox1, oy1, ws, lane);
    wait_staged();
  }
  static __device__ __forceinline__ void window(float* sm_n,
                                                const Plane& img1, int ox1,
                                                int oy1, int ws, int lane) {
    stage_window(sm_n, img1, ox1, oy1, ws, lane);
    wait_staged();
  }
};

template <>
struct Stage<__half> {
  static __device__ __forceinline__ void level(
      float* sm_t, float* sm_n, const Plane& img0, const Plane& gx0,
      const Plane& gy0, const Plane& img1, int ox0, int oy0, int ox1,
      int oy1, int ws, int lane) {
    const int wsz = ws * ws;
    float* const dst[4] = {sm_t, sm_t + wsz, sm_t + 2 * wsz, sm_n};
    const Plane p[4] = {img0, gx0, gy0, img1};
    const int ox[4] = {ox0, ox0, ox0, ox1}, oy[4] = {oy0, oy0, oy0, oy1};
    stage_half<4>(dst, p, ox, oy, ws, lane);
  }
  static __device__ __forceinline__ void window(float* sm_n,
                                                const Plane& img1, int ox1,
                                                int oy1, int ws, int lane) {
    float* const dst[1] = {sm_n};
    const Plane p[1] = {img1};
    const int ox[1] = {ox1}, oy[1] = {oy1};
    stage_half<1>(dst, p, ox, oy, ws, lane);
  }
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// One pyramid level of windowed LK for one keypoint
// (ops/klt.py::_track_level): template at (tx, ty) in img0/gx0/gy0, GN from
// (px, py) in img1, planes of element type T. Updates (px, py); returns
// ok = track & in_bounds1. With `want_err`, *err receives mean |I - tmpl| in
// the last chunk's window.
template <typename T>
__device__ bool track_level(float* sm_t, float* sm_n,
                            const lkc::LaneSamples& ls, const Plane& img0,
                            const Plane& gx0, const Plane& gy0,
                            const Plane& img1, float tx, float ty, float& px,
                            float& py, bool valid, int win, int max_iters,
                            int n_chunks, float eps2, float min_eig_th,
                            bool want_err, float* err, int lane) {
  const int ws = win + 11;
  const int hw = ws / 2;
  const int H = img0.h, W = img0.w;
  const float half = (win - 1) * 0.5f;
  const float margin = (ws - win) * 0.5f - 1.5f;
  const bool in0 = tx >= half && tx < W - half && ty >= half && ty < H - half;
  // an untracked point does not move; without an error to sample, its
  // level is decided here
  if (!(valid && in0) && !want_err) return false;
  const int ox0 = clampi(__float2int_rn(tx) - hw, 0, W - ws);
  const int oy0 = clampi(__float2int_rn(ty) - hw, 0, H - ws);
  int ox1 = clampi(__float2int_rn(px) - hw, 0, W - ws);
  int oy1 = clampi(__float2int_rn(py) - hw, 0, H - ws);
  const int wsz = ws * ws;

  // the template planes and the first chunk's window, in one round trip
  __syncwarp();   // the warp is done reading the previous windows
  Stage<T>::level(sm_t, sm_n, img0, gx0, gy0, img1, ox0, oy0, ox1, oy1, ws,
                  lane);
  float t[lkc::kMaxSamplesPerLane], gx[lkc::kMaxSamplesPerLane],
      gy[lkc::kMaxSamplesPerLane];
  const float qx0 = tx - (float)ox0, qy0 = ty - (float)oy0;
  lkc::sample_patch(sm_t, ws, ls, qx0, qy0, t);
  lkc::sample_patch(sm_t + wsz, ws, ls, qx0, qy0, gx);
  lkc::sample_patch(sm_t + 2 * wsz, ws, ls, qx0, qy0, gy);

  float sxx = 0.f, sxy = 0.f, syy = 0.f;
#pragma unroll
  for (int s = 0; s < lkc::kMaxSamplesPerLane; ++s) {
    sxx += gx[s] * gx[s];
    sxy += gx[s] * gy[s];
    syy += gy[s] * gy[s];
  }
  const float Gxx = lkc::warp_sum(sxx), Gxy = lkc::warp_sum(sxy),
              Gyy = lkc::warp_sum(syy);
  const float det = Gxx * Gyy - Gxy * Gxy;
  const float tr = Gxx + Gyy;
  const float min_eig = (tr - sqrtf(fmaxf(tr * tr - 4.f * det, 0.f))) * 0.5f;
  const bool well_cond = min_eig / (float)(win * win) > min_eig_th;
  const float invd = fabsf(det) > 1e-12f ? 1.f / det : 0.f;
  const bool track = valid && well_cond && in0;

  const int iters = max(1, (max_iters + n_chunks - 1) / n_chunks);
  bool act = track, conv_total = false;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const bool last = ci + 1 == n_chunks;
    if (ci > 0) {
      ox1 = clampi(__float2int_rn(px) - hw, 0, W - ws);
      oy1 = clampi(__float2int_rn(py) - hw, 0, H - ws);
      // a frozen point needs its window only for the error
      if (!act && !(want_err && last)) continue;
      __syncwarp();
      Stage<T>::window(sm_n, img1, ox1, oy1, ws, lane);
    }
    conv_total |= lkc::gn_steps(
        sm_n, ws, ls, t, gx, gy, Gxx, Gxy, Gyy, invd, (float)ox1, (float)oy1,
        (float)ox1 + (float)hw, (float)oy1 + (float)hw, iters, eps2, margin,
        px, py, act);
    if (!last) act = track && !conv_total;
  }
  const bool in1 = px >= half && px < W - half && py >= half && py < H - half;

  if (want_err) {
    float cur[lkc::kMaxSamplesPerLane];
    lkc::sample_patch(sm_n, ws, ls, px - (float)ox1, py - (float)oy1, cur);
    float e = 0.f;
#pragma unroll
    for (int s = 0; s < lkc::kMaxSamplesPerLane; ++s)
      e += fabsf(cur[s] - t[s]);   // zero in the slots past win*win
    *err = lkc::warp_sum(e) / (float)(win * win);
  }
  return track && in1;
}

template <typename T>
__global__ void klt_track_kernel(
    const LevelTable tbl,
    const float* __restrict__ prev_pts,   // (N, 2) level-0 positions
    const float* __restrict__ prior,      // (N, 2) forward seeds
    const uint8_t* __restrict__ valid,    // (N,)
    float* __restrict__ out_pts,          // (N, 2)
    uint8_t* __restrict__ out_status,     // (N,)
    float* __restrict__ out_err,          // (N,)
    int N, int nlevels, int win, int max_iters, int n_chunks, float eps2,
    float max_fb_dist, float max_err, float min_eig_th) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarpsPerBlock + warp;
  if (n >= N) return;   // whole warp leaves together; no block barrier below

  const int ws = win + 11;
  float* sm_t = smem + (size_t)warp * 4 * ws * ws;   // 3 template windows
  float* sm_n = sm_t + 3 * ws * ws;                  // next-image window
  const float x0 = prev_pts[2 * n], y0 = prev_pts[2 * n + 1];
  const bool v = valid[n] != 0;
  const lkc::LaneSamples ls = lkc::lane_samples(win, lane);

  const float top = (float)(1 << nlevels);
  float px = prior[2 * n] / top, py = prior[2 * n + 1] / top;
  bool status = true;
  float err = 0.f;
  for (int l = nlevels; l >= 0; --l) {
    const float s = (float)(1 << l);
    status = track_level<T>(sm_t, sm_n, ls, tbl.prev_img[l], tbl.prev_gx[l],
                         tbl.prev_gy[l], tbl.next_img[l], x0 / s, y0 / s, px,
                         py, v, win, max_iters, l == nlevels ? n_chunks : 1,
                         eps2, min_eig_th, l == 0, &err, lane) &&
             status;
    if (l > 0) {
      px *= 2.f;
      py *= 2.f;
    }
  }

  bool ok = false;
  if (status && err < max_err) {   // good: the backward track decides
    float bx = x0, by = y0;
    const bool okb = track_level<T>(
        sm_t, sm_n, ls, tbl.next_img[0], tbl.next_gx0, tbl.next_gy0,
        tbl.prev_img[0], px, py, bx, by, true, win, max_iters,
        min(n_chunks, 2), eps2, min_eig_th, false, nullptr, lane);
    const float dx = bx - x0, dy = by - y0;
    ok = okb && sqrtf(dx * dx + dy * dy) <= max_fb_dist;
  }

  if (lane == 0) {
    out_pts[2 * n] = px;
    out_pts[2 * n + 1] = py;
    out_status[n] = ok ? 1 : 0;
    out_err[n] = err;
  }
}

}  // namespace

extern "C" int klt_track_table_bytes() { return (int)sizeof(LevelTable); }

extern "C" int klt_track_max_levels() { return kMaxLevels; }

// Host launcher: `table` points to a LevelTable in host memory, copied into
// the kernel's parameters; its elem_bytes picks the float or the __half
// instantiation. Returns a cudaError_t (0 on success).
extern "C" int klt_track_launch(
    const void* table, const void* prev_pts, const void* prior,
    const void* valid, void* out_pts, void* out_status, void* out_err,
    int N, int nlevels, int win, int max_iters, int n_chunks, float eps2,
    float max_fb_dist, float max_err, float min_eig_th, void* stream) {
  if (N <= 0) return 0;
  if (nlevels < 0 || nlevels >= kMaxLevels || win < 1 ||
      win * win > 32 * lkc::kMaxSamplesPerLane || n_chunks < 1)
    return (int)cudaErrorInvalidValue;
  const int ws = win + 11;
  const size_t smem = (size_t)kWarpsPerBlock * 4 * ws * ws * sizeof(float);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  const LevelTable& tbl = *(const LevelTable*)table;
  const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  decltype(&klt_track_kernel<float>) kernel = nullptr;
  if (tbl.elem_bytes == 4) kernel = klt_track_kernel<float>;
  if (tbl.elem_bytes == 2) kernel = klt_track_kernel<__half>;
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  kernel<<<blocks, kWarpsPerBlock * 32, smem, (cudaStream_t)stream>>>(
      tbl, (const float*)prev_pts, (const float*)prior,
      (const uint8_t*)valid, (float*)out_pts, (uint8_t*)out_status,
      (float*)out_err, N, nlevels, win, max_iters, n_chunks, eps2,
      max_fb_dist, max_err, min_eig_th);
  return (int)cudaGetLastError();
}
