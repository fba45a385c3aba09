// Forward-backward pyramidal KLT for a batch of keypoints, in one launch.
//
// Computes ov2slam_tpu_torch/ops/klt.py::fb_klt_tracking_plain (the port of
// ov2slam_tpu/ops/klt.py::fb_klt_tracking), whose GN loop is the JAX
// package's Pallas kernel ov2slam_tpu/ops/pallas_lk.py::_lk_kernel (body
// :37, wrapper lk_iterate :125, pl.pallas_call :175). Per keypoint, coarse
// to fine over the pyramid levels:
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
// What bounds it on the card: latency. At the slice's N = 192, 3 levels and
// win = 9 the pixels its patches read come to under 1 MB (about 0.3 us of
// HBM time) and its arithmetic to about as much at the f32 peak, while one
// keypoint runs up to ~60 dependent GN steps and ~13 window round trips.
// One warp tracks one keypoint, and the call takes as long as its slowest
// warp's chain. The N = 1 chain (scripts/torch_klt_latency.py: the N = 192
// tracking call's slowest point alone, NVIDIA H100 80GB HBM3 at 700 W) of
// the first version took 0.815 us per GN step with a 32.8 us intercept
// (round trips, template set-up, the launch): 82 us per call on float16
// planes. Clock counters read inside that chain showed where its cycles
// went, and the design answers each; the same chain now takes 0.29 us per
// step with a 16 us intercept, 34 us per call on float16 planes:
//
// (a) No branches where lanes differ. A lane's taps are all loaded at
// indices clamped into the window and weighted by zero where the
// per-sample form skips them, which leaves every sum's bits as they were;
// staging loops step their row and column without data-dependent loops.
// Divergent branches and the reconvergence they force cost more than the
// arithmetic.
//
// (b) Round trips off the chain. A forward template depends only on
// prev_pts / 2^l, so level l-1's three template windows are staged while
// level l iterates, into the buffer that level l's template left once it
// was sampled into registers; a level's start then issues its next-image
// window, samples its template and computes G and the gates while that
// window is in flight. Templates are staged by cp.async: float planes
// element by element (4 bytes), float16 planes as aligned 4-byte words into
// a float16 buffer with a per-row parity (a 2-byte element at an odd
// column, or in a plane with an odd row stride - the KITTI rig's levels are
// 1241, 621 and 311 wide - is not 4-byte aligned; a row's last word may
// hold one element past it, inside the same allocation), sampled
// converting on read. The next-image windows, read by every GN step, are
// float32 in shared memory: float planes by cp.async, float16 planes
// through the read-only path into registers (all loads in flight at once),
// converted on the store. The addresses of a window are computed once, so
// that no load of the level table sits behind a copy. TMA would need
// 16-byte row strides, which these widths do not have.
//
// (c) No local memory. Every device function is force-inlined, the table
// is a __grid_constant__ parameter (references into it make no copy), and
// the per-lane arrays are indexed only in unrolled loops, so they stay in
// registers; the samples per lane are a template parameter (3 up to
// win = 9, the presets' size, 8 up to win = 16), and with 8 a float16
// window lands in rounds of 8 elements per lane. ptxas reports 0 stack and
// spill bytes (chip_smoke.py's build line).
//
// The GN step itself keeps the per-sample form, bit for bit, so this kernel
// returns the first version's points, status and errors exactly. A step
// that reads cached correlations was built and measured: the patch's
// samples share one fractional part and four bilinear weights w_jk summing
// to 1, so b_x = sum_jk w_jk C^x(cell + (j, k)) with C^x(s) = sum_d
// (W[s + d] - T(d)) gx(d), and 32 such sums around the point's cell serve
// every step inside its 3 x 3 block of cells (tests/test_torch_klt_cell.py
// holds that arithmetic to the per-sample step). It cut the step to
// 0.12 us and the call to 28 us, but its last-bit changes moved the
// trajectories (the sensitivity ROADMAP C/R6 records) and a smoke gate with
// them (C/P13), so it is not used; PERF.md gives its numbers.
//
// Everything after the staging is float32: no TF32, no fast-math, no tensor
// cores.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lk_common.cuh"

namespace {

using lkc::clampi;
using lkc::FloatWin;
using lkc::Lane;

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

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this lane's committed groups are pending, then
// make every lane's copies visible to the warp.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  __syncwarp();
}

// A ws x ws float16 window staged as aligned words: row r starts at half
// r * pitch + (par0 ^ (r & sodd)).
struct HalfWin {
  const __half* p;
  int pitch, par0, sodd;
  __device__ __forceinline__ float at(int r, int c) const {
    return __half2float(p[r * pitch + (par0 ^ (r & sodd)) + c]);
  }
};

// ---- staging --------------------------------------------------------------

// Where a ws x ws window lies in K planes of one level (one row stride, as
// the wrapper checks): the address of its first element in each. Computed
// once per window from the table, so that the staging loops, whose copies
// clobber memory, reread nothing.
template <int K>
struct Src {
  const void* first[K];
  int stride;
};

template <typename T>
__device__ __forceinline__ const void* first_elem(const Plane& p, int ox,
                                                  int oy) {
  return (const T*)p.data + (size_t)oy * p.stride + ox;
}

// Row and column of item i = lane + 32 * k of a row-major grid `cols`
// wide, k = 0, 1, ...: one division at the start, then a step without
// branches (the lanes' columns wrap at different k).
struct Walk {
  int r, c, q, rem, cols;
  __device__ __forceinline__ Walk(int lane, int cols_)
      : r(lane / cols_), c(lane - (lane / cols_) * cols_), q(32 / cols_),
        rem(32 - (32 / cols_) * cols_), cols(cols_) {}
  __device__ __forceinline__ void next() {
    c += rem;
    r += q;
    const bool wrap = c >= cols;
    c -= wrap ? cols : 0;
    r += wrap ? 1 : 0;
  }
};

// Iterations of a staging loop that spreads n items over the warp's lanes,
// at the largest window of S samples per lane (ws <= 20 up to win = 9,
// ws <= 27 up to win = 16).
template <int S>
__host__ __device__ constexpr int max_ws() { return S <= 3 ? 20 : 27; }

// Start copying the ws x ws windows of K float planes into shared memory
// (plane k to dst + k * ws * ws): 4-byte cp.async copies, lanes along rows.
template <int S, int K>
__device__ __forceinline__ void stage_float(float* dst, const Src<K>& src,
                                            int ws, int lane) {
  constexpr int kIters = (max_ws<S>() * max_ws<S>() + 31) / 32;
  Walk wk(lane, ws);
#pragma unroll 4
  for (int it = 0; it < kIters; ++it) {
    const int i = lane + 32 * it;
    if (i < ws * ws) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        cp_async4(dst + k * ws * ws + i, (const float*)src.first[k] +
                                             (size_t)wk.r * src.stride + wk.c);
    }
    wk.next();
  }
}

// Halves per row of a float16 window staged as words (even, covers a row
// of ws halves starting at either parity).
__host__ __device__ constexpr int half_pitch(int ws) {
  return 2 * ((ws + 2) / 2);
}

// The accessor of a float16 window whose first element is at `first` in a
// plane of row stride `stride`, staged at dst by stage_half_words.
__device__ __forceinline__ HalfWin half_win(const __half* dst,
                                            const void* first, int stride,
                                            int ws) {
  return HalfWin{dst, half_pitch(ws), (int)(((uintptr_t)first >> 1) & 1),
                 stride & 1};
}

// Start copying the ws x ws windows of three float16 planes into shared
// memory (plane k at dst + k * ws * half_pitch(ws)) as the aligned 4-byte
// words that hold them.
template <int S>
__device__ __forceinline__ void stage_half_words(__half* dst,
                                                 const Src<3>& src, int ws,
                                                 int lane) {
  constexpr int kIters = (max_ws<S>() * (max_ws<S>() + 2) / 2 + 31) / 32;
  const int pitch = half_pitch(ws), words = pitch / 2;
  const int sodd = src.stride & 1;
  int par0[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    par0[k] = (int)(((uintptr_t)src.first[k] >> 1) & 1);
  Walk wk(lane, words);
#pragma unroll 4
  for (int it = 0; it < kIters; ++it) {
    if (lane + 32 * it < ws * words) {
      const int r = wk.r, w = wk.c;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int par = par0[k] ^ (r & sodd);
        if (2 * w < par + ws)
          cp_async4(dst + k * ws * pitch + r * pitch + 2 * w,
                    (const uint32_t*)((const __half*)src.first[k] +
                                      (size_t)r * src.stride - par) + w);
      }
    }
    wk.next();
  }
}

// The next-image window of a float16 plane through the read-only path, NS
// elements per lane a round: issue() loads a round's elements into
// registers (all in flight at once; rows past the window read its last
// row, and are not stored), finish() stores them converted into the
// float32 window. `wk` walks the lane's items from round to round.
template <int NS>
struct HalfLoad {
  __half v[NS];
  int i0;   // the round's first item
  __device__ __forceinline__ void issue(const Src<1>& src, int ws, Walk& wk,
                                        int first_item) {
    const __half* first = (const __half*)src.first[0];
    i0 = first_item;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      v[s] = __ldg(first + (size_t)min(wk.r, ws - 1) * src.stride + wk.c);
      wk.next();
    }
  }
  __device__ __forceinline__ void finish(float* dst, int ws, int lane) const {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int i = i0 + lane + 32 * s;
      if (i < ws * ws) dst[i] = __half2float(v[s]);
    }
    __syncwarp();
  }
};

// Staging by plane type. tmpl(): start the three template windows (one
// cp.async group, committed by the caller); at(): the accessor of template
// window k once staged. next_issue() / next_finish(): the next-image
// window in two halves, so that the template can be sampled while it is
// in flight; `pending` says whether a template group was committed after
// next_issue() (it may stay in flight). window(): a next-image window at
// once.
template <typename T, int S>
struct Stage;

template <int S>
struct Stage<float, S> {
  using Win = FloatWin;
  struct Next {};
  static __device__ __forceinline__ Win at(float* buf, const Src<3>&, int ws,
                                           int k) {
    return FloatWin{buf + k * ws * ws, ws};
  }
  static __device__ __forceinline__ void tmpl(float* buf, const Src<3>& src,
                                              int ws, int lane) {
    stage_float<S>(buf, src, ws, lane);
  }
  static __device__ __forceinline__ void next_issue(Next&, float* dst,
                                                    const Src<1>& src, int ws,
                                                    int lane) {
    stage_float<S>(dst, src, ws, lane);
    cp_commit();
  }
  static __device__ __forceinline__ void next_finish(const Next&, float*, int,
                                                     int, bool pending) {
    if (pending)
      cp_wait<1>();
    else
      cp_wait<0>();
  }
  // wait for the template group, committed before the next-image one
  static __device__ __forceinline__ void tmpl_wait() { cp_wait<1>(); }
  static __device__ __forceinline__ void window(float* dst, const Src<1>& src,
                                                int ws, int lane) {
    stage_float<S>(dst, src, ws, lane);
    cp_commit();
    cp_wait<0>();
  }
};

template <int S>
struct Stage<__half, S> {
  using Win = HalfWin;
  // up to 3 slots (ws <= 20) the window is one round, whose registers stay
  // live while the template is sampled; past that, rounds of 8 elements
  // per lane land at once, or the registers would not fit
  static constexpr int kRound = S <= 3 ? (20 * 20 + 31) / 32 : 8;
  using Next = HalfLoad<kRound>;
  static __device__ __forceinline__ Win at(float* buf, const Src<3>& src,
                                           int ws, int k) {
    return half_win((const __half*)buf + k * ws * half_pitch(ws),
                    src.first[k], src.stride, ws);
  }
  static __device__ __forceinline__ void tmpl(float* buf, const Src<3>& src,
                                              int ws, int lane) {
    stage_half_words<S>((__half*)buf, src, ws, lane);
  }
  static __device__ __forceinline__ void next_issue(Next& nx, float* dst,
                                                    const Src<1>& src, int ws,
                                                    int lane) {
    if constexpr (S <= 3) {
      Walk wk(lane, ws);
      nx.issue(src, ws, wk, 0);
    } else {
      window(dst, src, ws, lane);
    }
  }
  static __device__ __forceinline__ void next_finish(const Next& nx,
                                                     float* dst, int ws,
                                                     int lane, bool) {
    if constexpr (S <= 3) nx.finish(dst, ws, lane);
  }
  static __device__ __forceinline__ void tmpl_wait() { cp_wait<0>(); }
  static __device__ __forceinline__ void window(float* dst, const Src<1>& src,
                                                int ws, int lane) {
    Walk wk(lane, ws);
    if constexpr (S <= 3) {
      Next nx;
      nx.issue(src, ws, wk, 0);
      nx.finish(dst, ws, lane);
    } else {
      for (int i0 = 0; i0 < ws * ws; i0 += 32 * kRound) {
        Next nx;
        nx.issue(src, ws, wk, i0);
        nx.finish(dst, ws, lane);
      }
    }
  }
};

// ---- one level -------------------------------------------------------------

// Per-warp shared memory: the float32 next-image window, then the three
// template windows in the planes' element type.
template <typename T>
__host__ __device__ constexpr int tmpl_bytes(int ws) {
  return sizeof(T) == 4 ? 3 * ws * ws * 4 : 3 * ws * half_pitch(ws) * 2;
}
template <typename T>
__host__ __device__ constexpr int warp_floats(int ws) {
  return ws * ws + (tmpl_bytes<T>(ws) + 15) / 16 * 4;
}

// A template: its three planes' window and where the window lies.
struct Tmpl {
  Src<3> src;
  int ox, oy;
};

template <typename T>
__device__ __forceinline__ Tmpl tmpl_at(const Plane& img, const Plane& gx,
                                        const Plane& gy, float tx, float ty,
                                        int ws) {
  Tmpl tp;
  tp.ox = clampi(__float2int_rn(tx) - ws / 2, 0, img.w - ws);
  tp.oy = clampi(__float2int_rn(ty) - ws / 2, 0, img.h - ws);
  tp.src.first[0] = first_elem<T>(img, tp.ox, tp.oy);
  tp.src.first[1] = first_elem<T>(gx, tp.ox, tp.oy);
  tp.src.first[2] = first_elem<T>(gy, tp.ox, tp.oy);
  tp.src.stride = img.stride;
  return tp;
}

// Start staging a template's three windows (one cp.async group).
template <typename T, int S>
__device__ __forceinline__ void issue_tmpl(float* sm_t, const Tmpl& tp,
                                           int ws, int lane) {
  Stage<T, S>::tmpl(sm_t, tp.src, ws, lane);
  cp_commit();
}

// One pyramid level of windowed LK for one keypoint
// (ops/klt.py::_track_level), its template `cur` already issued (one
// cp.async group): GN from (px, py) in img1. With `has_next`, `next` is
// the template to stage for the level after this one once `cur` is
// sampled. Updates (px, py); returns ok = track & in_bounds1. With
// `want_err`, *err receives mean |I - tmpl| in the last chunk's window.
template <typename T, int S>
__device__ __forceinline__ bool track_level(
    float* sm_t, float* sm_n, const Lane<S>& ln, const Tmpl& cur,
    const Tmpl& next, bool has_next, const Plane& img1, float tx, float ty,
    float& px, float& py, bool valid, int win, int max_iters, int n_chunks,
    float eps2, float min_eig_th, bool want_err, float* err, int lane) {
  using St = Stage<T, S>;
  const int ws = win + 11;
  const int hw = ws / 2;
  const int H = img1.h, W = img1.w;
  const Plane p1 = img1;
  const float half = (win - 1) * 0.5f;
  const float margin = (ws - win) * 0.5f - 1.5f;
  const bool in0 = tx >= half && tx < W - half && ty >= half && ty < H - half;
  int ox1 = clampi(__float2int_rn(px) - hw, 0, W - ws);
  int oy1 = clampi(__float2int_rn(py) - hw, 0, H - ws);
  auto src1 = [&]() {
    Src<1> s1;
    s1.first[0] = first_elem<T>(p1, ox1, oy1);
    s1.stride = p1.stride;
    return s1;
  };

  // the first chunk's window in flight while the template is sampled
  typename St::Next nx;
  St::next_issue(nx, sm_n, src1(), ws, lane);
  St::tmpl_wait();
  float t[S], gx[S], gy[S];
  const float qx0 = tx - (float)cur.ox, qy0 = ty - (float)cur.oy;
  lkc::sample_patch(St::at(sm_t, cur.src, ws, 0), ws, ln, half, qx0, qy0,
                    t);
  lkc::sample_patch(St::at(sm_t, cur.src, ws, 1), ws, ln, half, qx0, qy0,
                    gx);
  lkc::sample_patch(St::at(sm_t, cur.src, ws, 2), ws, ln, half, qx0, qy0,
                    gy);
  __syncwarp();   // the warp is done reading the template windows
  if (has_next) issue_tmpl<T, S>(sm_t, next, ws, lane);

  // G and the gates while the window may still be in flight
  float sxx = 0.f, sxy = 0.f, syy = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
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
  St::next_finish(nx, sm_n, ws, lane, has_next);

  const int iters = max(1, (max_iters + n_chunks - 1) / n_chunks);
  bool act = track, conv_total = false;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const bool last = ci + 1 == n_chunks;
    if (ci > 0) {
      ox1 = clampi(__float2int_rn(px) - hw, 0, W - ws);
      oy1 = clampi(__float2int_rn(py) - hw, 0, H - ws);
      // a frozen point needs its window only for the error
      if (!act && !(want_err && last)) continue;
      __syncwarp();   // the warp is done reading the previous window
      St::window(sm_n, src1(), ws, lane);
    }
    conv_total |= lkc::gn_steps(
        sm_n, ws, ln, half, t, gx, gy, Gxx, Gxy, Gyy, invd, (float)ox1,
        (float)oy1, (float)ox1 + (float)hw, (float)oy1 + (float)hw, iters,
        eps2, margin, px, py, act);
    if (!last) act = track && !conv_total;
  }
  const bool in1 = px >= half && px < W - half && py >= half && py < H - half;

  if (want_err) {
    float cur_s[S];
    lkc::sample_patch(FloatWin{sm_n, ws}, ws, ln, half, px - (float)ox1,
                 py - (float)oy1, cur_s);
    float e = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s)
      e += fabsf(cur_s[s] - t[s]);   // zero in the slots past win*win
    *err = lkc::warp_sum(e) / (float)(win * win);
  }
  __syncwarp();   // the warp is done reading this level's windows
  return track && in1;
}

// The table is a __grid_constant__ parameter: the device functions take
// references into it (a level's planes) without a copy in local memory.
template <typename T, int S>
__global__ void klt_track_kernel(
    const __grid_constant__ LevelTable tbl,
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
  float* sm_n = smem + (size_t)warp * warp_floats<T>(ws);   // next image
  float* sm_t = sm_n + ws * ws;                             // 3 templates
  const float x0 = prev_pts[2 * n], y0 = prev_pts[2 * n + 1];
  const bool v = valid[n] != 0;
  const Lane<S> ln = lkc::lane_layout<S>(win, lane);
  const float half = (win - 1) * 0.5f;

  // x / 2^l (exact, as a multiplication by 2^-l)
  auto down = [](float x, int l) {
    return x * __int_as_float((127 - l) << 23);
  };
  // a level runs if it can track the point, and level 0 always (its
  // error is every point's output); an untracked point does not move
  auto runs = [&](int l) {
    const float tx = down(x0, l), ty = down(y0, l);
    const Plane& p = tbl.prev_img[l];
    return l == 0 || (v && tx >= half && tx < p.w - half && ty >= half &&
                      ty < p.h - half);
  };
  auto tmpl_of = [&](int l) {
    return tmpl_at<T>(tbl.prev_img[l], tbl.prev_gx[l], tbl.prev_gy[l],
                      down(x0, l), down(y0, l), ws);
  };

  float px = down(prior[2 * n], nlevels), py = down(prior[2 * n + 1], nlevels);
  bool status = true, staged = false;
  float err = 0.f;
  for (int l = nlevels; l >= 0; --l) {
    if (!runs(l)) {
      status = false;
    } else {
      const Tmpl cur = tmpl_of(l);
      if (!staged) issue_tmpl<T, S>(sm_t, cur, ws, lane);
      // the next level's template is staged while this one iterates
      staged = l > 0 && runs(l - 1);
      const Tmpl nxt = staged ? tmpl_of(l - 1) : cur;
      status = track_level<T, S>(sm_t, sm_n, ln, cur, nxt, staged,
                                 tbl.next_img[l], down(x0, l), down(y0, l),
                                 px, py, v,
                                 win, max_iters,
                                 l == nlevels ? n_chunks : 1, eps2,
                                 min_eig_th, l == 0, &err, lane) &&
               status;
    }
    if (l > 0) {
      px *= 2.f;
      py *= 2.f;
    }
  }

  bool ok = false;
  if (status && err < max_err) {   // good: the backward track decides
    float bx = x0, by = y0;
    const Tmpl bt =
        tmpl_at<T>(tbl.next_img[0], tbl.next_gx0, tbl.next_gy0, px, py, ws);
    issue_tmpl<T, S>(sm_t, bt, ws, lane);
    const bool okb = track_level<T, S>(
        sm_t, sm_n, ln, bt, bt, false, tbl.prev_img[0], px, py, bx, by, true,
        win, max_iters, min(n_chunks, 2), eps2, min_eig_th, false, nullptr,
        lane);
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

template <typename T, int S>
int launch(const LevelTable& tbl, const void* prev_pts, const void* prior,
           const void* valid, void* out_pts, void* out_status, void* out_err,
           int N, int nlevels, int win, int max_iters, int n_chunks,
           float eps2, float max_fb_dist, float max_err, float min_eig_th,
           cudaStream_t stream) {
  const int ws = win + 11;
  const size_t smem =
      (size_t)kWarpsPerBlock * warp_floats<T>(ws) * sizeof(float);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  klt_track_kernel<T, S><<<blocks, kWarpsPerBlock * 32, smem, stream>>>(
      tbl, (const float*)prev_pts, (const float*)prior, (const uint8_t*)valid,
      (float*)out_pts, (uint8_t*)out_status, (float*)out_err, N, nlevels,
      win, max_iters, n_chunks, eps2, max_fb_dist, max_err, min_eig_th);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int klt_track_table_bytes() { return (int)sizeof(LevelTable); }

extern "C" int klt_track_max_levels() { return kMaxLevels; }

// Host launcher: `table` points to a LevelTable in host memory, copied into
// the kernel's parameters; its elem_bytes picks the float or the __half
// instantiation, win the samples per lane (3 up to win = 9, else 8).
// Returns a cudaError_t (0 on success).
extern "C" int klt_track_launch(
    const void* table, const void* prev_pts, const void* prior,
    const void* valid, void* out_pts, void* out_status, void* out_err,
    int N, int nlevels, int win, int max_iters, int n_chunks, float eps2,
    float max_fb_dist, float max_err, float min_eig_th, void* stream) {
  if (N <= 0) return 0;
  if (nlevels < 0 || nlevels >= kMaxLevels || win < 1 ||
      win * win > 32 * lkc::kMaxSamplesPerLane || n_chunks < 1)
    return (int)cudaErrorInvalidValue;
  const LevelTable& tbl = *(const LevelTable*)table;
  const bool small = win * win <= 32 * 3;
  const cudaStream_t st = (cudaStream_t)stream;
#define KLT_LAUNCH(T, S)                                                     \
  launch<T, S>(tbl, prev_pts, prior, valid, out_pts, out_status, out_err, N, \
               nlevels, win, max_iters, n_chunks, eps2, max_fb_dist,         \
               max_err, min_eig_th, st)
  if (tbl.elem_bytes == 4)
    return small ? KLT_LAUNCH(float, 3) : KLT_LAUNCH(float, 8);
  if (tbl.elem_bytes == 2)
    return small ? KLT_LAUNCH(__half, 3) : KLT_LAUNCH(__half, 8);
#undef KLT_LAUNCH
  return (int)cudaErrorInvalidValue;
}
