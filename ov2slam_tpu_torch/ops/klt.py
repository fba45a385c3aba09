"""Forward-backward pyramidal Lucas-Kanade optical flow (port of
``ov2slam_tpu/ops/klt.py``).

Replaces the reference's FeatureTracker::fbKltTracking (feature_tracker.cpp:
35-137): per pyramid level, patch Gauss-Newton with min-eigenvalue gating,
then the forward-backward distance and border checks. All keypoints are
tracked at once. Per chunk of iterations one integer-aligned (ws, ws)
window is cut around each keypoint, and the GN loop runs inside it; points
that drift past the window margin pause and resume after the next chunk
re-centres their window.

* ``fb_klt_tracking`` launches ``csrc/klt_track.cu`` for CUDA tensors: the
  whole forward-backward track of every keypoint in one launch, reading
  the pyramids in place. Each launch counts in ``LAUNCHES``. Anything the
  kernel does not take raises, on every device; there is no fallback.
* For CPU tensors it runs ``fb_klt_tracking_plain``: the same computation
  in plain torch, with windows gathered per chunk and the GN loop in
  ``lk.lk_iterate_plain``.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ov2slam_tpu_torch.ops import image as im
from ov2slam_tpu_torch.ops import lk

# kernel launches made by fb_klt_tracking (a plain count: the slice's runs
# read it to show that tracking and stereo matching went through the kernel)
LAUNCHES = 0
MAX_LEVELS = 8          # csrc/klt_track.cu kMaxLevels

_FN = None


class KLTResult(NamedTuple):
    points: torch.Tensor   # (N, 2) tracked positions in level-0 pixels
    status: torch.Tensor   # (N,) bool — tracked, well-conditioned, in-border
    error: torch.Tensor    # (N,) mean |I - J| over the window


def _extract_windows(imgs: torch.Tensor, origin: torch.Tensor, ws: int
                     ) -> torch.Tensor:
    """imgs (C, H, W); origin (N, 2) int (x, y), already inside the image ->
    (C, N, ws, ws) windows (one batched gather)."""
    ar = torch.arange(ws, device=imgs.device)
    rows = origin[:, 1].long()[:, None] + ar[None, :]      # (N, ws)
    cols = origin[:, 0].long()[:, None] + ar[None, :]
    return imgs[:, rows[:, :, None], cols[:, None, :]]


def _track_level(
    prev_img: torch.Tensor,
    next_img: torch.Tensor,
    prev_pts: torch.Tensor,   # (N, 2) coords at this level
    guess: torch.Tensor,      # (N, 2) current estimate at this level
    valid: torch.Tensor,      # (N,) bool
    win: int,
    max_iters: int,
    eps: float,
    min_eig_th: float,
    prev_grad: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    n_chunks: int = 3,
    compute_err: bool = True,
    lk_fn: Callable = lk.lk_iterate_plain,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One pyramid level of windowed LK. Returns (new_pts, ok, err)."""
    H, W = prev_img.shape
    half = (win - 1) / 2.0
    ws = win + 11                      # patch + per-chunk motion + bilinear
    margin = (ws - win) / 2.0 - 1.5    # max in-window deviation per chunk
    hw = ws // 2
    dt = prev_pts.dtype

    def origins(pts):
        o = torch.round(pts).to(torch.int32) - hw
        ox = torch.clamp(o[:, 0], 0, W - ws)
        oy = torch.clamp(o[:, 1], 0, H - ws)
        return torch.stack([ox, oy], dim=-1)

    if prev_grad is None:
        ix_img, iy_img = im.scharr_gradients(prev_img.float())
    else:
        ix_img, iy_img = prev_grad
    o_prev = origins(prev_pts)
    pos_prev = prev_pts - o_prev.to(dt)
    twin = _extract_windows(
        torch.stack([prev_img, ix_img.to(prev_img.dtype),
                     iy_img.to(prev_img.dtype)]), o_prev, ws).to(dt)
    tmpl, gx, gy = lk.sample_in_windows(twin, pos_prev, win)

    gxx = torch.sum(gx * gx, dim=-1)
    gxy = torch.sum(gx * gy, dim=-1)
    gyy = torch.sum(gy * gy, dim=-1)
    det = gxx * gyy - gxy * gxy
    # min eigenvalue of G / window area (OpenCV minEigThreshold semantics)
    tr = gxx + gyy
    min_eig = (tr - torch.sqrt(torch.clamp(tr * tr - 4.0 * det, min=0.0))) * 0.5
    well_cond = min_eig / (win * win) > min_eig_th
    inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / det,
                          torch.zeros_like(det))

    in_bounds0 = ((prev_pts[:, 0] >= half) & (prev_pts[:, 0] < W - half)
                  & (prev_pts[:, 1] >= half) & (prev_pts[:, 1] < H - half))
    track = valid & well_cond & in_bounds0

    iters_per_chunk = max(1, (max_iters + n_chunks - 1) // n_chunks)
    pts = guess.contiguous()
    active = track
    conv_total = torch.zeros_like(track)
    nwin = o_next = None
    for ci in range(n_chunks):
        o_next = origins(pts)
        nwin = _extract_windows(next_img[None], o_next, ws)[0].to(dt)
        ctr = o_next.to(dt) + hw
        pts, active, conv = lk_fn(
            nwin.contiguous(), tmpl.contiguous(), gx.contiguous(),
            gy.contiguous(), gxx, gxy, gyy, inv_det, o_next.contiguous(),
            ctr.contiguous(), pts, active.contiguous(), win=win,
            n_iters=iters_per_chunk, eps=eps, margin=margin)
        # reactivate only margin-paused (not converged) points for the next
        # re-centred chunk
        conv_total = conv_total | conv
        if ci + 1 < n_chunks:
            active = track & ~conv_total

    in_bounds1 = ((pts[:, 0] >= half) & (pts[:, 0] < W - half)
                  & (pts[:, 1] >= half) & (pts[:, 1] < H - half))
    ok = track & in_bounds1
    if compute_err:
        cur = lk.sample_in_windows(nwin, pts - o_next.to(dt), win)
        err = torch.mean(torch.abs(cur - tmpl), dim=-1)
    else:
        err = torch.zeros(pts.shape[0], dtype=dt, device=pts.device)
    return pts, ok, err


def pyr_klt(
    prev_pyr: List[torch.Tensor],
    next_pyr: List[torch.Tensor],
    prev_pts: torch.Tensor,
    init_pts: torch.Tensor,
    valid: torch.Tensor,
    nlevels: int,
    win: int = 9,
    max_iters: int = 30,
    eps: float = 0.01,
    min_eig_th: float = 1e-4,
    prev_grad_pyr: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
    n_chunks: int = 3,
    compute_err: bool = True,
    lk_fn: Callable = lk.lk_iterate_plain,
) -> KLTResult:
    """Pyramidal LK, coarse to fine. Only the top level runs `n_chunks`
    re-centring chunks; lower levels run one chunk with the full budget;
    the error is sampled at level 0 only."""
    scale = 2.0 ** nlevels
    guess = init_pts / scale
    ok = valid
    err = torch.zeros(prev_pts.shape[0], dtype=prev_pts.dtype,
                      device=prev_pts.device)
    for lvl in range(nlevels, -1, -1):
        s = 2.0 ** lvl
        pg = None if prev_grad_pyr is None else prev_grad_pyr[lvl]
        guess, ok_l, err = _track_level(
            prev_pyr[lvl], next_pyr[lvl], prev_pts / s, guess, valid, win,
            max_iters, eps, min_eig_th, prev_grad=pg,
            n_chunks=n_chunks if lvl == nlevels else 1,
            compute_err=compute_err and lvl == 0, lk_fn=lk_fn)
        ok = ok_l if lvl == nlevels else ok & ok_l
        if lvl > 0:
            guess = guess * 2.0
    return KLTResult(points=guess, status=ok, error=err)


def fb_klt_tracking_plain(
    prev_pyr: Sequence[torch.Tensor],
    next_pyr: Sequence[torch.Tensor],
    prev_pts: torch.Tensor,
    prior_pts: torch.Tensor,
    valid: torch.Tensor,
    nlevels: int = 3,
    win: int = 9,
    max_iters: int = 30,
    eps: float = 0.01,
    max_fb_dist: float = 0.5,
    max_err: float = 30.0,
    min_eig_th: float = 1e-4,
    prev_grad_pyr=None,
    next_grad_pyr=None,
    n_chunks: int = 3,
    lk_fn: Callable = lk.lk_iterate_plain,
) -> KLTResult:
    """Forward-backward KLT with error + FB-distance gating (the reference's
    fbKltTracking, feature_tracker.cpp:35-137), in plain torch. prior_pts
    seed the forward track; the backward track runs at level 0 from the
    original positions and must return within max_fb_dist.

    `lk_fn` runs each chunk's GN steps. Only measurements change it:
    ``lk.lk_iterate`` gives the per-chunk kernel path, timed beside the
    fused kernel by ``chip_smoke.py``."""
    prev_pyr = list(prev_pyr)
    next_pyr = list(next_pyr)
    fwd = pyr_klt(prev_pyr, next_pyr, prev_pts, prior_pts, valid, nlevels,
                  win, max_iters, eps, min_eig_th, prev_grad_pyr,
                  n_chunks=n_chunks, lk_fn=lk_fn)
    good = fwd.status & (fwd.error < max_err)
    ngp = None if next_grad_pyr is None else list(next_grad_pyr)[:1]
    bwd = pyr_klt(next_pyr[:1], prev_pyr[:1], fwd.points, prev_pts, good, 0,
                  win, max_iters, eps, min_eig_th, ngp,
                  n_chunks=min(n_chunks, 2), compute_err=False, lk_fn=lk_fn)
    fb_dist = torch.linalg.norm(bwd.points - prev_pts, dim=-1)
    ok = good & bwd.status & (fb_dist <= max_fb_dist)
    return KLTResult(points=fwd.points, status=ok, error=fwd.error)


# the plane element types the kernel reads, by their size in bytes
PLANE_DTYPES = {torch.float16: 2, torch.float32: 4}


class Plane(ctypes.Structure):
    """csrc/klt_track.cu ``Plane``: one row-major image plane."""
    _fields_ = [("data", ctypes.c_void_p), ("h", ctypes.c_int),
                ("w", ctypes.c_int), ("stride", ctypes.c_int)]


class LevelTable(ctypes.Structure):
    """csrc/klt_track.cu ``LevelTable``: the pyramids the kernel reads, all
    of one element type (``elem_bytes``: 2 for float16, 4 for float32)."""
    _fields_ = [("prev_img", Plane * MAX_LEVELS),
                ("prev_gx", Plane * MAX_LEVELS),
                ("prev_gy", Plane * MAX_LEVELS),
                ("next_img", Plane * MAX_LEVELS),
                ("next_gx0", Plane), ("next_gy0", Plane),
                ("elem_bytes", ctypes.c_int)]


def _plane(name: str, t: torch.Tensor, shape, device, dtype) -> Plane:
    if t.dtype != dtype:
        raise TypeError(f"fb_klt_tracking: {name} is {t.dtype}; every plane "
                        f"of a call must be {dtype}")
    if t.device != device:
        raise ValueError(f"fb_klt_tracking: {name} is on {t.device}, "
                         f"expected {device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"fb_klt_tracking: {name} must have shape "
                         f"{tuple(shape)}, got {tuple(t.shape)}")
    if t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"fb_klt_tracking: {name} must be a contiguous "
                         f"(H, W) plane")
    return Plane(t.data_ptr(), t.shape[0], t.shape[1], t.stride(0))


def level_table(prev_pyr, next_pyr, prev_grad_pyr, next_grad0, nlevels: int,
                win: int, device) -> LevelTable:
    """The kernel's level table, after checking every plane it names: all
    of one dtype, float16 or float32 (prev_pyr[0]'s, which the table
    records), contiguous, on `device`, prev/next and gradients of one shape
    per level, each level at least one window (win + 11) wide and high.
    Gradients given as None are left null: the kernel's wrapper computes
    them before it builds the table, the plain version on the CPU itself."""
    ws = win + 11
    dtype = prev_pyr[0].dtype
    if dtype not in PLANE_DTYPES:
        raise TypeError(f"fb_klt_tracking: planes must be float16 or "
                        f"float32, got {dtype}")
    if not 0 <= nlevels < MAX_LEVELS:
        raise ValueError(f"fb_klt_tracking: nlevels={nlevels} outside "
                         f"[0, {MAX_LEVELS - 1}]")
    for name, pyr in (("prev_pyr", prev_pyr), ("next_pyr", next_pyr),
                      ("prev_grad_pyr", prev_grad_pyr)):
        if pyr is not None and len(pyr) < nlevels + 1:
            raise ValueError(f"fb_klt_tracking: {name} has {len(pyr)} "
                             f"levels, nlevels={nlevels} needs {nlevels + 1}")
    tbl = LevelTable()
    tbl.elem_bytes = PLANE_DTYPES[dtype]
    for lvl in range(nlevels + 1):
        shape = tuple(prev_pyr[lvl].shape)
        tbl.prev_img[lvl] = _plane(f"prev_pyr[{lvl}]", prev_pyr[lvl], None,
                                   device, dtype)
        if shape[0] < ws or shape[1] < ws:
            raise ValueError(f"fb_klt_tracking: level {lvl} is {shape}, "
                             f"smaller than the {ws}x{ws} window")
        tbl.next_img[lvl] = _plane(f"next_pyr[{lvl}]", next_pyr[lvl], shape,
                                   device, dtype)
        if prev_grad_pyr is not None:
            gx, gy = prev_grad_pyr[lvl]
            tbl.prev_gx[lvl] = _plane(f"prev_grad_pyr[{lvl}][0]", gx, shape,
                                      device, dtype)
            tbl.prev_gy[lvl] = _plane(f"prev_grad_pyr[{lvl}][1]", gy, shape,
                                      device, dtype)
    if next_grad0 is not None:
        shape = tuple(prev_pyr[0].shape)
        tbl.next_gx0 = _plane("next_grad_pyr[0][0]", next_grad0[0], shape,
                              device, dtype)
        tbl.next_gy0 = _plane("next_grad_pyr[0][1]", next_grad0[1], shape,
                              device, dtype)
    return tbl


def _stored_grads(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scharr gradients of plane `a`, computed in float32, in a's dtype."""
    return tuple(g.to(a.dtype) for g in im.scharr_gradients(a.float()))


def _kernel_fn():
    global _FN
    if _FN is None:
        from ov2slam_tpu_torch.ops import _build
        lib = _build.load("klt_track")
        if (lib.klt_track_table_bytes() != ctypes.sizeof(LevelTable)
                or lib.klt_track_max_levels() != MAX_LEVELS):
            raise RuntimeError("klt_track: the ctypes LevelTable does not "
                               "match csrc/klt_track.cu")
        fn = lib.klt_track_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                       + [ctypes.c_float] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def fb_klt_tracking(
    prev_pyr: Sequence[torch.Tensor],
    next_pyr: Sequence[torch.Tensor],
    prev_pts: torch.Tensor,
    prior_pts: torch.Tensor,
    valid: torch.Tensor,
    nlevels: int = 3,
    win: int = 9,
    max_iters: int = 30,
    eps: float = 0.01,
    max_fb_dist: float = 0.5,
    max_err: float = 30.0,
    min_eig_th: float = 1e-4,
    prev_grad_pyr=None,
    next_grad_pyr=None,
    n_chunks: int = 3,
) -> KLTResult:
    """Forward-backward KLT (see ``fb_klt_tracking_plain``): one
    ``csrc/klt_track.cu`` launch for CUDA tensors, the plain version for
    CPU tensors.

    prev_pyr / next_pyr: levels 0..nlevels of (H, W) images, float16 (the
    front end's storage) or float32, one dtype for every plane of the call;
    prev_pts, prior_pts (N, 2) float32; valid (N,) bool. Gradient pyramids
    (lists of (gx, gy) per level) are optional: without them the Scharr
    gradients are computed here, in float32 from the planes, and stored in
    their dtype (only next_grad_pyr[0] is read). Windows are gathered in
    the planes' dtype and every sample, sum and GN step runs in float32."""
    global LAUNCHES
    prev_pyr = list(prev_pyr)
    next_pyr = list(next_pyr)
    dev = prev_pts.device
    N = prev_pts.shape[0]
    for name, t, dt, shape in (("prev_pts", prev_pts, torch.float32, (N, 2)),
                               ("prior_pts", prior_pts, torch.float32, (N, 2)),
                               ("valid", valid, torch.bool, (N,))):
        if t.dtype != dt or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(
                f"fb_klt_tracking: {name} must be {dt} of shape {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    prev_pts, prior_pts, valid = (prev_pts.contiguous(),
                                  prior_pts.contiguous(), valid.contiguous())
    # win*win <= 256 also keeps a block's four warps' windows (4 planes of
    # (win + 11)^2 floats each) within 48 KB of shared memory
    if win < 1 or win * win > 256:
        raise ValueError(f"fb_klt_tracking: win={win} exceeds the kernel's "
                         "limits (win*win <= 256)")
    if n_chunks < 1:
        raise ValueError(f"fb_klt_tracking: n_chunks={n_chunks} < 1")
    prev_grad = None if prev_grad_pyr is None else list(prev_grad_pyr)
    next_grad0 = None if next_grad_pyr is None else list(next_grad_pyr)[0]
    if dev.type == "cpu":
        level_table(prev_pyr, next_pyr, prev_grad, next_grad0, nlevels, win,
                    dev)
        return fb_klt_tracking_plain(
            prev_pyr, next_pyr, prev_pts, prior_pts, valid, nlevels, win,
            max_iters, eps, max_fb_dist, max_err, min_eig_th, prev_grad_pyr,
            next_grad_pyr, n_chunks)
    if dev.type != "cuda":
        raise ValueError(f"fb_klt_tracking: no kernel for device {dev}")
    # gradients made here are computed in float32 and stored in the planes'
    # dtype, as the plain version (and the JAX package) does
    if prev_grad is None:
        prev_grad = [_stored_grads(a) for a in prev_pyr[:nlevels + 1]]
    if next_grad0 is None:
        next_grad0 = _stored_grads(next_pyr[0])
    tbl = level_table(prev_pyr, next_pyr, prev_grad, next_grad0, nlevels,
                      win, dev)
    out_pts = torch.empty((N, 2), dtype=torch.float32, device=dev)
    out_status = torch.empty((N,), dtype=torch.bool, device=dev)
    out_err = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return KLTResult(points=out_pts, status=out_status, error=out_err)
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ctypes.addressof(tbl), prev_pts.data_ptr(),
                 prior_pts.data_ptr(), valid.data_ptr(), out_pts.data_ptr(),
                 out_status.data_ptr(), out_err.data_ptr(), N, nlevels, win,
                 int(max_iters), int(n_chunks), float(eps * eps),
                 float(max_fb_dist), float(max_err), float(min_eig_th),
                 stream)
    if err != 0:
        raise RuntimeError(f"klt_track kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return KLTResult(points=out_pts, status=out_status, error=out_err)
