"""Forward-backward pyramidal Lucas-Kanade optical flow (port of
``ov2slam_tpu/ops/klt.py``).

Replaces the reference's FeatureTracker::fbKltTracking (feature_tracker.cpp:
35-137): per pyramid level, patch Gauss-Newton with min-eigenvalue gating,
then the forward-backward distance and border checks. All keypoints are
tracked at once. Per chunk of iterations one integer-aligned (ws, ws)
window is cut around each keypoint, and the GN loop runs inside the windows
through ``ops/lk.py::lk_iterate`` — the CUDA kernel on the GPU, its plain
version on the CPU; points that drift past the window margin pause and
resume after the next chunk re-centres their window.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ov2slam_tpu_torch.ops import image as im
from ov2slam_tpu_torch.ops import lk


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
        pts, active, conv = lk.lk_iterate(
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
            compute_err=compute_err and lvl == 0)
        ok = ok_l if lvl == nlevels else ok & ok_l
        if lvl > 0:
            guess = guess * 2.0
    return KLTResult(points=guess, status=ok, error=err)


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
    """Forward-backward KLT with error + FB-distance gating (the reference's
    fbKltTracking, feature_tracker.cpp:35-137). prior_pts seed the forward
    track; the backward track runs at level 0 from the original positions
    and must return within max_fb_dist."""
    prev_pyr = list(prev_pyr)
    next_pyr = list(next_pyr)
    fwd = pyr_klt(prev_pyr, next_pyr, prev_pts, prior_pts, valid, nlevels,
                  win, max_iters, eps, min_eig_th, prev_grad_pyr,
                  n_chunks=n_chunks)
    good = fwd.status & (fwd.error < max_err)
    ngp = None if next_grad_pyr is None else list(next_grad_pyr)[:1]
    bwd = pyr_klt(next_pyr[:1], prev_pyr[:1], fwd.points, prev_pts, good, 0,
                  win, max_iters, eps, min_eig_th, ngp,
                  n_chunks=min(n_chunks, 2), compute_err=False)
    fb_dist = torch.linalg.norm(bwd.points - prev_pts, dim=-1)
    ok = good & bwd.status & (fb_dist <= max_fb_dist)
    return KLTResult(points=fwd.points, status=ok, error=fwd.error)
