"""The least time of one ``klt_track`` call on its own inputs: the
benchmark's copy of the repository's KLT bound arithmetic (the smoke
test's ``klt_bound`` and its patch recorder), with the plain
forward-backward KLT it replays, so that it imports nothing of the
program under test.

The bound counts what the inputs need, not what the kernel reads: each
pixel that a patch of the track touches is read once per plane (the
template patches, every Gauss-Newton step's patch, the level-0 error
patch), at the planes' element size, plus the per-point inputs and
outputs; the operations are those patches' samples at ``FLOPS_PER_SAMPLE``
each. The least time is the larger of bytes over the card's HBM bandwidth
and operations over its float32 rate (NVIDIA H100 SXM data sheet, dense,
at 700 W).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

HBM_BPS, F32_FLOPS, FLOPS_PER_SAMPLE = 3.35e12, 67e12, 30


class KLTResult(NamedTuple):
    points: torch.Tensor
    status: torch.Tensor
    error: torch.Tensor


# ------------------------------------------------- plain KLT (a frozen copy)
def hat_weights(q: torch.Tensor, size: int) -> torch.Tensor:
    j = torch.arange(size, dtype=q.dtype, device=q.device)
    return torch.clamp(1.0 - torch.abs(j[None, None, :] - q[..., None]), min=0.0)


def sample_in_windows(windows: torch.Tensor, pos_in_win: torch.Tensor,
                      win: int) -> torch.Tensor:
    single = windows.dim() == 3
    if single:
        windows = windows[None]
    ws = windows.shape[-1]
    r = (win - 1) / 2.0
    offs = torch.arange(win, dtype=pos_in_win.dtype, device=pos_in_win.device) - r
    Wx = hat_weights(pos_in_win[:, None, 0] + offs[None, :], ws)
    Wy = hat_weights(pos_in_win[:, None, 1] + offs[None, :], ws)
    p = torch.einsum("naj,cnjk,nbk->cnab", Wy, windows, Wx)
    p = p.reshape(p.shape[0], p.shape[1], win * win)
    return p[0] if single else p


def lk_iterate_plain(nwin, tmpl, gx, gy, gxx, gxy, gyy, inv_det, origins,
                     ctr, pts, active, win: int, n_iters: int, eps: float,
                     margin: float):
    o = origins.to(pts.dtype)
    p, a = pts, active
    cv = torch.zeros_like(active)
    for _ in range(n_iters):
        if not bool(a.any()):
            break
        cur = sample_in_windows(nwin, p - o, win)
        diff = cur - tmpl
        bx = torch.sum(diff * gx, dim=-1)
        by = torch.sum(diff * gy, dim=-1)
        dx = -(gyy * bx - gxy * by) * inv_det
        dy = -(-gxy * bx + gxx * by) * inv_det
        step = torch.where(a[:, None], torch.stack([dx, dy], dim=-1),
                           torch.zeros_like(p))
        new_p = p + step
        conv = torch.sum(step * step, dim=-1) < eps * eps
        dev = torch.amax(torch.abs(new_p - ctr), dim=-1)
        cv = cv | (a & conv)
        a = a & ~conv & (dev <= margin)
        p = new_p
    return p, a, cv


def _extract_windows(imgs, origin, ws: int):
    ar = torch.arange(ws, device=imgs.device)
    rows = origin[:, 1].long()[:, None] + ar[None, :]
    cols = origin[:, 0].long()[:, None] + ar[None, :]
    return imgs[:, rows[:, :, None], cols[:, None, :]]


def _track_level(prev_img, next_img, prev_pts, guess, valid, win, max_iters,
                 eps, min_eig_th, prev_grad, n_chunks=3, compute_err=True,
                 lk_fn: Callable = lk_iterate_plain):
    H, W = prev_img.shape
    half = (win - 1) / 2.0
    ws = win + 11
    margin = (ws - win) / 2.0 - 1.5
    hw = ws // 2
    dt = prev_pts.dtype

    def origins(pts):
        o = torch.round(pts).to(torch.int32) - hw
        return torch.stack([torch.clamp(o[:, 0], 0, W - ws),
                            torch.clamp(o[:, 1], 0, H - ws)], dim=-1)

    ix_img, iy_img = prev_grad
    o_prev = origins(prev_pts)
    pos_prev = prev_pts - o_prev.to(dt)
    twin = _extract_windows(torch.stack([prev_img, ix_img.to(prev_img.dtype),
                                         iy_img.to(prev_img.dtype)]),
                            o_prev, ws).to(dt)
    tmpl, gx, gy = sample_in_windows(twin, pos_prev, win)
    gxx = torch.sum(gx * gx, dim=-1)
    gxy = torch.sum(gx * gy, dim=-1)
    gyy = torch.sum(gy * gy, dim=-1)
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    min_eig = (tr - torch.sqrt(torch.clamp(tr * tr - 4.0 * det, min=0.0))) * 0.5
    well_cond = min_eig / (win * win) > min_eig_th
    inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / det, torch.zeros_like(det))
    in_b0 = ((prev_pts[:, 0] >= half) & (prev_pts[:, 0] < W - half)
             & (prev_pts[:, 1] >= half) & (prev_pts[:, 1] < H - half))
    track = valid & well_cond & in_b0
    per_chunk = max(1, (max_iters + n_chunks - 1) // n_chunks)
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
            n_iters=per_chunk, eps=eps, margin=margin)
        conv_total = conv_total | conv
        if ci + 1 < n_chunks:
            active = track & ~conv_total
    in_b1 = ((pts[:, 0] >= half) & (pts[:, 0] < W - half)
             & (pts[:, 1] >= half) & (pts[:, 1] < H - half))
    ok = track & in_b1
    if compute_err:
        cur = sample_in_windows(nwin, pts - o_next.to(dt), win)
        err = torch.mean(torch.abs(cur - tmpl), dim=-1)
    else:
        err = torch.zeros(pts.shape[0], dtype=dt, device=pts.device)
    return pts, ok, err


def pyr_klt(prev_pyr, next_pyr, prev_pts, init_pts, valid, nlevels, win=9,
            max_iters=30, eps=0.01, min_eig_th=1e-4, prev_grad_pyr=None,
            n_chunks=3, compute_err=True, lk_fn: Callable = lk_iterate_plain):
    guess = init_pts / 2.0 ** nlevels
    ok = valid
    err = None
    for lvl in range(nlevels, -1, -1):
        s = 2.0 ** lvl
        guess, ok_l, err = _track_level(
            prev_pyr[lvl], next_pyr[lvl], prev_pts / s, guess, valid, win,
            max_iters, eps, min_eig_th, prev_grad_pyr[lvl],
            n_chunks=n_chunks if lvl == nlevels else 1,
            compute_err=compute_err and lvl == 0, lk_fn=lk_fn)
        ok = ok_l if lvl == nlevels else ok & ok_l
        if lvl > 0:
            guess = guess * 2.0
    return KLTResult(guess, ok, err)


def fb_klt_tracking_plain(prev_pyr, next_pyr, prev_pts, prior_pts, valid,
                          nlevels=3, win=9, max_iters=30, eps=0.01,
                          max_fb_dist=0.5, max_err=30.0, min_eig_th=1e-4,
                          prev_grad_pyr=None, next_grad_pyr=None, n_chunks=3,
                          lk_fn: Callable = lk_iterate_plain):
    prev_pyr, next_pyr = list(prev_pyr), list(next_pyr)
    prev_grad_pyr = _grads(prev_pyr, prev_grad_pyr)
    next_grad_pyr = _grads(next_pyr[:1], None if next_grad_pyr is None
                           else list(next_grad_pyr)[:1])
    fwd = pyr_klt(prev_pyr, next_pyr, prev_pts, prior_pts, valid, nlevels,
                  win, max_iters, eps, min_eig_th, prev_grad_pyr,
                  n_chunks=n_chunks, lk_fn=lk_fn)
    good = fwd.status & (fwd.error < max_err)
    bwd = pyr_klt(next_pyr[:1], prev_pyr[:1], fwd.points, prev_pts, good, 0,
                  win, max_iters, eps, min_eig_th, next_grad_pyr,
                  n_chunks=min(n_chunks, 2), compute_err=False, lk_fn=lk_fn)
    fb = torch.linalg.norm(bwd.points - prev_pts, dim=-1)
    return KLTResult(fwd.points, good & bwd.status & (fb <= max_fb_dist),
                     fwd.error)


def scharr(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scharr gradients / 32 with replicated borders (the stereo call's
    planes come without gradients)."""
    p = torch.nn.functional.pad(img.float()[None, None], (1, 1, 1, 1),
                                mode="replicate")[0, 0]
    gx = (3 * (p[:-2, 2:] - p[:-2, :-2]) + 10 * (p[1:-1, 2:] - p[1:-1, :-2])
          + 3 * (p[2:, 2:] - p[2:, :-2])) / 32.0
    gy = (3 * (p[2:, :-2] - p[:-2, :-2]) + 10 * (p[2:, 1:-1] - p[:-2, 1:-1])
          + 3 * (p[2:, 2:] - p[:-2, 2:])) / 32.0
    return gx, gy


def _grads(pyr, grads):
    return list(grads) if grads is not None else [scharr(a) for a in pyr]


# ------------------------------------------------------------- the bound
def recording_lk(calls: list):
    """lk_iterate_plain one GN step at a time (the same result), recording
    per call its window origins and per step the points and active mask."""
    def fn(*args, win, n_iters, eps, margin):
        *head, p, a = args
        cv = torch.zeros_like(a)
        steps = []
        calls.append((head[8], steps))
        for _ in range(n_iters):
            if not bool(a.any()):
                break
            steps.append((p, a))
            p, a, c = lk_iterate_plain(*head, p, a, win=win, n_iters=1,
                                       eps=eps, margin=margin)
            cv = cv | c
        return p, a, cv
    return fn


def mark_patches(mask, q, o, sel, win: int, ws: int) -> int:
    """Mark in `mask` the pixels that the win x win patches centred at q
    read inside their ws x ws windows at origins o, for the points in sel;
    returns the number of patches."""
    q, o = q[sel], o[sel].long()
    r = (win - 1) / 2.0
    lo = torch.floor(q - o - r).long().clamp(min=0)
    hi = torch.ceil(q - o - r + win - 1).long().clamp(max=ws - 1)
    ar = torch.arange(win + 1, device=q.device)
    xs, ys = lo[:, 0, None] + ar, lo[:, 1, None] + ar
    keep = (ys <= hi[:, 1, None])[:, :, None] & (xs <= hi[:, 0, None])[:, None, :]
    rows = (o[:, 1, None] + ys)[:, :, None].expand_as(keep)
    cols = (o[:, 0, None] + xs)[:, None, :].expand_as(keep)
    mask[rows[keep], cols[keep]] = True
    return q.shape[0]


def window_origins(q, shape, ws: int):
    H, W = shape
    o = torch.round(q).long() - ws // 2
    return torch.stack([o[:, 0].clamp(0, W - ws), o[:, 1].clamp(0, H - ws)], -1)


def bound(nbytes: float, ops: float):
    """(ms, "bytes" | "operations"): the larger of the two least times."""
    t_bytes, t_ops = 1e3 * nbytes / HBM_BPS, 1e3 * ops / F32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def klt_bound(args: Sequence, kw: dict):
    """(ms, bound by, bytes, operations) of one fb_klt_tracking call with
    these arguments and keywords (the program's call: prev and next
    pyramids, points, priors, valid; nlevels, win, and the rest)."""
    p0, p1, pts, prior, valid = args
    kw = {k: v for k, v in kw.items()
          if k in ("nlevels", "win", "max_iters", "eps", "max_fb_dist",
                   "max_err", "prev_grad_pyr", "next_grad_pyr")}
    N, nl, win = pts.shape[0], kw["nlevels"], kw["win"]
    ws, P, n_chunks, max_err = win + 11, win * win, 3, 30.0
    calls: List = []
    fb_klt_tracking_plain(p0, p1, pts, prior, valid, **kw,
                          lk_fn=recording_lk(calls))
    fwd = pyr_klt(list(p0), list(p1), pts, prior, valid, nl, win,
                  prev_grad_pyr=_grads(list(p0), kw.get("prev_grad_pyr")))
    good = fwd.status & (fwd.error < max_err)
    masks = {}

    def mark(name, lvl, q, o, sel):
        m = masks.setdefault((name, lvl), torch.zeros(
            p0[lvl].shape, dtype=torch.bool, device=pts.device))
        return mark_patches(m, q, o, sel, win, ws)

    def in_bounds(q, lvl):
        H, W = p0[lvl].shape
        h = (win - 1) / 2.0
        return ((q[:, 0] >= h) & (q[:, 0] < W - h)
                & (q[:, 1] >= h) & (q[:, 1] < H - h))

    patches = 0
    for lvl in range(nl + 1):
        q = pts / 2.0 ** lvl
        o = window_origins(q, p0[lvl].shape, ws)
        track = valid & in_bounds(q, lvl)
        patches += mark("prev", lvl, q, o, track | (lvl == 0))
        patches += mark("prev_gx", lvl, q, o, track) + mark("prev_gy", lvl, q, o, track)
    o = window_origins(fwd.points, p0[0].shape, ws)
    track = good & in_bounds(fwd.points, 0)
    for name in ("next", "next_gx", "next_gy"):
        patches += mark(name, 0, fwd.points, o, track)
    planes = ([("next", nl)] * n_chunks + [("next", l) for l in range(nl - 1, -1, -1)]
              + [("prev", 0)] * min(n_chunks, 2))
    if len(calls) != len(planes):
        raise ValueError(f"{len(calls)} GN calls recorded, {len(planes)} expected")
    for (name, lvl), (o_call, steps) in zip(planes, calls):
        for p, a in steps:
            patches += mark(name, lvl, p, o_call, a)
    o_err = calls[len(planes) - min(n_chunks, 2) - 1][0]
    patches += mark("next", 0, fwd.points, o_err, torch.ones_like(valid))
    esize = p0[0].element_size()
    nbytes = (esize * sum(int(m.sum()) for m in masks.values())
              + N * (8 + 8 + 1 + 8 + 1 + 4))
    ops = patches * P * FLOPS_PER_SAMPLE
    ms, by = bound(nbytes, ops)
    return ms, by, nbytes, ops
