"""The LK Gauss-Newton iteration loop: CUDA kernel wrapper + plain version.

Port of ``ov2slam_tpu/ops/pallas_lk.py::lk_iterate`` (the JAX package's only
Pallas kernel), kept as its direct counterpart; the slice's KLT runs the
fused ``csrc/klt_track.cu`` (``ops/klt.py``) instead. ``lk_iterate`` keeps
its contract: up to ``n_iters`` GN steps for all N keypoints at once,
bilinear patch sampling inside each keypoint's integer-aligned ``ws x ws``
window, convergence at ``|delta| < eps``, a pause past ``margin`` from the
window centre, and a converged-while-active mask.

* For CUDA tensors it launches ``csrc/lk_iterate.cu`` (built at first use by
  ``ops/_build.py``) and counts the launch in ``LAUNCHES``; anything the
  kernel does not take raises. There is no fallback.
* For CPU tensors it runs ``lk_iterate_plain``, the same loop in plain torch,
  written as the JAX package's XLA loop (``ops/klt.py:200-226``): hat-weight
  bilinear sampling as batched einsums, masked GN steps. A frozen (inactive)
  point never changes, so stopping once no point is active — the XLA loop's
  ``any(active)`` exit — gives the same result as running all iterations.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

# kernel launches made by lk_iterate (a plain count; the slice's tracking
# runs the fused klt_track kernel instead, so there it stays 0)
LAUNCHES = 0

_FN = None


def hat_weights(q: torch.Tensor, size: int) -> torch.Tensor:
    """q (N, win) continuous positions -> (N, win, size) bilinear weights
    max(0, 1 - |j - q|): exactly two nonzero taps per row, zero outside
    [0, size - 1]."""
    j = torch.arange(size, dtype=q.dtype, device=q.device)
    return torch.clamp(1.0 - torch.abs(j[None, None, :] - q[..., None]),
                       min=0.0)


def sample_in_windows(windows: torch.Tensor, pos_in_win: torch.Tensor,
                      win: int) -> torch.Tensor:
    """Bilinear win x win patches inside per-keypoint windows.

    windows (N, ws, ws) or (C, N, ws, ws); pos_in_win (N, 2) patch centres in
    window coordinates. Returns (N, win*win) or (C, N, win*win)."""
    single = windows.dim() == 3
    if single:
        windows = windows[None]
    ws = windows.shape[-1]
    r = (win - 1) / 2.0
    offs = torch.arange(win, dtype=pos_in_win.dtype,
                        device=pos_in_win.device) - r
    Wx = hat_weights(pos_in_win[:, None, 0] + offs[None, :], ws)
    Wy = hat_weights(pos_in_win[:, None, 1] + offs[None, :], ws)
    p = torch.einsum("naj,cnjk,nbk->cnab", Wy, windows, Wx)
    p = p.reshape(p.shape[0], p.shape[1], win * win)
    return p[0] if single else p


def lk_iterate_plain(nwin, tmpl, gx, gy, gxx, gxy, gyy, inv_det, origins,
                     ctr, pts, active, win: int, n_iters: int, eps: float,
                     margin: float) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain-torch version of the kernel (the JAX XLA loop, klt.py:200-226).
    Returns (new_pts (N, 2), still_active (N,) bool, converged (N,) bool)."""
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


def _kernel_fn():
    global _FN
    if _FN is None:
        from ov2slam_tpu_torch.ops import _build
        lib = _build.load("lk_iterate")
        fn = lib.lk_iterate_launch
        fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 4
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"lk_iterate: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"lk_iterate: {name} must have shape {tuple(shape)}, "
            f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"lk_iterate: {name} is on {t.device}, "
                         f"expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"lk_iterate: {name} must be contiguous")


def lk_iterate(nwin, tmpl, gx, gy, gxx, gxy, gyy, inv_det, origins, ctr, pts,
               active, win: int, n_iters: int, eps: float, margin: float):
    """Run up to `n_iters` LK GN iterations for all N keypoints.

    nwin (N, ws, ws) f32 windows of the next image; tmpl/gx/gy (N, win*win)
    f32 template patch and gradients; gxx/gxy/gyy/inv_det (N,) f32;
    origins (N, 2) int32 window origins (x, y); ctr, pts (N, 2) f32;
    active (N,) bool. Returns (new_pts (N, 2), still_active (N,) bool,
    converged (N,) bool). Arguments the kernel does not take raise, on
    every device."""
    global LAUNCHES
    if nwin.dim() != 3 or nwin.shape[1] != nwin.shape[2]:
        raise ValueError(f"lk_iterate: nwin must be (N, ws, ws), "
                         f"got {tuple(nwin.shape)}")
    N, ws = nwin.shape[0], nwin.shape[1]
    P = win * win
    dev = nwin.device
    f32 = torch.float32
    for name, t, dt, shape in (
            ("nwin", nwin, f32, (N, ws, ws)), ("tmpl", tmpl, f32, (N, P)),
            ("gx", gx, f32, (N, P)), ("gy", gy, f32, (N, P)),
            ("gxx", gxx, f32, (N,)), ("gxy", gxy, f32, (N,)),
            ("gyy", gyy, f32, (N,)), ("inv_det", inv_det, f32, (N,)),
            ("origins", origins, torch.int32, (N, 2)),
            ("ctr", ctr, f32, (N, 2)), ("pts", pts, f32, (N, 2)),
            ("active", active, torch.bool, (N,))):
        _check(name, t, dt, shape, dev)
    if dev.type == "cpu":
        return lk_iterate_plain(nwin, tmpl, gx, gy, gxx, gxy, gyy, inv_det,
                                origins, ctr, pts, active, win, n_iters, eps,
                                margin)
    if dev.type != "cuda":
        raise ValueError(f"lk_iterate: no kernel for device {dev}")
    if P > 256 or 4 * ws * ws * 4 > 48 * 1024:
        raise ValueError(f"lk_iterate: win={win}, ws={ws} exceed the "
                         "kernel's limits (win*win <= 256, ws <= 54)")
    out_pts = torch.empty((N, 2), dtype=f32, device=dev)
    out_act = torch.empty((N,), dtype=torch.bool, device=dev)
    out_conv = torch.empty((N,), dtype=torch.bool, device=dev)
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(nwin.data_ptr(), tmpl.data_ptr(), gx.data_ptr(),
                 gy.data_ptr(), gxx.data_ptr(), gxy.data_ptr(), gyy.data_ptr(),
                 inv_det.data_ptr(), origins.data_ptr(), ctr.data_ptr(),
                 pts.data_ptr(), active.data_ptr(), out_pts.data_ptr(),
                 out_act.data_ptr(), out_conv.data_ptr(), N, ws, win,
                 int(n_iters), float(eps), float(margin), stream)
    if err != 0:
        raise RuntimeError(f"lk_iterate kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out_pts, out_act, out_conv
