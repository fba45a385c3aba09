"""The arithmetic of the cell-block Gauss-Newton step, emulated in numpy
float32, against the per-sample step of ``lk.lk_iterate_plain`` (the JAX
package's XLA loop): on windows cut from ``tests/klt_inputs.py`` frames,
where it was measured for ``csrc/klt_track.cu`` (``PERF.md`` §6; that
kernel keeps the per-sample step, because the cell-block one's last-bit
changes moved a smoke gate), and on the card tests' seeded windows of
``csrc/lk_iterate.cu``, which runs it.

All win x win samples of a patch sit at integer offsets from its top-left
tap (half-integer from its centre for an even win), so they share one
fractional part (fx, fy) and four bilinear weights w_jk that sum to 1, and

    b_x = sum_d (I(d) - T(d)) gx(d) = sum_jk w_jk C^x(cell + (j, k)),
    C^x(s) = sum_d (W[s + d] - T(d)) gx(d),  W zero outside the window.

A refresh computes C^x and C^y at the 4x4 integer shifts around the
point's cell, which cover its 3x3 block of cells; a step whose cell lies
in the block blends four of them; a step that leaves it refreshes first,
and every call (a new window) starts with a refresh: ``lk_iterate.cu``'s
policy. The steps must agree
with the per-sample ones to 1e-5 px, with equal active and converged
masks after every step and equal step counts.
"""

import numpy as np
import pytest
import torch

import klt_inputs
import synthetic_np as syn
import torch_parity  # noqa: F401  (caps torch's CPU threads)
from ov2slam_tpu_torch.ops import klt, lk
from test_torch_cuda import EPS as LK_EPS
from test_torch_cuda import MARGIN as LK_MARGIN
from test_torch_cuda import WIN as LK_WIN
from test_torch_cuda import _lk_inputs

PTS_TOL = 1e-5
N_POINTS = 32


def refresh(W, t, gx, gy, win, bx0, by0):
    """(M, 2, 4, 4) correlations C^{x,y}[k, i] at shifts (bx0 + i, by0 + k)
    of M points' windows W (M, ws, ws); taps outside a window read 0."""
    M, ws = W.shape[0], W.shape[-1]
    ar = np.arange(4)[:, None] + np.arange(win)[None, :]          # (4, win)
    rows = by0[:, None, None] + ar[None]                           # (M, 4, win)
    cols = bx0[:, None, None] + ar[None]
    rin, cin = (rows >= 0) & (rows < ws), (cols >= 0) & (cols < ws)
    m = np.arange(M)[:, None, None, None, None]
    V = W[m, np.clip(rows, 0, ws - 1)[:, :, None, :, None],
          np.clip(cols, 0, ws - 1)[:, None, :, None, :]]          # (M, k, i, a, b)
    V = np.where(rin[:, :, None, :, None] & cin[:, None, :, None, :], V,
                 np.float32(0))
    d = V - t.reshape(M, 1, 1, win, win)
    cx = np.sum(d * gx.reshape(M, 1, 1, win, win), axis=(-2, -1), dtype=np.float32)
    cy = np.sum(d * gy.reshape(M, 1, 1, win, win), axis=(-2, -1), dtype=np.float32)
    return np.stack([cx, cy], 1)


def cell_steps(nwin, tmpl, gx, gy, gxx, gxy, gyy, inv_det, origins, ctr,
               starts, active, win, eps, margin):
    """lk_iterate's loop with the cell-block step, float32, each step taken
    from the point in `starts` (the per-sample loop's point before that
    step), so that both steps are taken from one point. Returns per step
    its (delta, active, converged), and the refreshes made."""
    f = np.float32
    N = nwin.shape[0]
    r = f((win - 1) / 2.0)
    o = origins.astype(f)
    a = active.copy()
    cv = np.zeros(N, bool)
    C = np.zeros((N, 2, 4, 4), f)
    base = np.full((N, 2), -(10 ** 6), np.int64)      # no block: refresh first
    out, refreshes = [], 0
    n = np.arange(N)
    for p in starts:
        ax, ay = (p[:, 0] - o[:, 0]) - r, (p[:, 1] - o[:, 1]) - r
        fcx, fcy = np.floor(ax), np.floor(ay)
        cx, cy = fcx.astype(np.int64), fcy.astype(np.int64)
        j0, k0 = cx - base[:, 0], cy - base[:, 1]
        stale = a & ((j0 < 0) | (j0 > 2) | (k0 < 0) | (k0 > 2))
        if stale.any():
            s = np.nonzero(stale)[0]
            base[s, 0], base[s, 1] = cx[s] - 1, cy[s] - 1
            C[s] = refresh(nwin[s], tmpl[s], gx[s], gy[s], win, base[s, 0],
                           base[s, 1])
            refreshes += len(s)
            j0, k0 = cx - base[:, 0], cy - base[:, 1]
        fx, fy = ax - fcx, ay - fcy
        j0, k0 = np.clip(j0, 0, 2), np.clip(k0, 0, 2)   # inactive: unused

        def blend(g):
            c = C[n, g]
            return ((f(1) - fy) * ((f(1) - fx) * c[n, k0, j0] + fx * c[n, k0, j0 + 1])
                    + fy * ((f(1) - fx) * c[n, k0 + 1, j0] + fx * c[n, k0 + 1, j0 + 1]))
        bx, by = blend(0), blend(1)
        dx = -(gyy * bx - gxy * by) * inv_det
        dy = -(-gxy * bx + gxx * by) * inv_det
        step = np.where(a[:, None], np.stack([dx, dy], -1), f(0))
        conv = np.sum(step * step, -1) < f(eps * eps)
        dev = np.max(np.abs(p + step - ctr), -1)
        cv = cv | (a & conv)
        a = a & ~conv & (dev <= f(margin))
        out.append((step, a.copy(), cv.copy()))
    return out, refreshes


def plain_steps(args, win, n_iters, eps, margin):
    """lk_iterate_plain one step at a time. Returns per step the point it
    starts from, its per-sample delta (lk_iterate_plain's formulas; the
    point plus it is lk_iterate_plain's next point, checked) and the
    active and converged masks after it."""
    nwin, tmpl, gx, gy, gxx, gxy, gyy, inv_det, o, ctr, p, a = args
    cv = torch.zeros_like(a)
    out = []
    for _ in range(n_iters):
        if not bool(a.any()):
            break
        diff = lk.sample_in_windows(nwin, p - o.to(p.dtype), win) - tmpl
        bx, by = torch.sum(diff * gx, -1), torch.sum(diff * gy, -1)
        d = torch.stack([-(gyy * bx - gxy * by) * inv_det,
                         -(-gxy * bx + gxx * by) * inv_det], -1)
        d = torch.where(a[:, None], d, torch.zeros_like(d))
        q, a_next, c = lk.lk_iterate_plain(*args[:10], p, a, win=win,
                                           n_iters=1, eps=eps, margin=margin)
        assert torch.equal(q, p + d)
        cv = cv | c
        out.append((p.numpy(), d.numpy(), a_next.numpy(), cv.numpy()))
        p, a = q, a_next
    return out


def captured_calls(prev_pts=None, prior=None, win=9, N=N_POINTS):
    """Every lk_fn call of fb_klt_tracking_plain on the slice's temporal
    pair (levels, chunks, the backward track): its arguments and keywords.
    prev_pts / prior replace the detected corners and their priors."""
    fl, fr, _ = _frames()
    args, kw = klt_inputs.klt_case((fl, fr), N, "temporal", 1.5,
                                   torch.device("cpu"))
    if prev_pts is not None:
        n = prev_pts.shape[0]
        args = (args[0], args[1], torch.tensor(prev_pts, dtype=torch.float32),
                torch.tensor(prior, dtype=torch.float32),
                torch.ones(n, dtype=torch.bool))
    calls = []

    def rec(*a, **k):
        calls.append((a, k))
        return lk.lk_iterate_plain(*a, **k)
    klt.fb_klt_tracking_plain(*args, **dict(kw, win=win), lk_fn=rec)
    return calls


_FRAMES = {}


def _frames():
    if not _FRAMES:
        _FRAMES["f"] = syn.render_sequence(n_frames=2, step=0.05)
    return _FRAMES["f"]


def compare(calls, select=None):
    """Run every captured call both ways (the points of `select` only);
    returns (refreshes, steps taken, per-call step records of the plain
    version). The two agree on every step, and the per-sample loop stops
    where the cell-block loop's masks say it stops: equal step counts."""
    refreshes = steps = 0
    records = []
    for a, k in calls:
        a = list(a)
        if select is not None:
            keep = select(a, k)
            if not keep.any():
                continue
            a = [x[keep] for x in a]
        ref = plain_steps(a, **k)
        x = [v.numpy() for v in a]
        emu, nref = cell_steps(*x[:10], [r[0] for r in ref], x[11],
                               k["win"], k["eps"], k["margin"])
        active = x[11]
        for (de, ae, ce), (_, dp, ap, cp) in zip(emu, ref):
            assert np.abs(de - dp).max() <= PTS_TOL, np.abs(de - dp).max()
            assert (ae == ap).all() and (ce == cp).all()
            steps += int(active.sum())
            active = ap
        refreshes += nref
        records.append((a, k, ref))
    return refreshes, steps, records


def border_select(a, k):
    """Points whose patch, at their first step, reaches past their window."""
    p, o, ws = a[10].numpy(), a[8].numpy(), a[0].shape[-1]
    q = p - o
    r = (k["win"] - 1) / 2.0
    return torch.from_numpy(((q - r < 0) | (q + r + 1 > ws - 1)).any(-1)
                            & a[11].numpy())


def oscillating_point(calls):
    """(call, point) of the point that most often steps back into the cell
    it left one step before (cell A, then B, then A again), and how often."""
    best = (0, None)
    for a, k in calls:
        r = np.float32((k["win"] - 1) / 2.0)
        o = a[8].numpy().astype(np.float32)
        ref = plain_steps(list(a), **k)
        if len(ref) < 3:
            continue
        cells = np.stack([np.floor(p - o - r) for p, _, _, _ in ref])
        act = np.stack([ac for _, _, ac, _ in ref])
        back = ((cells[2:] == cells[:-2]).all(-1)
                & (cells[1:-1] != cells[:-2]).any(-1) & act[1:-1]).sum(0)
        i = int(back.argmax())
        if back[i] > best[0]:
            best = (int(back[i]), (a, k, i))
    return best


@pytest.mark.parametrize("case", ["win9", "win8", "border", "oscillating",
                                  "lk_iterate"])
def test_cell_block_step_matches_per_sample_step(case):
    if case == "lk_iterate":
        # csrc/lk_iterate.cu's own inputs: the card tests' seeded windows
        args = _lk_inputs(64, seed=64)
        kw = dict(win=LK_WIN, n_iters=30, eps=LK_EPS, margin=LK_MARGIN)
        refreshes, steps, _ = compare([(args, kw)])
        assert steps > 150 and refreshes < 0.6 * steps, (refreshes, steps)
    elif case in ("win9", "win8"):
        calls = captured_calls(win=9 if case == "win9" else 8)
        refreshes, steps, _ = compare(calls)
        # the block saves most patch samplings
        assert steps > 300 and refreshes < 0.6 * steps, (refreshes, steps)
    elif case == "border":
        # templates 5 px inside the right and bottom edges, priors past
        # them: the clamped windows put the first steps' taps outside
        W, H = syn.W, syn.H
        prev = np.array([[W - 5.0, 200.3], [300.2, H - 5.0], [W - 6.0, H - 6.0]])
        prior = prev + np.array([[2.6, 0.4], [-0.3, 2.7], [2.2, 2.4]])
        calls = captured_calls(prev, prior)
        refreshes, steps, _ = compare(calls, border_select)
        assert steps >= 3 and refreshes >= 3, (refreshes, steps)
    else:
        n_back, (a, k, i) = oscillating_point(captured_calls())
        assert n_back >= 2, n_back
        refreshes, steps, _ = compare([(a, k)], lambda a_, k_: torch.arange(
            a_[0].shape[0]) == i)
        assert refreshes >= 1 and steps >= 3
