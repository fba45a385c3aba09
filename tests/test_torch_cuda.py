"""GPU-only tests of the port: the CUDA LK kernel against its plain version,
and tracking through the kernel against the CPU path.

This file imports neither jax nor OpenCV, so it runs on a GPU machine that
has neither (``tests/conftest.py`` imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Elsewhere every test skips. Tolerances: points whose convergence decision
agrees, and that stopped, to 2e-3 px; every point to eps (one sub-eps GN
step, or an oscillating point still iterating at the end of the budget);
masks equal on 99% of points. Full tracking through the kernel vs the CPU
plain path: status equal on 99%, points to 1e-2 px (the pyramid filters
and window sampling also run on the card, in another summation order).
"""

import numpy as np
import pytest
import torch

import synthetic_np as synp
import torch_parity  # noqa: F401
from ov2slam_tpu_torch.ops import image as im
from ov2slam_tpu_torch.ops import klt, lk

WIN, WS, EPS, MARGIN = 9, 20, 0.01, 4.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from ov2slam_tpu_torch import device
    device.set_precision_policy()
    return torch.device("cuda", 0)


def _lk_inputs(N, seed):
    """Seeded LK inputs at the slice's window shapes (ws=20, win=9)."""
    rng = np.random.default_rng(seed)
    H, W = 240, 320
    img0 = im.gaussian_blur(torch.from_numpy(
        rng.uniform(0, 255, (H, W)).astype(np.float32)), 1.5)
    img1 = torch.roll(img0, shifts=(1, 2), dims=(0, 1)) + torch.from_numpy(
        rng.normal(0, 1.0, (H, W)).astype(np.float32))
    pts = torch.from_numpy(np.stack([rng.uniform(WS, W - WS, N),
                                     rng.uniform(WS, H - WS, N)], -1)
                           .astype(np.float32))
    gx_img, gy_img = im.scharr_gradients(img0)
    o = torch.clamp(torch.round(pts).int() - WS // 2, min=0)
    ar = torch.arange(WS)
    rows = (o[:, 1].long()[:, None] + ar)[:, :, None]
    cols = (o[:, 0].long()[:, None] + ar)[:, None, :]
    tmpl, gx, gy = lk.sample_in_windows(
        torch.stack([img0[rows, cols], gx_img[rows, cols], gy_img[rows, cols]]),
        pts - o.float(), WIN)
    gxx, gxy, gyy = (gx * gx).sum(-1), (gx * gy).sum(-1), (gy * gy).sum(-1)
    det = gxx * gyy - gxy * gxy
    inv_det = torch.where(det.abs() > 1e-12, 1.0 / det, torch.zeros_like(det))
    return [img1[rows, cols], tmpl, gx, gy, gxx, gxy, gyy, inv_det, o,
            o.float() + WS // 2, pts, torch.ones(N, dtype=torch.bool)]


def _assert_lk_close(p, a, c, pr, ar_, cr, atol=2e-3, agree=0.99):
    p, a, c, pr, ar_, cr = (x.cpu().numpy() for x in (p, a, c, pr, ar_, cr))
    stopped = (a == ar_) & (c == cr) & ~(a & ar_)
    err = np.abs(p - pr).max(-1)
    assert err[stopped].max(initial=0.0) <= atol
    assert err.max() <= EPS
    assert (a == ar_).mean() >= agree and (c == cr).mean() >= agree


@pytest.mark.cuda
@pytest.mark.parametrize("N", [192, 320])
def test_kernel_matches_plain_on_card(cuda, N):
    args = [x.contiguous().to(cuda) for x in _lk_inputs(N, seed=N)]
    before = lk.LAUNCHES
    for n_iters in (1, 10, 30):
        kw = dict(win=WIN, n_iters=n_iters, eps=EPS, margin=MARGIN)
        out = lk.lk_iterate(*args, **kw)
        ref = lk.lk_iterate_plain(*args, **kw)
        torch.cuda.synchronize()
        _assert_lk_close(*out, *ref)
    assert lk.LAUNCHES == before + 3


@pytest.mark.cuda
def test_kernel_frozen_and_empty_inputs(cuda):
    args = [x.contiguous().to(cuda) for x in _lk_inputs(64, seed=1)]
    args[11] = torch.zeros_like(args[11])           # no point active
    p, a, c = lk.lk_iterate(*args, win=WIN, n_iters=10, eps=EPS, margin=MARGIN)
    assert torch.equal(p, args[10]) and not a.any() and not c.any()
    empty = [x[:0].contiguous() for x in args]
    p, a, c = lk.lk_iterate(*empty, win=WIN, n_iters=10, eps=EPS, margin=MARGIN)
    torch.cuda.synchronize()
    assert p.shape == (0, 2)


@pytest.mark.cuda
def test_fb_klt_through_kernel_matches_cpu(cuda):
    fl, fr, _ = synp.render_sequence(n_frames=2, step=0.05)
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(30, 722, 192), rng.uniform(30, 450, 192)],
                   -1).astype(np.float32)
    valid = np.ones(192, bool)
    out = {}
    for dev in ("cpu", cuda):
        p0 = im.build_pyramid(torch.from_numpy(fl[0]).to(dev), 3)
        p1 = im.build_pyramid(torch.from_numpy(fl[1]).to(dev), 3)
        before = lk.LAUNCHES
        r = klt.fb_klt_tracking(p0, p1, torch.from_numpy(pts).to(dev),
                                torch.from_numpy(pts).to(dev),
                                torch.from_numpy(valid).to(dev))
        out[str(dev)] = (r, lk.LAUNCHES - before)
    (rc, n_cpu), (rg, n_gpu) = out["cpu"], out[str(cuda)]
    assert n_cpu == 0 and n_gpu == 8      # 3 + 1 + 1 + 1 forward, 2 backward
    sc, sg = rc.status.numpy(), rg.status.cpu().numpy()
    assert sc.sum() > 100 and (sc == sg).mean() >= 0.99
    both = sc & sg
    np.testing.assert_allclose(rg.points.cpu().numpy()[both],
                               rc.points.numpy()[both], atol=1e-2)
