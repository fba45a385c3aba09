"""GPU-only tests of the port: the CUDA kernels (the per-chunk LK loop
``lk_iterate`` and the fused forward-backward KLT ``klt_track``) against
their plain versions, tracking through the kernel against the CPU path, the
plain-PyTorch RANSACs and CLAHE on the card against the CPU, and the
command-line entry point on the card by default.

This file imports neither jax nor OpenCV, so it runs on a GPU machine that
has neither (``tests/conftest.py`` imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Elsewhere every test skips. Tolerances: points whose convergence decision
agrees, and that stopped, to 2e-3 px; every point to eps (one sub-eps GN
step, or an oscillating point still iterating at the end of the budget);
masks equal on 99% of points. The fused KLT against fb_klt_tracking_plain
on the same inputs on the card: status equal on 99%, points to 2e-3 px and
error to 1e-3 where both tracked (the same f32 GN steps in another
summation order; LK resolves 0.01 px). Full tracking through the kernel vs
the CPU plain path: status equal on 99%, points to 1e-2 px (the pyramid
filters also run on the card, in another summation order). RANSACs on the
card vs the CPU with the same sample indices (cuSOLVER and LAPACK round the
batched solves differently, so valid 5-point models may differ in which
roots they hold): inlier masks equal on 99%, rotation within 1e-3 rad,
translation direction within 1e-2 rad. CLAHE: 1e-2 gray levels.
"""

import numpy as np
import pytest
import torch

import klt_inputs
import synthetic_np as synp
import torch_parity  # noqa: F401
from ov2slam_tpu_torch.ops import image as im
from ov2slam_tpu_torch.ops import klt, lk

WIN, WS, EPS, MARGIN = 9, 20, 0.01, 4.0


@pytest.fixture(scope="module")
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


@pytest.fixture(scope="module")
def frames(cuda):
    fl, fr, _ = synp.render_sequence(n_frames=4, step=0.05)
    return fl, fr


@pytest.mark.cuda
@pytest.mark.parametrize("N", [192, 320])
@pytest.mark.parametrize("pair,jitter", [("temporal", 0.0), ("temporal", 1.5),
                                         ("keyframe", 1.5), ("stereo", 0.0)])
def test_klt_track_matches_plain_on_card(cuda, frames, N, pair, jitter):
    args, kw = klt_inputs.klt_case(frames, N, pair, jitter, cuda)
    before = klt.LAUNCHES
    r = klt.fb_klt_tracking(*args, **kw)
    rp = klt.fb_klt_tracking_plain(*args, **kw)
    torch.cuda.synchronize()
    assert klt.LAUNCHES == before + 1
    s, sp = r.status.cpu().numpy(), rp.status.cpu().numpy()
    assert sp.sum() > 100 and (s == sp).mean() >= 0.99
    both = s & sp
    np.testing.assert_allclose(r.points.cpu().numpy()[both],
                               rp.points.cpu().numpy()[both], atol=2e-3)
    np.testing.assert_allclose(r.error.cpu().numpy()[both],
                               rp.error.cpu().numpy()[both], atol=1e-3)


@pytest.mark.cuda
def test_klt_track_empty_and_invalid(cuda, frames):
    args, kw = klt_inputs.klt_case(frames, 192, "temporal", 1.5, cuda)
    p0, p1, pts, prior, valid = args
    r = klt.fb_klt_tracking(p0, p1, pts, prior, torch.zeros_like(valid), **kw)
    torch.cuda.synchronize()
    assert torch.equal(r.points, prior) and not r.status.any()
    r = klt.fb_klt_tracking(p0, p1, pts[:0], prior[:0], valid[:0], **kw)
    assert r.points.shape == (0, 2) and r.status.shape == (0,)


@pytest.mark.cuda
def test_fb_klt_through_kernel_matches_cpu(cuda, frames):
    fl, fr = frames
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(30, 722, 192), rng.uniform(30, 450, 192)],
                   -1).astype(np.float32)
    valid = np.ones(192, bool)
    out = {}
    for dev in ("cpu", cuda):
        p0 = im.build_pyramid(torch.from_numpy(fl[0]).to(dev), 3)
        p1 = im.build_pyramid(torch.from_numpy(fl[1]).to(dev), 3)
        before = (klt.LAUNCHES, lk.LAUNCHES)
        r = klt.fb_klt_tracking(p0, p1, torch.from_numpy(pts).to(dev),
                                torch.from_numpy(pts).to(dev),
                                torch.from_numpy(valid).to(dev))
        out[str(dev)] = (r, klt.LAUNCHES - before[0], lk.LAUNCHES - before[1])
    (rc, n_cpu, lk_cpu), (rg, n_gpu, lk_gpu) = out["cpu"], out[str(cuda)]
    assert n_cpu == 0 and n_gpu == 1      # one fused launch per call
    assert lk_cpu == lk_gpu == 0
    sc, sg = rc.status.numpy(), rg.status.cpu().numpy()
    assert sc.sum() > 100 and (sc == sg).mean() >= 0.99
    both = sc & sg
    np.testing.assert_allclose(rg.points.cpu().numpy()[both],
                               rc.points.numpy()[both], atol=1e-2)


def _rot(w):
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _angle(R):
    return float(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))


def _two_view_scene(seed=23, N=200, n_out=60):
    """Bearings of a general scene in two views (b-to-a pose R, t), 0.3 px
    noise, n_out outliers; numpy only."""
    rng = np.random.default_rng(seed)
    X = np.c_[rng.uniform(-3, 3, (N, 2)), 6.0 + rng.uniform(0, 3, N)]
    R, t = _rot(rng.normal(size=3) * 0.3), rng.normal(size=3)
    Xb = (X - t) @ R                                  # R^T (X - t)
    bv_a = X / np.linalg.norm(X, axis=1, keepdims=True)
    bv_b = Xb / np.linalg.norm(Xb, axis=1, keepdims=True)
    bv_b = bv_b + rng.normal(0, 0.3 / 450.0, bv_b.shape)
    out = rng.choice(N, n_out, replace=False)
    Y = np.c_[rng.uniform(-3, 3, (n_out, 2)), 6.0 + rng.uniform(0, 3, n_out)]
    bv_b[out] = Y / np.linalg.norm(Y, axis=1, keepdims=True)
    bv_b /= np.linalg.norm(bv_b, axis=1, keepdims=True)
    return bv_a.astype(np.float32), bv_b.astype(np.float32), R, t


def _cpu_and_card(fn, cuda, *arrays):
    out = {}
    for dev in ("cpu", cuda):
        out[str(dev)] = fn(*(torch.from_numpy(np.asarray(a)).to(dev)
                             for a in arrays))
    torch.cuda.synchronize()
    return out["cpu"], out[str(cuda)]


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["nister", "8pt"])
def test_essential_ransac_on_card_matches_cpu(cuda, solver):
    from ov2slam_tpu_torch.ops import mvg
    bv_a, bv_b, R, t = _two_view_scene()
    valid = np.ones(len(bv_a), bool)
    s = 5 if solver == "nister" else 8
    idx = np.random.default_rng(1).integers(0, len(bv_a), (256, s))

    def run(a, b, v, i):
        r = mvg.essential_ransac(a, b, v, 3.0 / 450.0, idx=i, solver=solver)
        T = mvg.decompose_essential(r.model, a, b, r.inliers)
        return r, T

    (rc, Tc), (rg, Tg) = _cpu_and_card(run, cuda, bv_a, bv_b, valid, idx)
    assert bool(rc.success) and bool(rg.success)
    ic, ig = rc.inliers.numpy(), rg.inliers.cpu().numpy()
    assert (ic == ig).mean() >= 0.99
    assert _angle(Tc.R.numpy().T @ Tg.R.cpu().numpy()) < 1e-3
    cos = abs(float(Tc.t.numpy() @ Tg.t.cpu().numpy()))
    assert np.arccos(min(cos, 1.0)) < 1e-2
    assert _angle(Tg.R.cpu().numpy().T @ R) < 0.03


@pytest.mark.cuda
def test_p3p_ransac_on_card_matches_cpu(cuda):
    from ov2slam_tpu_torch.ops import mvg
    rng = np.random.default_rng(15)
    N = 150
    Xc = np.c_[rng.uniform(-3, 3, (N, 2)), 6.0 + rng.uniform(0, 3, N)]
    R, t = _rot(rng.normal(size=3) * 0.8), rng.normal(size=3)
    Xw = ((Xc - t) @ R).astype(np.float32)           # Xc = R Xw + t
    bv = Xc / np.linalg.norm(Xc, axis=1, keepdims=True)
    bv = bv + rng.normal(0, 0.3 / 450.0, bv.shape)
    out = rng.choice(N, 45, replace=False)
    bv[out] = rng.normal(size=(45, 3)) * 0.1 + [0, 0, 1]
    bv = (bv / np.linalg.norm(bv, axis=1, keepdims=True)).astype(np.float32)
    idx = rng.integers(0, N, (256, 3))

    def run(X, b, v, i):
        return mvg.p3p_ransac(X, b, v, 3.0 / 450.0, idx=i)

    (Tc, ic, _, okc), (Tg, ig, _, okg) = _cpu_and_card(
        run, cuda, Xw, bv, np.ones(N, bool), idx)
    assert bool(okc) and bool(okg)
    assert (ic.numpy() == ig.cpu().numpy()).mean() >= 0.99
    assert _angle(Tc.R.numpy().T @ Tg.R.cpu().numpy()) < 1e-3
    np.testing.assert_allclose(Tg.t.cpu().numpy(), Tc.t.numpy(), atol=1e-2)
    assert _angle(Tg.R.cpu().numpy().T @ R) < 0.02


@pytest.mark.cuda
def test_ransacs_and_clahe_never_wait_for_the_card(cuda):
    """Given their sample indices on the card, both RANSACs and CLAHE
    enqueue their work without one host sync (PyTorch's sync debug mode
    raises on the first). The first call builds the constant tables."""
    from ov2slam_tpu_torch.ops import mvg
    bv_a, bv_b, _, _ = _two_view_scene()
    a, b = (torch.from_numpy(x).to(cuda) for x in (bv_a, bv_b))
    v = torch.ones(len(bv_a), dtype=torch.bool, device=cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    i5, i8, i3 = (mvg.draw_samples(v, 64, s, gen) for s in (5, 8, 3))
    img = torch.rand(203, 317, device=cuda) * 255.0
    calls = [lambda: mvg.essential_ransac(a, b, v, 3.0 / 450.0, idx=i5),
             lambda: mvg.essential_ransac(a, b, v, 3.0 / 450.0, idx=i8,
                                          solver="8pt", lmeds=True),
             lambda: mvg.p3p_ransac(a * 7.0, b, v, 3.0 / 450.0, idx=i3),
             lambda: im.clahe(img)]
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fn in calls:
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_clahe_on_card_matches_cpu(cuda, frames):
    img = frames[0][0]
    for shape in ((480, 752), (203, 317)):
        a = np.ascontiguousarray(img[:shape[0], :shape[1]])
        oc, og = _cpu_and_card(lambda x: im.clahe(x, clip_limit=3.0), cuda, a)
        assert np.abs(og.cpu().numpy() - oc.numpy()).max() <= 1e-2


@pytest.mark.cuda
def test_fast_score_and_remap_on_card_match_cpu(cuda, frames):
    """FAST-9 scores (exact float32 differences and minima: 1e-4) and the
    bicubic rectification remap (1e-3 gray levels) on the card against the
    CPU."""
    from ov2slam_tpu_torch.core import camera as cam_mod
    from ov2slam_tpu_torch.ops import detect
    img = np.ascontiguousarray(frames[0][0], np.float32)
    sc, sg = _cpu_and_card(lambda x: detect.fast_score(x, 10.0), cuda, img)
    assert (sc > 0).sum() > 100
    np.testing.assert_allclose(sg.cpu().numpy(), sc.numpy(), atol=1e-4, rtol=0)
    cam = cam_mod.Camera.make("pinhole", 458.0, 457.0, 367.0, 248.0,
                              [-0.28, 0.07, 2e-4, 2e-5], 752, 480)
    R1, _, K_new, _ = cam_mod.stereo_rectify(
        cam, cam, _rot([0.01, -0.02, 0.005]), np.array([-0.11, 0.001, 0.0]))
    grid = cam_mod.compute_undist_rect_map(cam, R_rect=R1, K_new=K_new)
    oc, og = _cpu_and_card(im.remap_bicubic, cuda, img, grid.numpy())
    np.testing.assert_allclose(og.cpu().numpy(), oc.numpy(), atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_pipelined_stereo_on_card_matches_cpu(cuda):
    """force_realtime on the card against the CPU on the same 30 frames
    and the same fixed lags: every frame logged, keyframe counts within
    one, ATEs within 1 mm, frames within 5 mm (the local BA's segment sums
    add in another order on the card than on the CPU, so the two runs round
    differently), and one
    klt_track launch per tracking call plus one per keyframe's stereo
    match."""
    from ov2slam_tpu_torch.config import SlamParams
    from ov2slam_tpu_torch.io.trajectories import ate_rmse
    from ov2slam_tpu_torch.slam import mapper
    from ov2slam_tpu_torch.slam.manager import SlamSystem
    n = 30
    fl, fr, gt = synp.render_sequence(n_frames=n, step=0.05)
    gt_t = np.stack([T[:3, 3] for T in gt])
    d = synp.slam_params_dict()
    d["force_realtime"] = 1
    real_kf_step, kf_steps = mapper.kf_step, []
    mapper.kf_step = lambda *a, **k: kf_steps.append(1) or real_kf_step(*a, **k)
    runs = {}
    try:
        for dev in ("cpu", cuda):
            s = SlamSystem(SlamParams.from_dict(d), device=dev)
            k0, kf0 = klt.LAUNCHES, len(kf_steps)
            for i in range(n):
                s.process_stereo(fl[i], fr[i], i * 0.05)
            s.flush()
            runs[str(dev)] = (np.stack(s.logger.poses_wc)[:, :3, 3],
                              len(s.map.keyframes), s.pipeline_counts,
                              klt.LAUNCHES - k0, len(kf_steps) - kf0)
    finally:
        mapper.kf_step = real_kf_step
    (ec, nc, _, lc, _), (eg, ng, pg, lg, kg) = runs["cpu"], runs[str(cuda)]
    assert eg.shape == (n, 3) and np.isfinite(eg).all()
    assert abs(ng - nc) <= 1 and pg["kf_commit_lag"] >= 1 and pg["ba_writeback"] >= 1
    assert abs(ate_rmse(eg, gt_t) - ate_rmse(ec, gt_t)) <= 1e-3
    assert np.linalg.norm(eg - ec, axis=1).max() <= 5e-3
    assert lc == 0 and lg == (n - 1) + kg


def _chain_graph(seed, n=12, pad=4):
    """A drifted n-node pose chain with a loop edge at the true relative
    pose (numpy, no JAX): PoseGraphProblem fields as numpy arrays."""
    from ov2slam_tpu_torch.core import lie
    rng = np.random.default_rng(seed)
    step = lie.se3_exp(torch.tensor([0.25, 0, 0, 0, 2 * np.pi / n, 0]))
    gt = [torch.eye(4)]
    for _ in range(1, n):
        gt.append(step.matrix() @ gt[-1])
    dr = [gt[0]]
    for i in range(1, n):
        rel = gt[i] @ torch.linalg.inv(gt[i - 1])
        noise = lie.se3_exp(torch.from_numpy(np.concatenate([
            rng.normal(0, 0.01, 3), rng.normal(0, 0.002, 3)]).astype(np.float32)))
        dr.append(noise.matrix() @ rel @ dr[-1])
    edges = [(i, i - 1, dr[i] @ torch.linalg.inv(dr[i - 1])) for i in range(1, n)]
    edges.append((n - 1, 0, gt[n - 1] @ torch.linalg.inv(gt[0])))
    E = len(edges) + pad
    meas = torch.eye(4).repeat(E, 1, 1)
    meas[:len(edges)] = torch.stack([m for _, _, m in edges])
    T = torch.stack(dr)
    ei = torch.zeros(E, dtype=torch.int64)
    ej = torch.zeros(E, dtype=torch.int64)
    ei[:len(edges)] = torch.tensor([i for i, _, _ in edges])
    ej[:len(edges)] = torch.tensor([j for _, j, _ in edges])
    w = torch.zeros(E)
    w[:len(edges)] = 1.0
    return (T[:, :3, :3], T[:, :3, 3], torch.arange(n) > 0, ei, ej,
            meas[:, :3, :3], meas[:, :3, 3], w)


@pytest.mark.cuda
def test_pose_graph_on_card_matches_cpu(cuda):
    """solve_pose_graph (single and batched) on the card against the CPU:
    poses within 1e-4 (index_add_ atomics on the card sum in another
    order), and no host sync inside the solve."""
    from ov2slam_tpu_torch.opt import posegraph as pg
    probs = [pg.PoseGraphProblem(*_chain_graph(s)) for s in (0, 1)]
    batch = pg.PoseGraphProblem(*(torch.stack(f) for f in zip(*probs)))
    for prob in (probs[0], batch):
        oc = pg.solve_pose_graph(prob, max_iters=10)
        on_card = pg.PoseGraphProblem(*(a.to(cuda) for a in prob))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            og = pg.solve_pose_graph(on_card, max_iters=10)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert float(og.cost.max()) < 0.5 * float(og.cost0.min())
        np.testing.assert_allclose(og.R.cpu().numpy(), oc.R.numpy(), atol=1e-4)
        np.testing.assert_allclose(og.t.cpu().numpy(), oc.t.numpy(), atol=1e-4)


def _ba_problem(seed, n_kf=8, n_lm=200):
    """A stereo inverse-depth BA problem built in torch (no JAX): noisy
    poses and depths, observations 0.5 px noisy, first two poses gauge."""
    from ov2slam_tpu_torch.core import lie
    from ov2slam_tpu_torch.opt import residuals as res
    from ov2slam_tpu_torch.opt.ba import BAProblem
    g = torch.Generator().manual_seed(seed)
    cal = res.Calib(450.0, 450.0, 376.0, 240.0)
    T_rl = lie.SE3(torch.eye(3), torch.tensor([-0.11, 0.0, 0.0]))
    Rs = lie.so3_exp(0.01 * torch.randn(n_kf, 3, generator=g))
    ts = torch.stack([torch.tensor([-0.3 * i, 0.0, 0.0]) for i in range(n_kf)])
    X = torch.rand(n_lm, 3, generator=g) * torch.tensor([6.0, 4.0, 4.0]) \
        + torch.tensor([-3.0 + 0.3 * n_kf / 2, -2.0, 6.0])
    anchor = torch.randint(0, n_kf, (n_lm,), generator=g)
    Xa = lie.se3_apply(lie.SE3(Rs[anchor], ts[anchor]), X)
    obs_kf, obs_lm, obs_px, obs_r = [], [], [], []
    for i in range(n_kf):
        for right in (False, True):
            Xc = lie.se3_apply(lie.SE3(Rs[i], ts[i]), X)
            if right:
                Xc = lie.se3_apply(T_rl, Xc)
            px = res.project(cal, Xc) + 0.5 * torch.randn(n_lm, 2, generator=g)
            keep = (anchor != i) | right
            obs_kf.append(torch.full((int(keep.sum()),), i))
            obs_lm.append(torch.arange(n_lm)[keep])
            obs_px.append(px[keep])
            obs_r.append(torch.full((int(keep.sum()),), right))
    pose_opt = torch.arange(n_kf) >= 2
    dt = 0.02 * torch.randn(n_kf, 3, generator=g) * pose_opt[:, None]
    return BAProblem(
        R=Rs, t=ts + dt, pose_opt=pose_opt, Xw=X, anchor=anchor,
        bearing=Xa / Xa[:, 2:], lam=1.0 / Xa[:, 2] * (1 + 0.05 * torch.randn(
            n_lm, generator=g)), lm_valid=torch.ones(n_lm, dtype=torch.bool),
        obs_kf=torch.cat(obs_kf), obs_lm=torch.cat(obs_lm),
        obs_px=torch.cat(obs_px), obs_right=torch.cat(obs_r),
        obs_valid=torch.ones(sum(len(o) for o in obs_kf), dtype=torch.bool),
        calib_l=cal, calib_r=cal, T_rl=T_rl)


@pytest.mark.cuda
@pytest.mark.parametrize("l2_refine", [False, True])
def test_solve_ba_global_on_card_matches_cpu(cuda, l2_refine):
    """The Schur-PCG BA on the card against the CPU: poses within 1e-4
    (rad, m), inverse depths within 1e-3 relative, costs within 1e-4
    relative, inlier masks equal; no host sync inside the solve."""
    from ov2slam_tpu_torch.core.lie import SE3
    from ov2slam_tpu_torch.opt import ba_global
    prob = _ba_problem(3)
    oc = ba_global.solve_ba_global(prob, max_iters=8, l2_refine=l2_refine)
    on_card = prob._replace(**{k: getattr(prob, k).to(cuda) for k in (
        "R", "t", "pose_opt", "Xw", "anchor", "bearing", "lam", "lm_valid",
        "obs_kf", "obs_lm", "obs_px", "obs_right", "obs_valid")},
        T_rl=SE3(prob.T_rl.R.to(cuda), prob.T_rl.t.to(cuda)))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        og = ba_global.solve_ba_global(on_card, max_iters=8, l2_refine=l2_refine)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(og.cost) < float(og.cost0)
    np.testing.assert_allclose(og.R.cpu().numpy(), oc.R.numpy(), atol=1e-4)
    np.testing.assert_allclose(og.t.cpu().numpy(), oc.t.numpy(), atol=1e-4)
    np.testing.assert_allclose(og.lam.cpu().numpy(), oc.lam.numpy(), rtol=1e-3)
    np.testing.assert_allclose(float(og.cost), float(oc.cost), rtol=1e-4)
    assert (og.obs_inlier.cpu() == oc.obs_inlier).all()


@pytest.mark.cuda
def test_knn2_match_on_card_matches_cpu(cuda):
    """Integer distances: the card gives the CPU's indices and distances
    exactly, ties to the first column included."""
    from ov2slam_tpu_torch.ops import describe
    g = torch.Generator().manual_seed(0)
    a = torch.randint(0, 2 ** 32, (512, 8), generator=g, dtype=torch.int64)
    b = torch.randint(0, 2 ** 32, (300, 8), generator=g, dtype=torch.int64)
    b[17] = b[5]
    a[:40] = b[5]
    va = torch.rand(512, generator=g) > 0.1
    vb = torch.rand(300, generator=g) > 0.1
    vb[5] = vb[17] = True
    oc = describe.knn2_match(a, va, b, vb)
    og = describe.knn2_match(a.to(cuda), va.to(cuda), b.to(cuda), vb.to(cuda))
    for x, y in zip(og, oc):
        assert torch.equal(x.cpu(), y)
    assert (oc[0][:40] == 5).all()


@pytest.mark.cuda
def test_cli_runs_on_the_card_by_default(cuda, tmp_path):
    """python -m ov2slam_tpu_torch.run with no --device: 10 synthetic
    frames, written as an EuRoC tree, run on the card through klt_track
    (one launch per tracking call at least) and give one finite pose per
    frame."""
    import dataset_np as dnp
    from ov2slam_tpu_torch import run
    n = 10
    fl, fr, _ = synp.render_sequence(n_frames=n)
    stamps = dnp.euroc_stamps(n)
    dnp.write_euroc(str(tmp_path / "seq"), [f.astype(np.uint8) for f in fl],
                    [f.astype(np.uint8) for f in fr], stamps,
                    [t + 2_000_000 for t in stamps])
    dnp.write_opencv_yaml(str(tmp_path / "p.yaml"), synp.slam_params_dict())
    k0 = klt.LAUNCHES
    res = run.main([str(tmp_path / "p.yaml"), str(tmp_path / "seq"),
                    "--out", str(tmp_path / "out")])
    assert res["frames"] == n and res["dropped"] == 0
    assert klt.LAUNCHES - k0 >= n - 1
    traj = np.loadtxt(tmp_path / "out" / "ov2slam_traj.txt")
    assert traj.shape == (n, 8) and np.isfinite(traj).all()


@pytest.mark.cuda
def test_frame_step_graph_replay_equals_eager(cuda):
    """slam/graphs.py: one replay of the captured frame step (gate read,
    the filter's graph when it opens) from a system's state equals the
    eager frame_step from the same state and generator state: the same
    keypoint mask, stats and pose within 1e-5; on the next frame (gate
    shut) and four frames on (gate open)."""
    from ov2slam_tpu_torch.config import SlamParams
    from ov2slam_tpu_torch.slam import frontend as fe
    from ov2slam_tpu_torch.slam import graphs
    from ov2slam_tpu_torch.slam.manager import SlamSystem
    fl, fr, _ = synp.render_sequence(n_frames=8, step=0.05)
    slam = SlamSystem(SlamParams.from_dict(synp.slam_params_dict()), device=cuda)
    for i in range(3):
        slam.process_stereo(fl[i], fr[i], i * 0.05)
    st, kw = slam.fe_state, slam._step_kwargs()
    lm = slam.map.device_landmarks()
    cache = graphs.StepGraphs()
    opened = []
    for j in (3, 7):
        img = slam._to_device_u8(fl[j])
        g0 = st.gen.get_state()
        new_e, s_e = fe.frame_step(st, img, *lm, slam.cam_l, **kw)
        g_eager = st.gen.get_state()
        st.gen.set_state(g0)
        new_g, s_g = cache.run(st, img[None], *lm, slam.cam_l, kw)
        torch.cuda.synchronize()
        # the replays drew as many samples as the eager step
        assert torch.equal(st.gen.get_state(), g_eager)
        opened.append(cache.last.replays.get("filter", 0))
        assert torch.equal(new_g.kps.valid, new_e.kps.valid)
        np.testing.assert_allclose(s_g[0].cpu().numpy(), s_e.cpu().numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(new_g.R_cw.cpu().numpy(),
                                   new_e.R_cw.cpu().numpy(), atol=1e-5)
    assert len(cache.graphs) == 1 and opened == [0, 1], opened


@pytest.mark.cuda
def test_segment_sum_repeats_on_card(cuda):
    """The ordered segment sum gives the same bits in 10 calls on the card
    (index_add_'s atomics need not), and the CPU's sums within float32
    rounding."""
    from ov2slam_tpu_torch.ops import segment
    g = torch.Generator().manual_seed(0)
    n, m = 2000, 40000
    idx = torch.randint(0, n, (m,), generator=g)
    idx[: m // 4] = 3
    vals = torch.randn(m, 6, 6, generator=g)
    seg = segment.segment_index(idx.to(cuda), n)
    assert seg.levels is not None
    outs = [segment.segment_sum(seg, vals.to(cuda)) for _ in range(10)]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    ref = torch.zeros(n, 6, 6, dtype=torch.float64).index_add_(
        0, idx, vals.double())
    mag = torch.zeros_like(ref).index_add_(0, idx, vals.double().abs())
    assert ((outs[0].cpu().double() - ref).abs() <= 1e-5 * mag + 1e-30).all()


@pytest.mark.cuda
def test_failed_capture_raises(cuda, monkeypatch):
    """A frame step that cannot be captured (a host read inside it) makes
    frame_chunk_step raise on the card: nothing runs the eager step in its
    place."""
    from ov2slam_tpu_torch.config import SlamParams
    from ov2slam_tpu_torch.slam import frontend as fe
    from ov2slam_tpu_torch.slam.manager import SlamSystem
    fl, fr, _ = synp.render_sequence(n_frames=4, step=0.05)
    slam = SlamSystem(SlamParams.from_dict(synp.slam_params_dict()), device=cuda)
    slam.process_stereo(fl[0], fr[0], 0.0)
    real_back = fe.step_back

    def reading_back(*a, **k):
        state, stats = real_back(*a, **k)
        float(stats[0])                 # a host sync: not capturable
        return state, stats

    monkeypatch.setattr(fe, "step_back", reading_back)
    imgs = torch.stack([slam._to_device_u8(f) for f in fl[1:3]])
    with pytest.raises(RuntimeError):
        fe.frame_chunk_step(slam.fe_state, imgs, *slam.map.device_landmarks(),
                            slam.cam_l, **slam._step_kwargs())
    torch.cuda.synchronize()
