"""GPU smoke run of the PyTorch/CUDA port (ov2slam_tpu_torch).

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (any failure raises; nothing falls back to the CPU):
1. device: ``nvidia-smi`` name and power limit, precision policy, CUDA check;
2. build: compile ``ov2slam_tpu_torch/csrc/lk_iterate.cu`` with nvcc;
3. kernel: ``lk_iterate`` against its plain PyTorch version on the card, on
   seeded inputs at the slice's shapes, with CUDA-event timings;
4. slice: a 60-frame 752x480 synthetic stereo sequence through
   ``SlamSystem.process_stereo`` on the card, trajectory files written, ATE
   checked, and the LK launch count read around every frame.

The last two lines of standard output are a JSON object describing the
kernel and ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --profile DIR`` also runs the first 20 frames of the
slice again under ``torch.profiler``, prints a summary and writes the full
tables to ``DIR/torch_profile_slice.txt``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from ov2slam_tpu_torch import device as device_mod  # noqa: E402
from ov2slam_tpu_torch.config import SlamParams  # noqa: E402
from ov2slam_tpu_torch.io.trajectories import ate_rmse  # noqa: E402
from ov2slam_tpu_torch.ops import _build, lk  # noqa: E402
from ov2slam_tpu_torch.ops import image as im  # noqa: E402
from ov2slam_tpu_torch.slam.manager import SlamSystem  # noqa: E402
import synthetic_np as syn  # noqa: E402

WS, WIN, EPS, MARGIN = 20, 9, 0.01, 4.0
N_FRAMES, STEP, YAW = 60, 0.03, 0.0015
# kernel vs plain on the card: both run float32 GN steps and differ only in
# summation order. Points that stopped the same way in both (converged, or
# paused at the margin) must agree to 2e-3 px; every point to eps: a point
# that converged one step earlier in one version differs by that last step,
# which is below eps, and a point still iterating when the budget ends has
# not converged (it oscillates) — the rule of tests/test_torch_lk.py.
PTS_TOL, MASK_AGREE = 2e-3, 0.99


def log(msg: str):
    print(msg, flush=True)


def lk_case(N: int, seed: int, dev):
    """Seeded LK inputs at the slice's shapes (ws=20, win=9): a smooth
    752x480 texture, the next image shifted by a sub-pixel motion plus
    noise, templates and gradients sampled at N points."""
    rng = np.random.default_rng(seed)
    H, W = 480, 752
    base = torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32))
    img0 = im.gaussian_blur(base, 1.5)
    shift = rng.uniform(-2.0, 2.0, 2)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    src = torch.from_numpy(np.stack([xs - shift[0], ys - shift[1]], -1)
                           .astype(np.float32))
    x0 = torch.clamp(torch.floor(src[..., 0]), 0, W - 2).long()
    y0 = torch.clamp(torch.floor(src[..., 1]), 0, H - 2).long()
    fx = (src[..., 0] - x0).clamp(0, 1)
    fy = (src[..., 1] - y0).clamp(0, 1)
    img1 = (img0[y0, x0] * (1 - fx) * (1 - fy) + img0[y0, x0 + 1] * fx * (1 - fy)
            + img0[y0 + 1, x0] * (1 - fx) * fy + img0[y0 + 1, x0 + 1] * fx * fy)
    img1 = img1 + torch.from_numpy(rng.normal(0, 1.0, (H, W)).astype(np.float32))
    pts = torch.from_numpy(np.stack([rng.uniform(WS, W - WS, N),
                                     rng.uniform(WS, H - WS, N)], -1)
                           .astype(np.float32))
    gxi, gyi = im.scharr_gradients(img0)
    o = torch.stack([torch.clamp(torch.round(pts[:, 0]).int() - WS // 2, 0, W - WS),
                     torch.clamp(torch.round(pts[:, 1]).int() - WS // 2, 0, H - WS)], -1)
    ar = torch.arange(WS)
    rows = (o[:, 1].long()[:, None] + ar)[:, :, None]
    cols = (o[:, 0].long()[:, None] + ar)[:, None, :]
    twin = torch.stack([img0[rows, cols], gxi[rows, cols], gyi[rows, cols]])
    tmpl, gx, gy = lk.sample_in_windows(twin, pts - o.float(), WIN)
    gxx, gxy, gyy = (gx * gx).sum(-1), (gx * gy).sum(-1), (gy * gy).sum(-1)
    det = gxx * gyy - gxy * gxy
    inv_det = torch.where(det.abs() > 1e-12, 1.0 / det, torch.zeros_like(det))
    # the estimate starts at the template position, the window follows it
    nwin = img1[rows, cols]
    ctr = o.float() + WS // 2
    args = [nwin, tmpl, gx, gy, gxx, gxy, gyy, inv_det, o, ctr, pts.clone(),
            torch.ones(N, dtype=torch.bool)]
    return [a.contiguous().to(dev) for a in args]


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_kernel(dev):
    """Kernel vs plain at N in {192, 320} and n_iters in {1, 10, 30}."""
    worst = 0.0
    times = {}
    for N in (192, 320):
        args = lk_case(N, seed=N, dev=dev)
        for n_iters in (1, 10, 30):
            kw = dict(win=WIN, n_iters=n_iters, eps=EPS, margin=MARGIN)
            pk, ak, ck = lk.lk_iterate(*args, **kw)
            pp, ap, cp = lk.lk_iterate_plain(*args, **kw)
            torch.cuda.synchronize()
            same = (ck == cp) & (ak == ap) & ~(ak & ap)
            err = (pk - pp).abs().amax(-1)
            err_same = float(err[same].max()) if bool(same.any()) else 0.0
            err_all = float(err.max())
            a_agree = float((ak == ap).float().mean())
            c_agree = float((ck == cp).float().mean())
            if err_same > PTS_TOL or err_all > EPS or min(a_agree, c_agree) < MASK_AGREE:
                raise AssertionError(
                    f"lk_iterate N={N} n_iters={n_iters}: point error "
                    f"{err_same:.3g} px (stopped alike, tol {PTS_TOL}), "
                    f"{err_all:.3g} px (all, tol {EPS}); mask agreement "
                    f"active {a_agree:.4f} converged {c_agree:.4f} "
                    f"(need {MASK_AGREE})")
            worst = max(worst, err_all)
            k_ms = cuda_ms(lambda: lk.lk_iterate(*args, **kw), 200)
            p_ms = cuda_ms(lambda: lk.lk_iterate_plain(*args, **kw), 20)
            times[(N, n_iters)] = (k_ms, p_ms)
            log(f"[kernel] N={N} n_iters={n_iters}: max |dp| {err_all:.3g} px "
                f"(stopped alike {err_same:.3g}), active agree {a_agree:.4f}, "
                f"converged agree {c_agree:.4f}; kernel {k_ms:.4f} ms, "
                f"plain {p_ms:.4f} ms")
    torch.cuda.synchronize()
    return worst, times


def phase_slice(dev):
    """The stereo slice on the card, from the system's public entry points."""
    t0 = time.perf_counter()
    fl, fr, gt = syn.render_sequence(n_frames=N_FRAMES, step=STEP, yaw_rate=YAW)
    log(f"[slice] rendered {N_FRAMES} frames at {syn.W}x{syn.H} in "
        f"{time.perf_counter() - t0:.1f} s")
    d = syn.slam_params_dict()
    d["doepipolar"] = 0
    slam = SlamSystem(SlamParams.from_dict(d), device=dev)
    est, launches, is_kf, dts = [], [], [], []
    lk.LAUNCHES = 0
    for i in range(N_FRAMES):
        before = lk.LAUNCHES
        n_kf = len(slam.map.keyframes)
        t1 = time.perf_counter()
        T_wc = slam.process_stereo(fl[i], fr[i], i * 0.05)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t1)
        est.append(T_wc)
        launches.append(lk.LAUNCHES - before)
        is_kf.append(len(slam.map.keyframes) > n_kf)
    total_launches = lk.LAUNCHES
    with tempfile.TemporaryDirectory() as out:
        slam.write_results(out)
        tum = np.loadtxt(Path(out) / "ov2slam_traj.txt")
        kitti = np.loadtxt(Path(out) / "ov2slam_traj_kitti.txt")

    est = np.stack(est)
    gt_t = np.stack([T[:3, 3] for T in gt])
    ate = ate_rmse(est[:, :3, 3], gt_t)
    n_kf, n3d = len(slam.map.keyframes), slam.map.n_3d()
    track_frames = [i for i in range(1, N_FRAMES) if not is_kf[i]]
    stereo_launches = launches[0]         # frame 0: stereo matching only
    track_launches = sum(launches[i] for i in track_frames)
    steady = float(np.sum(dts[1:]))
    log(f"[slice] ATE {ate:.5f} m, keyframes {n_kf}, landmarks {n3d}, "
        f"steady-state {(N_FRAMES - 1) / steady:.2f} fps "
        f"({1000 * steady / (N_FRAMES - 1):.1f} ms/frame over frames 1-"
        f"{N_FRAMES - 1}; first frame {1000 * dts[0]:.0f} ms)")
    log(f"[slice] LK launches: {total_launches} total, {stereo_launches} in "
        f"the first keyframe's stereo matching, "
        f"{track_launches / max(len(track_frames), 1):.1f} per tracking-only "
        f"frame, {total_launches / N_FRAMES:.1f} per frame")

    assert np.isfinite(est).all(), "non-finite pose"
    assert slam.initialized, "system never initialized"
    assert n_kf >= 2 and n3d > 50, (n_kf, n3d)
    assert ate < 0.05, f"ATE {ate:.4f} m"
    assert tum.shape == (N_FRAMES, 8) and kitti.shape == (N_FRAMES, 12), (
        tum.shape, kitti.shape)
    assert stereo_launches > 0, "stereo matching never launched the kernel"
    assert track_launches > 0, "tracking never launched the kernel"
    return total_launches, (fl, fr)


def phase_profile(dev, frames, out: Path, n_prof: int = 20):
    """Frames 1..n_prof of the slice once more under torch.profiler: device
    busy share, kernel launches per frame, and the host scopes and kernels
    that take the time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fl, fr = frames
    d = syn.slam_params_dict()
    d["doepipolar"] = 0
    slam = SlamSystem(SlamParams.from_dict(d), device=dev)
    slam.process_stereo(fl[0], fr[0], 0.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(1, n_prof + 1):
            slam.process_stereo(fl[i], fr[i], i * 0.05)
        torch.cuda.synchronize()
        wall_ms = 1000 * (time.perf_counter() - t0)
    events = prof.key_averages()
    is_scope = lambda e: e.key[:2] in ("0.", "1.", "2.")      # noqa: E731
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and not is_scope(e)]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1000
    n_kern = sum(e.count for e in kernels)
    log(f"[profile] frames 1-{n_prof} under the profiler: wall {wall_ms:.0f} ms, "
        f"kernels busy {busy_ms:.0f} ms (idle share "
        f"{1 - busy_ms / wall_ms:.3f}), {n_kern} kernel launches "
        f"({n_kern / n_prof:.0f} per frame)")
    for e in sorted((e for e in events if is_scope(e)
                     and e.device_type == DeviceType.CPU),
                    key=lambda e: -e.cpu_time_total):
        log(f"[profile] scope {e.key}: {e.count} calls, "
            f"{e.cpu_time_total / 1000:.0f} ms host")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[profile] kernel {e.key[:70]}: {e.count} launches, "
            f"{e.self_device_time_total / 1000:.1f} ms")
    out.mkdir(parents=True, exist_ok=True)
    (out / "torch_profile_slice.txt").write_text(
        f"frames 1-{n_prof}: wall {wall_ms:.1f} ms, kernels busy {busy_ms:.1f} ms, "
        f"{n_kern} kernel launches\n\nby self device time\n"
        + events.table(sort_by="self_device_time_total", row_limit=40)
        + "\n\nby host total\n"
        + events.table(sort_by="cpu_time_total", row_limit=40) + "\n")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", type=Path,
                    help="also profile the slice (torch.profiler) and write "
                         "its tables into DIR")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's GPU path cannot run "
              "here", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    log(smi[0])
    device_mod.set_precision_policy()
    dev = torch.device("cuda", 0)
    log(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.load("lk_iterate")
    log(f"[build] lk_iterate.cu: {_build.BUILD_SECONDS.get('lk_iterate', 0.0):.1f} s "
        f"nvcc ({time.perf_counter() - t0:.1f} s with load)")
    for line in _build.BUILD_LOG.get("lk_iterate", "").splitlines():
        log(f"[build] {line}")

    worst, times = phase_kernel(dev)
    launches, frames = phase_slice(dev)
    if args.profile:
        phase_profile(dev, frames, args.profile)

    k_ms, p_ms = times[(192, 10)]
    print(json.dumps({"kernels": [{
        "name": "lk_iterate", "route": "cuda",
        "source": "ov2slam_tpu_torch/csrc/lk_iterate.cu",
        "replaces": "ov2slam_tpu/ops/pallas_lk.py:175",
        "launches": launches, "max_abs_err": worst,
        "ms": k_ms, "plain_ms": p_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
