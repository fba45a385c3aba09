"""Run the preset tiers of ``chip_smoke.py`` through the PyTorch port or the
JAX package, and print one JSON line per tier.

    python3 scripts/torch_preset_tiers.py [--backend torch|jax]
        [--device cuda|cpu] [--frames 120] [--tiers NAME,NAME] [--out FILE]

Tiers (``TIERS``): each is a shipped preset file,
``parameters_files/<tier>/euroc/euroc_<mode>.yaml``, with only the camera
replaced by ``tests/hard_synthetic.py``'s EuRoC rig (752x480, f = 458,
0.11 m baseline, k1 = -0.28, k2 = 0.07), as ``scripts/hard_bench.py`` builds
its tiers. Every setting of the file stays as shipped, ``force_realtime``
among them; ``accurate_stereo_nolc`` and ``accurate_stereo_rect`` switch the
loop closer off (not ported), the latter also sets ``bdo_stereo_rect``.
They run over the first ``--frames`` frames of
``render_hard_sequence(n_frames=1000)`` (a prefix: the trajectory's spacing
depends on n_frames), rendered by ``tests/hard_synthetic_np.py`` and
quantized to uint8, then ``flush()``. ``kf2f`` is ``chip_smoke.py``'s
60-frame synthetic stereo slice (``tests/synthetic_np.py``, step 0.03 m)
with ``btrack_keyframetoframe: 1``.

Each line: the tier, its ATE (m; Sim(3)-aligned for mono, SE(3) for
stereo) over the logged per-frame poses, frames, keyframes, 3D landmarks,
the deepest in-flight FIFO, wall seconds and frames per second after the
first frame (host clock, flush included). ``--backend jax`` imports the
JAX package only then and runs it on the CPU (it gives the reference ATEs
that ``chip_smoke.py`` records); the default runs the port on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

HARD_N, DIST, FRAME_DT = 1000, (-0.28, 0.07), 0.05
TIERS = {
    "fast_stereo": ("fast", "stereo", {}),
    "accurate_stereo_nolc": ("accurate", "stereo", {"buse_loop_closer": 0}),
    "accurate_mono": ("accurate", "mono", {}),
    "average_mono": ("average", "mono", {}),
    "fast_mono": ("fast", "mono", {}),
    "accurate_stereo_rect": ("accurate", "stereo",
                             {"bdo_stereo_rect": 1, "buse_loop_closer": 0}),
    "kf2f": None,
}
KF2F_FRAMES, KF2F_STEP, KF2F_YAW = 60, 0.03, 0.0015
_CAL_KEYS = ("T_left_right", "body_T_cam0", "body_T_cam1")


def tier_dict(name: str) -> dict:
    """The SlamParams dict of a tier (see the module docstring)."""
    import hard_synthetic_np as hs
    import synthetic_np as syn
    from ov2slam_tpu_torch.config import load_opencv_yaml
    if TIERS[name] is None:
        d = syn.slam_params_dict()
        d["btrack_keyframetoframe"] = 1
        return d
    tier, mode, overrides = TIERS[name]
    path = ROOT / "parameters_files" / tier / "euroc" / f"euroc_{mode}.yaml"
    d = {k: v for k, v in load_opencv_yaml(str(path)).items()
         if not k.startswith("Camera.") and k not in _CAL_KEYS}
    cal = hs.params_dict(dist=DIST, use_clahe=int(d.get("use_clahe", 1)))
    d.update({k: v for k, v in cal.items()
              if k.startswith("Camera.") or k == "T_left_right"})
    d.update(mono=int(mode == "mono"), stereo=int(mode == "stereo"))
    d.update(overrides)
    return d


def hard_frames(n: int):
    """(left uint8 list, right uint8 list, gt positions (n, 3)): the first
    n frames of render_hard_sequence(n_frames=1000)."""
    import hard_synthetic_np as hs
    L, R, gt = [], [], []
    for i, (il, ir, _, T) in enumerate(hs.render_hard_sequence(
            n_frames=HARD_N, dist=DIST)):
        if i >= n:
            break
        L.append(il.astype(np.uint8))
        R.append(ir.astype(np.uint8))
        gt.append(T[:3, 3])
    return L, R, np.stack(gt)


def kf2f_frames():
    import synthetic_np as syn
    fl, fr, gt = syn.render_sequence(n_frames=KF2F_FRAMES, step=KF2F_STEP,
                                     yaw_rate=KF2F_YAW)
    return fl, fr, np.stack([T[:3, 3] for T in gt])


def trajectory_ate(logger, gt: np.ndarray, mono: bool) -> float:
    """ATE of the logged per-frame poses (frame i at time i * 0.05)."""
    from ov2slam_tpu_torch.io.trajectories import ate_rmse
    n = len(gt)
    est = np.full((n, 3), np.nan)
    for t, T in zip(logger.times, logger.poses_wc):
        i = int(round(t / FRAME_DT))
        if 0 <= i < n:
            est[i] = np.asarray(T)[:3, 3]
    ok = np.isfinite(est).all(axis=1)
    if ok.sum() <= 10:
        return float("nan")
    return ate_rmse(est[ok], gt[ok], with_scale=mono)


def run_tier(slam, frames, mono: bool, call=None, sync=None) -> dict:
    """Drive `slam` over frames = (left, right, gt), then flush. `call(i,
    fn)` wraps each frame's call (default: fn()); `sync()` waits for the
    device before the clock is read. Returns the tier's numbers."""
    L, R, gt = frames
    call = call or (lambda i, fn: fn())
    sync = sync or (lambda: None)
    depth, t_first = 0, None
    t0 = time.perf_counter()
    for i in range(len(gt)):
        if mono:
            call(i, lambda: slam.process_mono(L[i], i * FRAME_DT))
        else:
            call(i, lambda: slam.process_stereo(L[i], R[i], i * FRAME_DT))
        depth = max(depth, len(slam._inflight))
        if i == 0:
            sync()
            t_first = time.perf_counter()
    slam.flush()
    sync()
    t_end = time.perf_counter()
    n = len(gt)
    return dict(
        ate=trajectory_ate(slam.logger, gt, mono), frames=n,
        logged=len(slam.logger.times), keyframes=len(slam.map.keyframes),
        landmarks=int(slam.map.n_3d()), max_inflight=depth,
        seconds=t_end - t0, fps=(n - 1) / max(t_end - t_first, 1e-9),
        initialized=bool(slam.initialized))


def make_system(backend: str, d: dict, device: str):
    if backend == "jax":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        from ov2slam_tpu.config import SlamParams as JParams
        from ov2slam_tpu.slam.manager import SlamSystem as JSlam
        return JSlam(JParams.from_dict(d))
    from ov2slam_tpu_torch.config import SlamParams
    from ov2slam_tpu_torch.slam.manager import SlamSystem
    return SlamSystem(SlamParams.from_dict(d), device=device)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("torch", "jax"), default="torch")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--tiers", default=",".join(TIERS))
    ap.add_argument("--out", type=Path, help="also append the lines here")
    args = ap.parse_args()
    names = args.tiers.split(",")
    hard = hard_frames(args.frames) if any(TIERS[n] for n in names) else None
    sync = None
    if args.backend == "torch":
        import torch
        torch.set_num_threads(min(torch.get_num_threads(), 8))
        if args.device is None or str(args.device).startswith("cuda"):
            sync = torch.cuda.synchronize
    for name in names:
        d = tier_dict(name)
        frames = hard if TIERS[name] else kf2f_frames()
        slam = make_system(args.backend, d, args.device)
        row = dict(tier=name, backend=args.backend,
                   **run_tier(slam, frames, bool(d.get("mono")), sync=sync))
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
