"""Run the preset tiers of ``chip_smoke.py`` through the PyTorch port or the
JAX package, and print one JSON line per tier.

    python3 scripts/torch_preset_tiers.py [--backend torch|jax]
        [--device cuda|cpu] [--frames 120] [--tiers NAME,NAME] [--chunk N]
        [--out FILE]

Tiers (``TIERS``): each is a shipped preset file,
``parameters_files/<tier>/euroc/euroc_<mode>.yaml``, with only the camera
replaced by ``tests/hard_synthetic.py``'s EuRoC rig (752x480, f = 458,
0.11 m baseline, k1 = -0.28, k2 = 0.07), as ``scripts/hard_bench.py`` builds
its tiers. Every setting of the file stays as shipped, ``force_realtime``
among them; ``accurate_stereo_nolc`` and ``accurate_stereo_rect`` switch the
loop closer off, the latter also sets ``bdo_stereo_rect``. They run over the
first ``--frames`` frames of ``render_hard_sequence(n_frames=1000)`` (a
prefix: the trajectory's spacing depends on n_frames), rendered by
``tests/hard_synthetic_np.py`` and quantized to uint8, then ``flush()``.
``accurate_stereo`` (the loop closer on, as shipped) runs all ``HARD_N``
(1000) frames (the trajectory revisits its start after ~926), with the
loop detector scaled to the sequence's ~50 keyframes as
``scripts/hard_bench.py`` scales it (``LC_DETECTOR``). ``kf2f`` is
``chip_smoke.py``'s 60-frame synthetic stereo slice
(``tests/synthetic_np.py``, step 0.03 m) with ``btrack_keyframetoframe: 1``.
``bench`` is ``bench.py``'s surface: 120 frames of the same sequence with
``tests/synthetic.py``'s ``slam_params_dict()`` as it is. With ``--chunk
N`` the stereo tiers feed ``process_stereo_chunk`` N frames at a time (the
throughput mode; keyframes only on a chunk's last frame), through either
package.

The ``oab_*`` runs are the out-and-back world of ``tests/test_loopclosing.py``
(``tests/loop_synthetic_np.py``: 100 frames, a wall at z = 2.5 m, the loop
closer on, local-map matching off, the short-world detector settings):
``oab_stereo`` synchronous with ``do_full_ba``, ``oab_stereo_rt`` pipelined
(``force_realtime``), ``oab_mono``, and ``oab_kidnap`` (30 frames mapped, 6
blank, then frame 6 again, stereo). ``--backend jax`` supplies the name the
JAX package's structure-only BA lacks (``ov2slam_tpu/opt/ba.py:536``, R1)
before it runs. The port runs every loop-closing tier under PyTorch's
deterministic algorithms (``deterministic``): the scatter-adds of the BA,
the pose graph and the PCG then sum in a fixed order on the card, so that
a run repeats as long as the span BA's wall-clock budget does not cut it.

Each line: the tier, its ATE (m; Sim(3)-aligned for mono, SE(3) for
stereo) over the logged per-frame poses, frames, keyframes, 3D landmarks,
the deepest in-flight FIFO, wall seconds and frames per second after the
first frame (host clock, flush included); with the loop closer also the
loop events, the ATE of the relaxed full trajectory
(``ov2slam_full_traj_wlc_opt.txt``) and the seconds of ``write_results``;
the kidnap run the relocalization error and the tracking-chain generation;
a loop tier of the port also the operations that have no deterministic
version, where one ran. ``--backend jax`` imports the
JAX package only then and runs it on the CPU (it gives the reference ATEs
that ``chip_smoke.py`` records); the default runs the port on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
import warnings
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
    "bench": None,
    "accurate_stereo": ("accurate", "stereo", {}),
}
# scripts/hard_bench.py's loop detector for the ~50-keyframe sequence
LC_DETECTOR = dict(p_wait=12, island_size=10, min_score=3.0)
OAB = {
    "oab_stereo": dict(do_full_ba=1),
    "oab_stereo_rt": dict(force_realtime=1),
    "oab_mono": dict(mono=1, stereo=0),
    "oab_kidnap": {},
}
KIDNAP_HALF, KIDNAP_VIEW = 30, 6
KF2F_FRAMES, KF2F_STEP, KF2F_YAW = 60, 0.03, 0.0015
BENCH_FRAMES = 120
_CAL_KEYS = ("T_left_right", "body_T_cam0", "body_T_cam1")


def tier_dict(name: str) -> dict:
    """The SlamParams dict of a tier (see the module docstring)."""
    import hard_synthetic_np as hs
    import synthetic_np as syn
    from ov2slam_tpu_torch.config import load_opencv_yaml
    if TIERS[name] is None:
        d = syn.slam_params_dict()
        if name == "kf2f":
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


def _hard_chunk(idx):
    """Frames `idx` of render_hard_sequence(n_frames=HARD_N), as uint8
    pairs and gt positions (one spawned worker's share)."""
    import hard_synthetic_np as hs
    return [(il.astype(np.uint8), ir.astype(np.uint8), T_wc[:3, 3])
            for il, ir, _, T_wc in hs.render_hard_sequence(
                HARD_N, dist=DIST, frames=idx)]


def hard_frames(n: int, workers: int = None):
    """(left uint8 list, right uint8 list, gt positions (n, 3)): the first
    n frames of render_hard_sequence(n_frames=1000), rendered by `workers`
    spawned processes (default: one per CPU core, at most 8)."""
    workers = workers or min(8, os.cpu_count() or 1)
    chunks = [list(range(k, n, workers)) for k in range(workers)]
    if workers == 1:
        parts = [_hard_chunk(chunks[0])]
    else:
        import multiprocessing
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            parts = pool.map(_hard_chunk, chunks)
    frames = [None] * n
    for idx, part in zip(chunks, parts):
        for i, f in zip(idx, part):
            frames[i] = f
    L, R, gt = zip(*frames)
    return list(L), list(R), np.stack(gt)


def kf2f_frames(n: int = KF2F_FRAMES):
    """(left, right, gt positions) of the synthetic slice (the kf2f and,
    with n = BENCH_FRAMES, the bench tier)."""
    import synthetic_np as syn
    fl, fr, gt = syn.render_sequence(n_frames=n, step=KF2F_STEP,
                                     yaw_rate=KF2F_YAW)
    return fl, fr, np.stack([T[:3, 3] for T in gt])


def trajectory_ate(logger, gt: np.ndarray, mono: bool) -> float:
    """ATE of the logged per-frame poses (frame i at time i * 0.05)."""
    return times_ate(logger.times, [np.asarray(T)[:3, 3] for T in logger.poses_wc],
                     gt, mono)


def times_ate(times, positions, gt: np.ndarray, mono: bool) -> float:
    """ATE of positions stamped with times (frame i at i * FRAME_DT)."""
    from ov2slam_tpu_torch.io.trajectories import ate_rmse
    n = len(gt)
    est = np.full((n, 3), np.nan)
    for t, x in zip(times, positions):
        i = int(round(t / FRAME_DT))
        if 0 <= i < n:
            est[i] = x
    ok = np.isfinite(est).all(axis=1)
    if ok.sum() <= 10:
        return float("nan")
    return ate_rmse(est[ok], gt[ok], with_scale=mono)


def run_tier(slam, frames, mono: bool, call=None, sync=None,
             chunk: int = 1) -> dict:
    """Drive `slam` over frames = (left, right, gt), then flush. `call(i,
    fn)` wraps each call (default: fn()): each frame's, or with chunk > 1
    (stereo) each ``process_stereo_chunk`` call's, i its first frame;
    `sync()` waits for the device before the clock is read. Returns the
    tier's numbers (fps after the first call)."""
    L, R, gt = frames
    call = call or (lambda i, fn: fn())
    sync = sync or (lambda: None)
    depth, t_first = 0, None
    step = chunk if chunk > 1 and not mono else 1
    t0 = time.perf_counter()
    for i in range(0, len(gt), step):
        if mono:
            call(i, lambda: slam.process_mono(L[i], i * FRAME_DT))
        elif step > 1:
            call(i, lambda: slam.process_stereo_chunk(
                [(L[j], R[j], j * FRAME_DT)
                 for j in range(i, min(i + step, len(gt)))]))
        else:
            call(i, lambda: slam.process_stereo(L[i], R[i], i * FRAME_DT))
        depth = max(depth, len(slam._inflight))
        if i == 0:
            sync()
            t_first = time.perf_counter()
            n_first = min(step, len(gt))
    slam.flush()
    sync()
    t_end = time.perf_counter()
    n = len(gt)
    row = dict(
        ate=trajectory_ate(slam.logger, gt, mono), frames=n,
        logged=len(slam.logger.times), keyframes=len(slam.map.keyframes),
        landmarks=int(slam.map.n_3d()), max_inflight=depth,
        seconds=t_end - t0, fps=(n - n_first) / max(t_end - t_first, 1e-9),
        initialized=bool(slam.initialized))
    if slam.loopcloser is not None or slam.params.do_full_ba:
        row.update(final_passes(slam, gt, mono, sync))
    return row


def final_passes(slam, gt: np.ndarray, mono: bool, sync=None) -> dict:
    """write_results into a scratch directory: the loop events, the ATE of
    the relaxed full trajectory (wlc_opt), its rows, and the seconds the
    final passes took."""
    sync = sync or (lambda: None)
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        slam.write_results(out)
        sync()
        dt = time.perf_counter() - t0
        tables = {f: np.loadtxt(os.path.join(out, f), ndmin=2)
                  for f in sorted(os.listdir(out))}
    opt = tables["ov2slam_full_traj_wlc_opt.txt"]
    evs = slam.loop_events if slam.loopcloser is not None else []
    return dict(
        loops=[[e.query_kf, e.match_kf, e.n_inliers, e.n_merged,
                round(e.pose_jump, 5)] for e in evs],
        ate_wlc_opt=times_ate(opt[:, 0], opt[:, 1:4], gt, mono),
        final_seconds=dt,
        files={f: [*a.shape, bool(np.isfinite(a).all())]
               for f, a in tables.items()})


def oab_frames():
    """(left, right, gt positions) of the out-and-back world (100 frames;
    the kidnap run takes its first KIDNAP_HALF, which are the frames of
    render_out_and_back(n_half=KIDNAP_HALF))."""
    import loop_synthetic_np as lsn
    fl, fr, gt = lsn.render_out_and_back()
    return fl, fr, np.stack([T[:3, 3] for T in gt])


def oab_dict(name: str) -> dict:
    import loop_synthetic_np as lsn
    return lsn.loop_params_dict(**OAB[name])


def run_oab(slam, name: str, frames, call=None, sync=None) -> dict:
    """Drive `slam` through an out-and-back run: the whole world (then the
    final passes), or the kidnap (mapped frames, blank frames, then the
    view of frame KIDNAP_VIEW again)."""
    import loop_synthetic_np as lsn
    L, R, gt = frames
    if name != "oab_kidnap":
        lsn.set_detector(slam)
        row = run_tier(slam, frames, bool(slam.params.mono), call, sync)
        pos = np.stack([np.asarray(T)[:3, 3] for T in slam.logger.poses_wc])
        row["max_step"] = float(np.linalg.norm(np.diff(pos, axis=0), axis=1).max())
        return row
    call = call or (lambda i, fn: fn())
    slam.loopcloser.detector.p_wait = 5
    blank = np.full_like(L[0], 127.0)
    seq = ([(L[i], R[i]) for i in range(KIDNAP_HALF)] + [(blank, blank)] * 6
           + [(L[KIDNAP_VIEW], R[KIDNAP_VIEW])] * 4)
    T = None
    t0 = time.perf_counter()
    for i, (il, ir) in enumerate(seq):
        def step(il=il, ir=ir, i=i):
            nonlocal T
            T = slam.process_stereo(il, ir, i * FRAME_DT)
        call(i, step)
    (sync or (lambda: None))()
    return dict(frames=len(seq), seconds=time.perf_counter() - t0,
                reloc_err=float(np.linalg.norm(T[:3, 3] - gt[KIDNAP_VIEW])),
                chain_gen=int(slam._chain_gen),
                keyframes=len(slam.map.keyframes))


def make_system(backend: str, d: dict, device: str, detector=None):
    """The system of either package, its loop detector's settings replaced
    by `detector` (a dict) where given."""
    if backend == "jax":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import ov2slam_tpu.core.smallalg as jsmallalg
        import ov2slam_tpu.opt.ba as jba
        from ov2slam_tpu.config import SlamParams as JParams
        from ov2slam_tpu.slam.manager import SlamSystem as JSlam
        # R1: the reference's structure-only BA uses smallalg unimported
        jba.smallalg = jsmallalg
        slam = JSlam(JParams.from_dict(d))
    else:
        from ov2slam_tpu_torch.config import SlamParams
        from ov2slam_tpu_torch.slam.manager import SlamSystem
        slam = SlamSystem(SlamParams.from_dict(d), device=device)
    for k, v in (detector or {}).items():
        setattr(slam.loopcloser.detector, k, v)
    return slam


@contextlib.contextmanager
def deterministic(ops: set):
    """``device.deterministic()`` for the block (the port's loop tiers),
    the name of every operation without a deterministic version (its
    warning) added to `ops`. ``main`` sets ``CUBLAS_WORKSPACE_CONFIG``
    before the card is first used."""
    from ov2slam_tpu_torch import device
    with device.deterministic(), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        yield
    for w in caught:
        msg = str(w.message)
        if "deterministic" in msg:
            ops.add(msg.split(" does not have")[0].split(" is not")[0][:120])
        else:
            warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("torch", "jax"), default="torch")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--tiers", default=",".join(list(TIERS) + list(OAB)))
    ap.add_argument("--chunk", type=int, default=1,
                    help="stereo frames per process_stereo_chunk call")
    ap.add_argument("--out", type=Path, help="also append the lines here")
    args = ap.parse_args()
    names = args.tiers.split(",")
    n_hard = max([HARD_N if n == "accurate_stereo" else args.frames
                  for n in names if TIERS.get(n)], default=0)
    hard = hard_frames(n_hard) if n_hard else None
    sync = None
    if args.backend == "torch":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        import torch
        torch.set_num_threads(min(torch.get_num_threads(), 8))
        if args.device is None or str(args.device).startswith("cuda"):
            sync = torch.cuda.synchronize
    oab = oab_frames() if any(n in OAB for n in names) else None
    for name in names:
        d = oab_dict(name) if name in OAB else tier_dict(name)
        ops = set()
        with (deterministic(ops) if args.backend == "torch"
              and d.get("buse_loop_closer") else contextlib.nullcontext()):
            if name in OAB:
                slam = make_system(args.backend, d, args.device)
                row = run_oab(slam, name, oab, sync=sync)
            else:
                n = HARD_N if name == "accurate_stereo" else args.frames
                frames = (tuple(x[:n] for x in hard) if TIERS[name]
                          else kf2f_frames(BENCH_FRAMES if name == "bench"
                                           else KF2F_FRAMES))
                slam = make_system(args.backend, d, args.device,
                                   LC_DETECTOR if d.get("buse_loop_closer") else None)
                row = run_tier(slam, frames, bool(d.get("mono")), sync=sync,
                               chunk=args.chunk)
        row = dict(tier=name, backend=args.backend, chunk=args.chunk, **row)
        if ops:
            row["nondeterministic_ops"] = sorted(ops)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
