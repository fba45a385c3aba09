"""Run the preset tiers of ``chip_smoke.py`` through the PyTorch port or the
JAX package, and print one JSON line per tier.

    python3 scripts/torch_preset_tiers.py [--backend torch|jax]
        [--device cuda|cpu] [--frames 120] [--tiers NAME,NAME] [--chunk N]
        [--out FILE]

Tiers (``TIERS``, ``scripts/hard_bench.py``'s ``tier_configs``): each is a
shipped preset file, ``parameters_files/<tier>/<dataset>/<file>``, with only
the camera replaced by the dataset's rig of ``tests/hard_synthetic.py``:
EuRoC (752x480, f = 458, 0.11 m baseline, k1 = -0.28, k2 = 0.07), KITTI
(1241x376, f = 718.856, 0.537 m, the same distortion) or TartanAir (640x480,
f = 320, 0.25 m, no distortion), as ``scripts/hard_bench.py`` builds its
tiers (``tier_dict`` equals its ``preset_config`` without the ``__*__``
keys). Every setting of the file stays as shipped, ``force_realtime`` among
them; ``accurate_stereo_nolc`` and ``accurate_stereo_rect`` switch the loop
closer off, the latter also sets ``bdo_stereo_rect``. They run over the
first ``--frames`` frames of ``render_hard_sequence(n_frames=1000)`` (a
prefix: the trajectory's spacing depends on n_frames), rendered by
``tests/hard_synthetic_np.py`` and quantized to uint8, then ``flush()``.
``accurate_stereo`` (the loop closer on, as shipped) runs all ``HARD_N``
(1000) frames (the trajectory revisits its start after ~926), with the loop
detector scaled to the sequence's ~50 keyframes as ``scripts/hard_bench.py``
scales it (``LC_DETECTOR``), and so does ``accurate_mono_lc`` (the mono
preset with the loop closer on). The loop closer is on as shipped in
``average_stereo``, ``kitti_stereo`` (the KITTI 00-02 preset,
``bdo_stereo_rect`` on) and ``tartanair_stereo``, which run ``--frames``
frames of their rig's 1000-frame sequence like the tiers above (``--frames
1000``: the whole loop). ``accurate_stereo_2laps`` runs all of
``render_hard_sequence(2000)`` (two laps), ``endurance_fig8`` all of
``render_hard_sequence(5000, traj="fig8")`` with ``lm_capacity`` 65,536 and
the loop detector's shipped defaults; these two are left out of the default
``--tiers`` and are streamed (``HardStream``: worker processes render a few
frames ahead of the system) instead of rendered first. ``kf2f`` is
``chip_smoke.py``'s 60-frame synthetic stereo slice
(``tests/synthetic_np.py``, step 0.03 m) with ``btrack_keyframetoframe: 1``.
``bench`` is ``bench.py``'s surface: 120 frames of the same sequence with
``tests/synthetic.py``'s ``slam_params_dict()`` as it is. With ``--chunk N``
the stereo tiers feed ``process_stereo_chunk`` N frames at a time (the
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

Each line: the tier, its ATE (m; Sim(3)-aligned for mono, SE(3) for stereo)
over the logged per-frame poses, frames, keyframes, 3D landmarks, the
deepest in-flight FIFO, wall seconds and frames per second after the first
frame (host clock, flush included); ``scripts/hard_bench.py``'s row fields
(``latency_fields``): ``fps_steady`` after ``WARMUP_FRAMES``,
``frame_ms_p50`` / ``p90`` / ``p99`` of the calls after it (all calls when
the run is no longer), split into keyframe calls (the map's keyframe count
grew during the call) and cruise calls, ``warmup_s``, ``tracked_pct`` and
the first call's ms; with the loop closer also the loop
events, the ATE of the relaxed full trajectory
(``ov2slam_full_traj_wlc_opt.txt``) and the seconds of ``write_results``;
the kidnap run the relocalization error and the tracking-chain generation; a
loop tier of the port also the operations that have no deterministic
version, where one ran; every hard-sequence tier the host seconds of each
span BA, the BA budget timeouts and truncations, and on the card the peak
device memory (``torch.cuda.max_memory_allocated``). ``--backend jax``
imports the JAX package only then and runs it on the CPU (it gives the
reference ATEs that ``chip_smoke.py`` records); the default runs the port on
the card.
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
from typing import NamedTuple, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

HARD_N, DIST, FRAME_DT = 1000, (-0.28, 0.07), 0.05
# scripts/hard_bench.py's warm-up (its jit compiles); the port compiles
# nothing, but its first frames capture CUDA graphs and build the place
# index, and first_call_ms reports the first call apart
WARMUP_FRAMES = 120


class Tier(NamedTuple):
    """A hard-sequence tier: ``parameters_files/<preset>/<dataset>/<file>``
    (default ``<dataset>_<mode>.yaml``) with `overrides`, on the dataset's
    synthetic rig. `frames` 0 runs the first ``--frames`` frames of
    ``render_hard_sequence(HARD_N)``; otherwise all frames of
    ``render_hard_sequence(frames, traj=traj)``. `stock_lc` keeps the loop
    detector's shipped defaults (else ``LC_DETECTOR``)."""
    preset: str
    mode: str
    overrides: dict = {}
    dataset: str = "euroc"
    preset_file: Optional[str] = None
    frames: int = 0
    traj: str = "loop"
    stock_lc: bool = False


TIERS = {
    "fast_stereo": Tier("fast", "stereo"),
    "accurate_stereo_nolc": Tier("accurate", "stereo", {"buse_loop_closer": 0}),
    "accurate_mono": Tier("accurate", "mono"),
    "average_mono": Tier("average", "mono"),
    "fast_mono": Tier("fast", "mono"),
    "accurate_stereo_rect": Tier("accurate", "stereo",
                                 {"bdo_stereo_rect": 1, "buse_loop_closer": 0}),
    "kf2f": None,
    "bench": None,
    "accurate_stereo": Tier("accurate", "stereo", frames=HARD_N),
    "average_stereo": Tier("average", "stereo"),
    "kitti_stereo": Tier("accurate", "stereo", dataset="kitti",
                         preset_file="kitti_00-02.yaml"),
    "tartanair_stereo": Tier("accurate", "stereo", dataset="tartanair"),
    "accurate_mono_lc": Tier("accurate", "mono", {"buse_loop_closer": 1},
                             frames=HARD_N),
    "accurate_stereo_2laps": Tier("accurate", "stereo", frames=2 * HARD_N),
    "endurance_fig8": Tier("accurate", "stereo", {"lm_capacity": 1 << 16},
                           frames=5 * HARD_N, traj="fig8", stock_lc=True),
}
# the synthetic rig of each dataset (tests/hard_synthetic_np.py); TartanAir's
# is distortion-free, the others carry DIST
CAMS = {"euroc": "CAM_EUROC", "kitti": "CAM_KITTI", "tartanair": "CAM_TARTAN"}
# scripts/hard_bench.py's loop detector for the ~50-keyframe sequence
LC_DETECTOR = dict(p_wait=12, island_size=10, min_score=3.0)
OAB = {
    "oab_stereo": dict(do_full_ba=1),
    "oab_stereo_rt": dict(force_realtime=1),
    "oab_mono": dict(mono=1, stereo=0),
    "oab_kidnap": {},
}
KIDNAP_HALF, KIDNAP_VIEW = 30, 6
STREAM_DEPTH = 4        # frames a render worker may be ahead of the system
KF2F_FRAMES, KF2F_STEP, KF2F_YAW = 60, 0.03, 0.0015
BENCH_FRAMES = 120
_CAL_KEYS = ("T_left_right", "body_T_cam0", "body_T_cam1")


def dist_of(dataset: str) -> tuple:
    return (0.0, 0.0) if dataset == "tartanair" else DIST


def tier_dict(name: str, tier: Optional[Tier] = None) -> dict:
    """The SlamParams dict of a tier (see the module docstring), or of
    `tier` in place of its entry in TIERS."""
    import hard_synthetic_np as hs
    import synthetic_np as syn
    from ov2slam_tpu_torch.config import load_opencv_yaml
    t = TIERS[name] if tier is None else tier
    if t is None:
        d = syn.slam_params_dict()
        if name == "kf2f":
            d["btrack_keyframetoframe"] = 1
        return d
    path = (ROOT / "parameters_files" / t.preset / t.dataset
            / (t.preset_file or f"{t.dataset}_{t.mode}.yaml"))
    d = {k: v for k, v in load_opencv_yaml(str(path)).items()
         if not k.startswith("Camera.") and k not in _CAL_KEYS}
    cal = hs.params_dict(dist=dist_of(t.dataset),
                         use_clahe=int(d.get("use_clahe", 1)),
                         cam=getattr(hs, CAMS[t.dataset]))
    d.update({k: v for k, v in cal.items()
              if k.startswith("Camera.") or k == "T_left_right"})
    d.update(mono=int(t.mode == "mono"), stereo=int(t.mode == "stereo"))
    d.update(t.overrides)
    return d


def parse_value(v: str):
    """A ``--set`` value: an int, else a float, else the string."""
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v


def with_sets(name: str, sets) -> tuple:
    """Tier `name` after ``--set knob=value`` overrides (the JAX tools'
    ``--set``): a knob that names a ``Tier`` field replaces it (``frames``,
    ``traj``, ``dataset``, ``preset_file``, ``stock_lc``, ...),
    ``workers`` and ``seed`` are its ``HardStream``'s, any other is a key
    of its SlamParams dict. Returns (tier, params dict, stream keywords)."""
    t, params, stream = TIERS[name], {}, {}
    for kv in sets:
        k, v = kv.split("=", 1)
        v = parse_value(v)
        if k in ("workers", "seed"):
            stream[k] = v
        elif t is not None and k in Tier._fields:
            t = t._replace(**{k: v})
        else:
            params[k] = v
    d = tier_dict(name, t)
    d.update(params)
    return t, d, stream


def _render(n: int, n_seq: int, dataset: str, traj: str, seed: int = 0,
            k: int = 0, step: int = 1):
    """Frames k, k + step, ... < n of the sequence (its world textured from
    `seed`), as (left uint8, right uint8, gt position)."""
    import hard_synthetic_np as hs
    for il, ir, _, T_wc in hs.render_hard_sequence(
            n_seq, seed=seed, dist=dist_of(dataset),
            cam=getattr(hs, CAMS[dataset]), traj=traj,
            frames=range(k, n, step)):
        yield il.astype(np.uint8), ir.astype(np.uint8), T_wc[:3, 3]


def _stream_worker(q, *args):
    """One spawned worker's share of the frames into `q` (the queue's bound
    holds it back)."""
    for item in _render(*args):
        q.put(item)


class HardStream:
    """The first `n` frames of ``render_hard_sequence(n_seq, cam, dist,
    traj)`` of a dataset's rig, as uint8 pairs and gt positions, in order,
    rendered as they are read by `workers` spawned processes (default: one
    per CPU core, at most 8; 1 renders in this process). Each worker renders
    every workers-th frame and stays at most STREAM_DEPTH frames ahead, so a
    5000-frame sequence never sits in memory. Iterating again renders
    again."""

    def __init__(self, n: int, n_seq: int = HARD_N, dataset: str = "euroc",
                 traj: str = "loop", workers: int = None, seed: int = 0):
        self.n, self.n_seq, self.dataset, self.traj = n, n_seq, dataset, traj
        self.seed = seed
        self.workers = max(1, min(workers or min(8, os.cpu_count() or 1), n))

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        seq = (self.n, self.n_seq, self.dataset, self.traj, self.seed)
        if self.workers == 1:
            yield from _render(*seq)
            return
        import multiprocessing
        import queue
        ctx = multiprocessing.get_context("spawn")
        w = self.workers
        qs = [ctx.Queue(STREAM_DEPTH) for _ in range(w)]
        procs = [ctx.Process(target=_stream_worker, daemon=True,
                             args=(qs[k], *seq, k, w)) for k in range(w)]
        for p in procs:
            p.start()
        try:
            for i in range(self.n):
                while True:
                    try:
                        item = qs[i % w].get(timeout=10)
                        break
                    except queue.Empty:
                        if not procs[i % w].is_alive():
                            raise RuntimeError(
                                f"render worker {i % w} ended before frame {i}")
                yield item
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join()


def hard_frames(n: int, workers: int = None, **seq):
    """(left uint8 list, right uint8 list, gt positions (n, 3)): the first
    n frames of a HardStream (`seq`: its n_seq, dataset and traj; default
    render_hard_sequence(n_frames=1000) on the EuRoC rig)."""
    L, R, gt = zip(*HardStream(n, workers=workers, **seq))
    return list(L), list(R), np.stack(gt)


def tier_frames(name: str, n: int, seed: int = 0):
    """A tier's frames: (left, right, gt) lists for the synthetic tiers and
    for hard-sequence runs of at most HARD_N frames, else a HardStream. `n`
    is the prefix of a tier whose ``frames`` is 0; `seed` textures a hard
    sequence's world."""
    t = TIERS[name]
    if t is None:
        return kf2f_frames(BENCH_FRAMES if name == "bench" else KF2F_FRAMES)
    seq = dict(n_seq=t.frames or HARD_N, dataset=t.dataset, traj=t.traj,
               seed=seed)
    n = t.frames or n
    return hard_frames(n, **seq) if n <= HARD_N else HardStream(n, **seq)


def prefix_frames(name: str, tier: Optional[Tier], n: int,
                  workers: int = None, seed: int = 0):
    """The first n frames of tier `name`'s sequence (`tier` in place of its
    entry in TIERS): the synthetic tiers' lists, else a HardStream over
    the tier's hard sequence (``frames`` long, or HARD_N; its world
    textured from `seed`)."""
    if tier is None:
        return kf2f_frames(n)
    n_seq = tier.frames or HARD_N
    return HardStream(min(n, n_seq), n_seq=n_seq, dataset=tier.dataset,
                      traj=tier.traj, workers=workers, seed=seed)


def _synthetic_part(args):
    n, idx = args
    import synthetic_np as syn
    return syn.render_sequence(n_frames=n, step=KF2F_STEP, yaw_rate=KF2F_YAW,
                               frames=idx)


def synthetic_sequence(n: int, workers: int = None):
    """``synthetic_np.render_sequence(n, step=0.03, yaw_rate=0.0015)``
    (left, right, gt poses), the frames split over `workers` spawned
    processes (default: one per CPU core, at most 8; 1 renders here)."""
    workers = max(1, min(workers or min(8, os.cpu_count() or 1), n))
    parts = [(n, list(range(k, n, workers))) for k in range(workers)]
    if workers == 1:
        return _synthetic_part(parts[0])
    import multiprocessing
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        done = pool.map(_synthetic_part, parts)
    out = ([None] * n, [None] * n, [None] * n)
    for (_, idx), part in zip(parts, done):
        for seq, vals in zip(out, part):
            for i, v in zip(idx, vals):
                seq[i] = v
    return out


def kf2f_frames(n: int = KF2F_FRAMES):
    """(left, right, gt positions) of the synthetic slice (the kf2f and,
    with n = BENCH_FRAMES, the bench tier)."""
    fl, fr, gt = synthetic_sequence(n)
    return fl, fr, np.stack([T[:3, 3] for T in gt])


def trajectory_ate(logger, gt: np.ndarray, mono: bool) -> float:
    """ATE of the logged per-frame poses (frame i at time i * 0.05)."""
    return times_ate(logger.times, [np.asarray(T)[:3, 3] for T in logger.poses_wc],
                     gt, mono)


def stamped(times, positions, n: int) -> np.ndarray:
    """(n, 3) positions by frame (frame i at time i * FRAME_DT), NaN where
    none was logged."""
    est = np.full((n, 3), np.nan)
    for t, x in zip(times, positions):
        i = int(round(t / FRAME_DT))
        if 0 <= i < n:
            est[i] = x
    return est


def times_ate(times, positions, gt: np.ndarray, mono: bool) -> float:
    """ATE of positions stamped with times (frame i at i * FRAME_DT)."""
    from ov2slam_tpu_torch.io.trajectories import ate_rmse
    est = stamped(times, positions, len(gt))
    ok = np.isfinite(est).all(axis=1)
    if ok.sum() <= 10:
        return float("nan")
    return ate_rmse(est[ok], gt[ok], with_scale=mono)


def _percentiles(ms: np.ndarray, key: str) -> dict:
    return {f"{key}_p{q}": (float(np.percentile(ms, q)) if len(ms) else None)
            for q in (50, 90, 99)}


def latency_fields(call_ms, call_first, call_kfs, n: int, seconds: float,
                   t_warm: float) -> dict:
    """``scripts/hard_bench.py``'s row fields from the host ms of each
    ``process_*`` call (what a caller waits for), the first frame of each
    call and the map's keyframe count after it: ``fps_steady`` over the
    frames after WARMUP_FRAMES, ``frame_ms_p50`` / ``p90`` / ``p99`` (and
    ``_max``) of the calls after it (of every call when the run is no
    longer), the same for keyframe calls (``frame_ms_kf_*``: the keyframe
    count grew during the call, as ``scripts/profile_tier.py`` splits them)
    and cruise calls (``frame_ms_cruise_*``), ``warmup_s`` (seconds to the
    end of frame WARMUP_FRAMES - 1; 0 when the run is shorter) and the
    first call's ms. A call is one frame, or a chunk with
    ``process_stereo_chunk``."""
    ms = np.asarray(call_ms, np.float64)
    first = np.asarray(call_first)
    kf = np.zeros(len(ms), bool)
    kf[1:] = np.diff(np.asarray(call_kfs)) > 0
    steady = first >= WARMUP_FRAMES if n > WARMUP_FRAMES else np.ones(len(ms), bool)
    fps_steady = ((n - WARMUP_FRAMES) / (seconds - t_warm)
                  if n > WARMUP_FRAMES and seconds > t_warm else n / seconds)
    out = dict(fps_steady=fps_steady, warmup_s=t_warm,
               first_call_ms=float(ms[0]), steady_calls=int(steady.sum()),
               steady_kf_calls=int((steady & kf).sum()),
               frame_ms_max=float(ms[steady].max()))
    out.update(_percentiles(ms[steady], "frame_ms"))
    out.update(_percentiles(ms[steady & kf], "frame_ms_kf"))
    out.update(_percentiles(ms[steady & ~kf], "frame_ms_cruise"))
    return out


def run_tier(slam, frames, mono: bool, call=None, sync=None,
             chunk: int = 1) -> dict:
    """Drive `slam` over frames, a (left, right, gt) tuple or a HardStream,
    then flush. `call(i, fn)` wraps each call (default: fn()): each
    frame's, or with chunk > 1 (stereo) each ``process_stereo_chunk``
    call's, i its first frame; `sync()` waits for the device before the
    clock is read. Returns the tier's numbers (fps after the first call;
    the fields of ``latency_fields`` from each call's host time, no sync
    added; in the pipelined mode the pose a call returns lags
    ``pose_lag_frames`` frames, ``pipeline_depth``)."""
    if isinstance(frames, HardStream):
        n, src = len(frames), iter(frames)
    else:
        n, src = len(frames[2]), zip(*frames)
    gt = np.zeros((n, 3))
    call = call or (lambda i, fn: fn())
    sync = sync or (lambda: None)
    depth, t_first, n_first, batch = 0, None, 1, []
    call_ms, call_first, call_kfs, t_warm = [], [], [], 0.0
    step = chunk if chunk > 1 and not mono else 1
    t0 = time.perf_counter()
    for j, (il, ir, pos) in enumerate(src):
        gt[j] = pos
        batch.append((il, ir, j * FRAME_DT))
        if len(batch) < step and j < n - 1:
            continue
        i = j + 1 - len(batch)
        tc = time.perf_counter()
        if mono:
            call(i, lambda: slam.process_mono(il, i * FRAME_DT))
        elif step > 1:
            call(i, lambda: slam.process_stereo_chunk(batch))
        else:
            call(i, lambda: slam.process_stereo(il, ir, i * FRAME_DT))
        t_call = time.perf_counter()
        call_ms.append(1e3 * (t_call - tc))
        call_first.append(i)
        call_kfs.append(len(slam.map.keyframes))
        if i <= WARMUP_FRAMES - 1 <= j:
            t_warm = t_call - t0
        depth = max(depth, len(slam._inflight))
        if i == 0:
            sync()
            t_first, n_first = time.perf_counter(), len(batch)
        batch = []
    slam.flush()
    sync()
    t_end = time.perf_counter()
    est = stamped(slam.logger.times,
                  [np.asarray(T)[:3, 3] for T in slam.logger.poses_wc], n)
    row = dict(
        ate=trajectory_ate(slam.logger, gt, mono), frames=n,
        logged=len(slam.logger.times), keyframes=len(slam.map.keyframes),
        landmarks=int(slam.map.n_3d()), max_inflight=depth,
        seconds=t_end - t0, fps=(n - n_first) / max(t_end - t_first, 1e-9),
        initialized=bool(slam.initialized),
        tracked_pct=100.0 * float(np.isfinite(est).all(axis=1).mean()),
        pose_lag_frames=(slam.params.pipeline_depth
                         if slam.params.force_realtime else 0),
        call_frames=step,
        **latency_fields(call_ms, call_first, call_kfs, n, t_end - t0, t_warm))
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


def timing_span_ba(slam, sync=None) -> list:
    """Record the host seconds of each of the system's span BAs (the card
    synchronised around it) in the returned list."""
    sync = sync or (lambda: None)
    est, real, secs = slam.estimator, slam.estimator.span_ba, []

    def timed(*a, **k):
        sync()
        t0 = time.perf_counter()
        out = real(*a, **k)
        sync()
        secs.append(time.perf_counter() - t0)
        return out
    est.span_ba = timed
    return secs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("torch", "jax"), default="torch")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--tiers", default=",".join(
        [n for n, t in TIERS.items() if t is None or t.frames <= HARD_N]
        + list(OAB)))
    ap.add_argument("--chunk", type=int, default=1,
                    help="stereo frames per process_stereo_chunk call")
    ap.add_argument("--out", type=Path, help="also append the lines here")
    ap.add_argument("--seed", type=int, default=0,
                    help="texture seed of the hard sequences' world")
    ap.add_argument("--pyr-dtype", choices=("float16", "float32"),
                    default="float16", help="the front end's pyramid "
                    "storage in either package (float16 as shipped; "
                    "float32 as a witness)")
    args = ap.parse_args()
    names = args.tiers.split(",")
    sync, cuda = None, False
    if args.backend == "torch":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        import torch
        torch.set_num_threads(min(torch.get_num_threads(), 8))
        cuda = args.device is None or str(args.device).startswith("cuda")
        if cuda:
            sync = torch.cuda.synchronize
        from ov2slam_tpu_torch.slam import frontend
        frontend.PYR_DT = getattr(torch, args.pyr_dtype)
    else:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax.numpy as jnp
        import ov2slam_tpu.slam.frontend as jfrontend
        jfrontend.PYR_DT = getattr(jnp, args.pyr_dtype)
    oab = oab_frames() if any(n in OAB for n in names) else None
    cache = {}

    def seq_key(name):
        t = TIERS.get(name)
        return t and (t.frames or HARD_N, t.dataset, t.traj, args.seed)

    def frames_of(name):
        """The tier's frames; a hard sequence of at most HARD_N frames is
        rendered once, as long as its longest tier needs."""
        t, key = TIERS[name], seq_key(name)
        if t is None or t.frames > HARD_N:
            return tier_frames(name, args.frames, args.seed)
        if key not in cache:
            cache.clear()
            need = max(TIERS[m].frames or args.frames
                       for m in names if seq_key(m) == key)
            cache[key] = tier_frames(name, need, args.seed)
        return tuple(x[:t.frames or args.frames] for x in cache[key])

    for name in names:
        t = TIERS.get(name)
        d = oab_dict(name) if name in OAB else tier_dict(name)
        ops = set()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        with (deterministic(ops) if args.backend == "torch"
              and d.get("buse_loop_closer") else contextlib.nullcontext()):
            if name in OAB:
                slam = make_system(args.backend, d, args.device)
                row = run_oab(slam, name, oab, sync=sync)
            else:
                frames = frames_of(name)
                detector = (LC_DETECTOR if d.get("buse_loop_closer")
                            and not (t and t.stock_lc) else None)
                slam = make_system(args.backend, d, args.device, detector)
                span = timing_span_ba(slam, sync)
                row = run_tier(slam, frames, bool(d.get("mono")), sync=sync,
                               chunk=args.chunk)
                row.update(span_ba_seconds=span,
                           ba_timeouts=slam.estimator.n_ba_timeouts,
                           ba_truncations=slam.estimator.n_truncations)
        row = dict(tier=name, backend=args.backend, chunk=args.chunk,
                   seed=args.seed, pyr_dtype=args.pyr_dtype, **row)
        if cuda:
            row["peak_device_bytes"] = torch.cuda.max_memory_allocated()
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
