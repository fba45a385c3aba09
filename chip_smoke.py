"""GPU smoke run of the PyTorch/CUDA port (ov2slam_tpu_torch).

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (any failure raises; nothing falls back to the CPU):
1. device: ``nvidia-smi`` name and power limit, precision policy, CUDA check;
2. build: compile ``csrc/lk_iterate.cu`` and ``csrc/klt_track.cu`` with one
   nvcc each, started together, and print ptxas' registers, shared memory
   and spills;
3. kernel lk_iterate: the per-chunk LK loop against its plain PyTorch
   version on the card, on seeded inputs at the slice's shapes; device time
   by CUDA-graph replay;
4. kernel klt_track: the fused forward-backward KLT against
   ``fb_klt_tracking_plain`` on the card, on two rendered 752x480 frames at
   N = 192 and 320 (temporal pair with prior jitter 0 and 1.5 px; stereo
   pair without gradient pyramids); then, in turns on the same inputs, the
   kernel by CUDA-graph replay, the whole ``fb_klt_tracking`` call and the
   per-chunk path (the plain glue around the ``lk_iterate`` kernel) by host
   clock;
5. ransac: ``essential_ransac`` (5-point, K = 512) and ``p3p_ransac``
   (K = 256) on the card and on the CPU with the same sample indices, on
   the correspondences of a rendered 752x480 pair 4 steps apart (step 0.05,
   ~11 px of parallax); host time and device operations per call, and no
   host sync inside either call; then the port's ``track_frame`` with the
   epipolar filter on that pair (the gate must fire and the filter apply);
6. clahe: ``clahe`` on the card against the CPU on a rendered frame;
7. slice: a 60-frame 752x480 synthetic stereo sequence through
   ``SlamSystem.process_stereo`` on the card with the epipolar filter on
   (``bench.py``'s config without ``force_realtime``), trajectory files
   written, ATE checked, and the kernels' launch counts read around every
   frame (one ``klt_track`` launch per tracking-only frame, at least one in
   the first keyframe's stereo matching), and the host syncs of every frame
   counted by call site (PyTorch's sync debug mode), the epipolar gate's
   read among them;
8. mono slice: 60 frames of the same rig (step 0.05) through
   ``SlamSystem.process_mono`` with the front-end settings the presets
   switch on (``doepipolar``, ``dop3p``, ``use_clahe``): initialization,
   Sim(3)-aligned ATE, trajectory files, exactly one ``klt_track`` launch
   in every frame after the first, host syncs by call site;
9. presets: the five reference tiers without loop closing built from the
   shipped preset files (``fast_stereo``, ``accurate_stereo_nolc``,
   ``accurate_mono``, ``average_mono``, ``fast_mono``;
   ``scripts/torch_preset_tiers.py``), only the camera replaced by the
   distorted EuRoC rig of ``tests/hard_synthetic.py``, run as shipped
   (``force_realtime``: pipelined frames, staged keyframe commits, deferred
   BA; FAST and the P3P start in the ``fast`` tiers) over the first
   ``TIER_FRAMES`` frames of ``render_hard_sequence(n_frames=1000)`` under
   PyTorch's deterministic algorithms (so that each ATE repeats), then
   flushed: one finite pose per frame, the in-flight FIFO at
   ``pipeline_depth``, staged commits and deferred BA writebacks landing
   (stereo), exactly one ``klt_track`` launch per tracking call beside one
   per keyframe stereo match, host syncs per frame by call site, and each
   ATE within 1.5x + 5 mm of the JAX package's on the same frames
   (``REF_ATE``, measured on the CPU by the same script);
10. rect: ``accurate_stereo_rect`` (``bdo_stereo_rect``, every frame
   remapped bicubic on the card) on the same frames, and the 60-frame
   synthetic slice with ``btrack_keyframetoframe`` (KLT templates from the
   last keyframe), under the same checks;
11. loop: ``accurate_stereo``, the shipped loop-closing preset
   (``force_realtime``, the loop closer on; the loop detector scaled as
   ``scripts/hard_bench.py`` scales it), over all 1000 frames of
   ``render_hard_sequence`` (the trajectory revisits its start after ~926):
   at least one loop closure with >= 30 inliers, one finite pose per frame,
   live and relaxed full-trajectory (``wlc_opt``) ATEs within 1.5x + 5 mm
   of the JAX package's on the CPU, host ms of the loop-closing stage per
   keyframe, of each closure and of its span BA, and of the final passes;
   every closure must move its query keyframe by at least half the pose
   jump PnP measured (a correction that did nothing fails); then the
   out-and-back world of ``tests/test_loopclosing.py``
   (``tests/loop_synthetic_np.py``, 100 frames): synchronous stereo with
   ``do_full_ba`` (a loop closes, the local-map expansion grows the match
   set, the three final-pass files are written with a finite row per frame,
   ATE < 0.08; the closure's device operations under the profiler),
   pipelined stereo (a loop closes, one pose per frame, no step > 0.25 m),
   mono (a loop closes, Sim(3) ``wlc_opt`` ATE < 0.08 and <= 1.2x live +
   1 mm) and the stereo kidnap (relocalized within 0.1 m, a new tracking
   chain), each closure under the same gate on its query keyframe. Every
   path launches ``klt_track`` exactly once per tracking call besides one
   per keyframe stereo match, and ``lk_iterate`` never. Every loop path
   runs under PyTorch's deterministic algorithms
   (``torch_preset_tiers.deterministic``; ``CUBLAS_WORKSPACE_CONFIG`` is
   set before the card is first used), so that its ATE repeats from run to
   run on the card. Phases 1-10, ``accurate_stereo``, phase 12 and phase
   13 (a)-(b) run alone, one after the other, so their times stay
   comparable; the four out-and-back runs come last, as processes of their
   own (``--loop-run NAME``) started together beside phase 13 (c), so
   their host times are not clean timings;
12. cli: ``python -m ov2slam_tpu_torch.run``'s ``main``, called in this
   process with no ``--device`` (the card), over the first ``CLI_FRAMES``
   frames of the hard sequence written as an EuRoC ASL tree
   (``scripts/torch_cli_run.py``: PNG rows filtered with every type in
   turn, ns stamps at 20 Hz, the right camera 2 ms later, ``data.csv``)
   with the shipped ``accurate_stereo_nolc`` preset as a YAML file: the
   port's PNG decoder gives the written pixels (host ms per image); run
   (a) as shipped (``force_realtime``: frames dropped by the wall clock)
   accounts for every frame (processed + dropped), a finite trajectory row
   per processed frame; run (b) with ``force_realtime`` 0, twice: a row per
   frame, byte-identical trajectory files (the CLI runs under PyTorch's
   deterministic algorithms) and the ATE within 1.5x + 5 mm of the JAX
   package's CLI on the same directory on the CPU (``REF_CLI_ATE``); every
   run has ``log_timings`` on and a profiler table with ``CLI_LABELS``, and
   once it took a second keyframe the local BA's (``CLI_BA_LABELS``);
   every run launches ``klt_track`` exactly once per tracking call besides
   one per keyframe stereo match, and ``lk_iterate`` never;
13. chunk: the throughput path. (a) One replay of the frame step's CUDA
   graphs (``slam/graphs.py``) against the eager ``frame_step`` from the
   same state and generator state, with the parallax gate shut and open:
   keypoint masks equal, stats and pose within ``GRAPH_TOL``; then
   ``bench.py``'s surface at full width (``CHUNK_FRAMES`` frames, step
   0.03, ``slam_params_dict()``) through ``process_stereo_chunk`` in chunks
   of ``CHUNK``: one finite pose per frame, keyframes only on a chunk's
   last frame, the ATE within 1.5x + 5 mm of the JAX package's
   ``process_stereo_chunk`` on the CPU (``REF_CHUNK_ATE``), one capture,
   one graph ``klt_track`` launch per chunked frame (the kernel node
   times its replays; the wrapper counts its warm-up and capture
   launches, the frame-by-frame first chunk and the keyframe stereo
   matches), and in every chunk call after the capture no host sync but
   the gate's read, one per frame; ms per frame chunked and frame by frame
   in turns (frames ``TIMED_FROM``-``TIMED_TO``), then 16 frames of each
   under the profiler (device idle share); (b) the CLI with ``--chunk``
   over the cli phase's tree, ``force_realtime`` 0: ATE within 1.5x + 5 mm
   of the JAX CLI with ``--chunk 8`` on the CPU (``REF_CLI_CHUNK_ATE``);
   (c) ``accurate_stereo_rect`` twice in this process with PyTorch's
   deterministic algorithms off (the BA's sums are ordered): the two
   trajectories equal element for element; then once under
   ``torch.use_deterministic_algorithms(True)`` without ``warn_only``,
   which raises on any operation without a deterministic version. (c) runs
   beside the out-and-back runs of phase 11.

The hard sequence is rendered once, at the start, by worker processes.

Each path's launch counts are set to 0 just before it runs and read just
after; the ``kernels`` line sums them over every path.
The last three lines of standard output are the card's ``nvidia-smi`` name
and power limit, a JSON object describing the kernels (``klt_track`` also
with the launches its graph replays made, ``graph_replay_launches``), and
``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --profile DIR`` also runs the slice before and after
the fused kernel, in turns (fused, per-chunk, fused, per-chunk; frames
1-59 each), then with the epipolar filter on and off in turns, frames
1-20 of each KLT path, frames 20-29 of the mono slice and frames 20-39 of
the pipelined ``accurate_stereo_nolc`` and ``fast_mono`` tiers under
``torch.profiler``: fps, device idle share and device operations per frame,
with the full tables in ``DIR/torch_profile_<slice>.txt``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from ov2slam_tpu_torch import device as device_mod  # noqa: E402
from ov2slam_tpu_torch.config import SlamParams  # noqa: E402
from ov2slam_tpu_torch.io.trajectories import ate_rmse  # noqa: E402
from ov2slam_tpu_torch.ops import _build, klt, lk  # noqa: E402
from ov2slam_tpu_torch.ops import image as im  # noqa: E402
from ov2slam_tpu_torch.ops import mvg  # noqa: E402
from ov2slam_tpu_torch.slam import frontend as fe_mod  # noqa: E402
from ov2slam_tpu_torch.slam import graphs as graphs_mod  # noqa: E402
from ov2slam_tpu_torch.slam import mapper as mapper_mod  # noqa: E402
from ov2slam_tpu_torch.slam.manager import SlamSystem  # noqa: E402
sys.path.insert(0, str(ROOT / "scripts"))
import klt_inputs  # noqa: E402
import synthetic_np as syn  # noqa: E402
import torch_cli_run as cli  # noqa: E402
import torch_preset_tiers as tiers  # noqa: E402

WS, WIN, EPS, MARGIN = 20, 9, 0.01, 4.0
N_FRAMES, STEP, YAW = 60, 0.03, 0.0015
# kernel vs plain on the card: both run float32 GN steps and differ only in
# summation order. lk_iterate: points that stopped the same way in both
# (converged, or paused at the margin) must agree to 2e-3 px; every point
# to eps: a point that converged one step earlier in one version differs by
# that last step, which is below eps, and a point still iterating when the
# budget ends has not converged (it oscillates) — the rule of
# tests/test_torch_lk.py. klt_track: status equal on 99% of points, points
# to 2e-3 px and error to 1e-3 where both tracked (LK resolves 0.01 px).
PTS_TOL, MASK_AGREE, ERR_TOL = 2e-3, 0.99, 1e-3
KLT_CASES = (("temporal", 0.0), ("temporal", 1.5), ("keyframe", 1.5),
             ("stereo", 0.0))
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32
# FLOP/s outside the tensor cores. One GN step costs ~30 FLOPs per patch
# sample (four hat weights, two taps per row, the blend, the residual and
# two multiply-adds).
HBM_BPS, F32_FLOPS, FLOPS_PER_SAMPLE = 3.35e12, 67e12, 30
# RANSAC and CLAHE on the card vs the CPU (plain PyTorch both; cuSOLVER and
# LAPACK round the batched solves differently): inlier masks equal on 99%,
# rotations within 1e-3 rad, translation directions within 1e-2 rad; CLAHE
# within 0.01 gray levels. Mono: the Sim(3) ATE bound of
# tests/test_e2e_mono.py.
INL_AGREE, ROT_TOL, DIR_TOL, CLAHE_TOL, MONO_ATE = 0.99, 1e-3, 1e-2, 0.01, 0.08
MONO_STEP = 0.05
# the preset and rect tiers: frames of render_hard_sequence(n_frames=1000)
# (kf2f: the 60-frame slice), and each tier's ATE (m, Sim(3)-aligned for
# mono) of the JAX package on the same frames, on the CPU
# (`JAX_PLATFORMS=cpu python3 scripts/torch_preset_tiers.py --backend jax`);
# the card must stay within ATE_SLACK * ref + ATE_ABS
TIER_FRAMES = 120
# accurate_stereo (loop closer on) over all 1000 frames: live and wlc_opt
# ATE of the JAX package on the CPU (same script, --backend jax)
REF_LC_ATE, REF_LC_WLC_OPT = 0.031816659029515935, 0.033392770636519055
PRESET_TIERS = ("fast_stereo", "accurate_stereo_nolc", "accurate_mono",
                "average_mono", "fast_mono")
RECT_TIERS = ("accurate_stereo_rect", "kf2f")
REF_ATE = {"fast_stereo": 0.011895194593247387,
           "accurate_stereo_nolc": 0.010244281714802394,
           "accurate_mono": 0.020605251339490118,
           "average_mono": 0.024823707626498864,
           "fast_mono": 0.022862843679698763,
           "accurate_stereo_rect": 0.013126949970873455,
           "kf2f": 0.0005095717850380572,
           "accurate_stereo": REF_LC_ATE,
           "accurate_stereo_wlc_opt": REF_LC_WLC_OPT}
ATE_SLACK, ATE_ABS = 1.5, 0.005
# the cli phase: the first CLI_FRAMES frames of the hard sequence as an
# EuRoC tree, accurate_stereo_nolc as a YAML preset
# (scripts/torch_cli_run.py); the ATE of the JAX package's CLI over it on
# the CPU with force_realtime 0 (`JAX_PLATFORMS=cpu python3
# scripts/torch_cli_run.py --backend jax`); the profiler labels every
# table must hold, and those of the local BA (deferred when pipelined) that
# a run's table must hold once it took a second keyframe: run (a), whose
# frames drop by the wall clock, can lose track after an early drop and
# take no other
CLI_FRAMES = cli.CLI_FRAMES
REF_CLI_ATE = 0.006771421627648784
CLI_LABELS = ("0.Full-Front_End", "2.KF_DeviceStep", "2.KF_Registry_fetch")
CLI_BA_LABELS = {0: ("1.BA_localBA",), 1: ("1.BA_localBA", "1.BA_begin")}
# the chunk phase: bench.py's surface (tests/synthetic_np.py's sequence of
# CHUNK_FRAMES frames, slam_params_dict()) through process_stereo_chunk in
# chunks of CHUNK, and the ATE of the JAX package's process_stereo_chunk
# over it on the CPU (`JAX_PLATFORMS=cpu python3
# scripts/torch_preset_tiers.py --backend jax --tiers bench --chunk 8`);
# the cli phase's tree through the CLI with --chunk CHUNK, and the JAX
# CLI's ATE with --chunk 8 on the CPU (`JAX_PLATFORMS=cpu python3
# scripts/torch_cli_run.py --backend jax --chunk 8`); a replay of the
# captured frame step against the eager step on the same state: keypoint
# masks equal, stats and pose within GRAPH_TOL (the same kernels on the
# same inputs; cuBLAS may pick another algorithm inside a capture); frames
# TIMED_FROM.. TIMED_TO - 1 timed in turns, chunked and frame by frame (the
# first chunk runs frame by frame until the map is initialized, the second
# captures the graphs)
CHUNK, CHUNK_FRAMES = 8, 120
REF_CHUNK_ATE = 0.0028613772975224585
REF_CLI_CHUNK_ATE = 0.007055916346033503
GRAPH_TOL = 1e-5
TIMED_FROM, TIMED_TO = 16, 64
# the loop phase: the out-and-back runs of scripts/torch_preset_tiers.py and
# their gates (tests/test_loopclosing.py's)
LOOP_RUNS = ("oab_stereo", "oab_stereo_rt", "oab_mono", "oab_kidnap")
OAB_ATE, OAB_MAX_STEP, RELOC_ERR, MIN_INLIERS = 0.08, 0.25, 0.1, 30
# a closure moves its query keyframe by at least this share of the pose jump
# PnP measured: the local pose graph spreads the loop edge's error over the
# chain's n edges and the loop edge, all of unit weight, so the query
# keyframe moves by about n / (n + 1) of the jump (n >= 2); a correction
# that did nothing moves it by 0
MOVE_SHARE = 0.5


def log(msg: str):
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


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


def graph_ms(fn, reps: int = 200) -> float:
    """Device time per call: `reps` calls captured in one CUDA graph, the
    replay timed with CUDA events, so the host's per-call work (argument
    checks, allocations, the ctypes call) is left out."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_ms(fn, reps: int) -> float:
    """Wall time per call, each call synchronised (the latency a frame
    sees), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return 1000 * (time.perf_counter() - t0) / reps


def recording_lk(calls: list):
    """lk.lk_iterate_plain run one GN step at a time (the same result),
    recording what this run's data needs: per call, its window origins and,
    per step, the points (N, 2) and the active mask (N,) at which the step
    samples its patch."""
    def fn(*args, win, n_iters, eps, margin):
        *head, p, a = args
        cv = torch.zeros_like(a)
        steps = []
        calls.append((head[8], steps))
        for _ in range(n_iters):
            if not bool(a.any()):
                break
            steps.append((p, a))
            p, a, c = lk.lk_iterate_plain(*head, p, a, win=win, n_iters=1,
                                          eps=eps, margin=margin)
            cv = cv | c
        return p, a, cv
    return fn


def steps_per_point(calls: list) -> torch.Tensor:
    """(N,) GN steps each point took over the recorded calls."""
    return sum((a.long() for _, steps in calls for _, a in steps),
               torch.zeros((), dtype=torch.long))


def mark_patches(mask, q, o, sel, win: int, ws: int) -> int:
    """Mark in `mask` (a plane's shape) the pixels that the win x win
    hat-weighted patches centred at q (N, 2) read inside their ws x ws
    windows at origins o (N, 2), for the points in `sel`: per axis from
    floor(q - o - r) to ceil(q - o - r + win - 1), r = (win - 1) / 2,
    clipped to the window (samples outside it are zero). Returns the
    number of patches."""
    q, o = q[sel], o[sel].long()
    r = (win - 1) / 2.0
    lo = torch.floor(q - o - r).long().clamp(min=0)
    hi = torch.ceil(q - o - r + win - 1).long().clamp(max=ws - 1)
    ar = torch.arange(win + 1, device=q.device)
    xs, ys = lo[:, 0, None] + ar, lo[:, 1, None] + ar           # (M, win + 1)
    keep = (ys <= hi[:, 1, None])[:, :, None] & (xs <= hi[:, 0, None])[:, None, :]
    rows = (o[:, 1, None] + ys)[:, :, None].expand_as(keep)
    cols = (o[:, 0, None] + xs)[:, None, :].expand_as(keep)
    mask[rows[keep], cols[keep]] = True
    return q.shape[0]


def bound(nbytes: float, ops: float):
    """(ms, "bytes" | "operations"): the larger of the two least times."""
    t_bytes, t_ops = 1e3 * nbytes / HBM_BPS, 1e3 * ops / F32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lk_bound(args, kw):
    """Least time of one lk_iterate call on these inputs. Bytes: the window
    pixels its GN steps' patches read (per point, the union of the steps'
    footprints), each read once, the template, gradients and per-point
    inputs of every point, and the outputs. Operations: the GN steps this
    input needs (recorded from the plain version's run)."""
    calls = []
    recording_lk(calls)(*args, **kw)
    o_rec, steps = calls[0]
    N, ws, P = args[0].shape[0], args[0].shape[1], kw["win"] ** 2
    # the N windows stacked in one (N * ws, ws) plane
    ar = torch.arange(N, device=o_rec.device)
    shift = torch.stack([torch.zeros_like(ar), ws * ar], -1)
    mask = torch.zeros((N * ws, ws), dtype=torch.bool, device=o_rec.device)
    for p, a in steps:
        mark_patches(mask, p - o_rec + shift, shift, a, kw["win"], ws)
    n_steps = sum(int(a.sum()) for _, a in steps)
    nbytes = (4 * int(mask.sum()) + N * ((3 * P + 4) * 4 + 8 + 8 + 8 + 1)
              + N * (8 + 1 + 1))
    ops = n_steps * P * FLOPS_PER_SAMPLE
    return bound(nbytes, ops) + (nbytes, ops, calls)


def phase_kernel(dev):
    """lk_iterate vs plain at N in {192, 320} and n_iters in {1, 10, 30}."""
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
            k_ms = graph_ms(lambda: lk.lk_iterate(*args, **kw))
            p_ms = cuda_ms(lambda: lk.lk_iterate_plain(*args, **kw), 20)
            b_ms, b_by, nbytes, ops, calls = lk_bound(args, kw)
            per_point = steps_per_point(calls)
            times[(N, n_iters)] = (k_ms, p_ms, b_ms, b_by)
            log(f"[kernel lk_iterate] N={N} n_iters={n_iters}: max |dp| "
                f"{err_all:.3g} px (stopped alike {err_same:.3g}), active "
                f"agree {a_agree:.4f}, converged agree {c_agree:.4f}; device "
                f"{k_ms:.5f} ms (graph replay), plain {p_ms:.4f} ms; bound "
                f"{b_ms:.6f} ms by {b_by} ({nbytes} B; {ops} FLOP, "
                f"{int(per_point.sum())} GN steps, at most "
                f"{int(per_point.max())} for one point)")
    torch.cuda.synchronize()
    return worst, times


def klt_window_origins(q, shape, ws: int):
    """ops/klt.py's window origins: clamp(round(q) - ws // 2) per axis."""
    H, W = shape
    o = torch.round(q).long() - ws // 2
    return torch.stack([o[:, 0].clamp(0, W - ws), o[:, 1].clamp(0, H - ws)], -1)


def klt_bound(args, kw):
    """Least time of one fb_klt_tracking call on these inputs, from the
    plain version's run. Bytes: the pixels its patches read, each read once
    (per plane, the union of the footprints of the template patches, of
    every GN step's patch and of the level-0 error patch), plus the
    per-point inputs and outputs. Operations: those patches' samples.
    Planes are named: prev/next image and gradients per level."""
    p0, p1, pts, prior, valid = args
    N, nl, win = pts.shape[0], kw["nlevels"], kw["win"]
    ws, P, n_chunks, max_err = win + 11, win * win, 3, 30.0
    calls = []
    klt.fb_klt_tracking_plain(*args, **kw, lk_fn=recording_lk(calls))
    fwd = klt.pyr_klt(list(p0), list(p1), pts, prior, valid, nl, win,
                      prev_grad_pyr=kw.get("prev_grad_pyr"))
    good = fwd.status & (fwd.error < max_err)
    masks = {}

    def mark(name, lvl, q, o, sel):
        shape = p0[lvl].shape
        m = masks.setdefault((name, lvl), torch.zeros(
            shape, dtype=torch.bool, device=pts.device))
        return mark_patches(m, q, o, sel, win, ws)

    def in_bounds(q, lvl):
        H, W = p0[lvl].shape
        h = (win - 1) / 2.0
        return ((q[:, 0] >= h) & (q[:, 0] < W - h)
                & (q[:, 1] >= h) & (q[:, 1] < H - h))

    patches = 0
    # templates: per level the points it tracks; at level 0 every point's
    # image patch too (the error is every point's output)
    for lvl in range(nl + 1):
        q = pts / 2.0 ** lvl
        o = klt_window_origins(q, p0[lvl].shape, ws)
        track = valid & in_bounds(q, lvl)
        patches += mark("prev", lvl, q, o, track | (lvl == 0))
        patches += mark("prev_gx", lvl, q, o, track) + mark("prev_gy", lvl, q, o, track)
    # the backward template at the forward points, for the good ones
    o = klt_window_origins(fwd.points, p0[0].shape, ws)
    track = good & in_bounds(fwd.points, 0)
    for name in ("next", "next_gx", "next_gy"):
        patches += mark(name, 0, fwd.points, o, track)
    # every GN step's patch, in the plain version's call order
    planes = ([("next", nl)] * n_chunks + [("next", l) for l in range(nl - 1, -1, -1)]
              + [("prev", 0)] * min(n_chunks, 2))
    assert len(calls) == len(planes), (len(calls), len(planes))
    for (name, lvl), (o_call, steps) in zip(planes, calls):
        for p, a in steps:
            patches += mark(name, lvl, p, o_call, a)
    # the error: every forward point in its last level-0 window
    o_err = calls[len(planes) - min(n_chunks, 2) - 1][0]
    patches += mark("next", 0, fwd.points, o_err, torch.ones_like(valid))
    nbytes = 4 * sum(int(m.sum()) for m in masks.values()) + N * (8 + 8 + 1 + 8 + 1 + 4)
    ops = patches * P * FLOPS_PER_SAMPLE
    return bound(nbytes, ops) + (nbytes, ops, calls)


def per_chunk_klt():
    """fb_klt_tracking_plain around the lk_iterate kernel: the per-chunk
    path that the fused kernel replaced, for before/after timings."""
    return functools.partial(klt.fb_klt_tracking_plain, lk_fn=lk.lk_iterate)


def phase_klt(dev, frames):
    """klt_track vs fb_klt_tracking_plain on the card, then its timings."""
    worst = 0.0
    for N in (192, 320):
        for pair, jitter in KLT_CASES:
            args, kw = klt_inputs.klt_case(frames, N, pair, jitter, dev)
            r = klt.fb_klt_tracking(*args, **kw)
            rp = klt.fb_klt_tracking_plain(*args, **kw)
            torch.cuda.synchronize()
            agree = float((r.status == rp.status).float().mean())
            both = r.status & rp.status
            dp = float((r.points - rp.points).abs()[both].max()) if bool(both.any()) else 0.0
            de = float((r.error - rp.error).abs()[both].max()) if bool(both.any()) else 0.0
            log(f"[kernel klt_track] N={N} {pair} jitter {jitter}: tracked "
                f"{int(r.status.sum())} / plain {int(rp.status.sum())} of "
                f"{int(args[4].sum())} valid, status agree {agree:.4f}, max "
                f"|dp| {dp:.3g} px, max |derr| {de:.3g} where both tracked")
            if agree < MASK_AGREE or dp > PTS_TOL or de > ERR_TOL or int(both.sum()) < 100:
                raise AssertionError(
                    f"klt_track N={N} {pair} jitter {jitter}: status agree "
                    f"{agree:.4f} (need {MASK_AGREE}), |dp| {dp:.3g} (tol "
                    f"{PTS_TOL}), |derr| {de:.3g} (tol {ERR_TOL}), "
                    f"{int(both.sum())} tracked by both")
            worst = max(worst, dp)

    # timings at the slice's shapes (N = kp_cap = 192): the front end's
    # tracking call and the mapper's stereo call, in turns on one card
    times = {}
    for pair, jitter in (("temporal", 1.5), ("stereo", 0.0)):
        args, kw = klt_inputs.klt_case(frames, 192, pair, jitter, dev)
        gkw = dict(kw)
        if pair == "stereo":     # the kernel alone: gradients made here once
            gkw["prev_grad_pyr"] = [im.scharr_gradients(a) for a in args[0]]
            gkw["next_grad_pyr"] = [im.scharr_gradients(a) for a in args[1]]
        k_ms = graph_ms(lambda: klt.fb_klt_tracking(*args, **gkw))
        fused = lambda: klt.fb_klt_tracking(*args, **kw)          # noqa: E731
        chunked = lambda: per_chunk_klt()(*args, **kw)            # noqa: E731
        turns = [host_ms(fused, 50), host_ms(chunked, 20),
                 host_ms(fused, 50), host_ms(chunked, 20)]
        p_ms = host_ms(lambda: klt.fb_klt_tracking_plain(*args, **kw), 3)
        b_ms, b_by, nbytes, ops, calls = klt_bound(args, gkw)
        per_point = steps_per_point(calls)
        times[pair] = (k_ms, p_ms, b_ms, b_by)
        log(f"[kernel klt_track] timing N=192 {pair}: device {k_ms:.5f} ms "
            f"(graph replay); whole call {turns[0]:.4f} / {turns[2]:.4f} ms "
            f"vs per-chunk path {turns[1]:.4f} / {turns[3]:.4f} ms (host "
            f"clock, in turns); plain {p_ms:.3f} ms; bound {b_ms:.6f} ms by "
            f"{b_by} ({nbytes} B; {ops} FLOP, {int(per_point.sum())} GN "
            f"steps, at most {int(per_point.max())} for one point)")
    torch.cuda.synchronize()
    return worst, times


def _is_scope(e) -> bool:
    """The port's record_function scopes ("0.Full-Front_End", ...)."""
    return e.key[:2] in ("0.", "1.", "2.")


def profile_run(fn):
    """fn() under torch.profiler: (wall ms, device busy ms, device
    operations (kernel launches and copies), the profiler's key_averages)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1000 * (time.perf_counter() - t0)
    events = prof.key_averages()
    ops = [e for e in events if e.device_type == DeviceType.CUDA and not _is_scope(e)]
    return (wall_ms, sum(e.self_device_time_total for e in ops) / 1000,
            sum(e.count for e in ops), events)


def log_profile(tag: str, what: str, n_frames: int, run, out: Path):
    """Print a profile_run result per frame, its scopes and its costliest
    device operations, and write the profiler's tables to out."""
    from torch.autograd import DeviceType
    wall_ms, busy_ms, n_ops, events = run
    log(f"[{tag}] {what} under the profiler: wall {wall_ms:.0f} ms, device "
        f"busy {busy_ms:.1f} ms (idle share {1 - busy_ms / wall_ms:.3f}), "
        f"{n_ops} device operations ({n_ops / n_frames:.0f} per frame)")
    for e in sorted((e for e in events if _is_scope(e)
                     and e.device_type == DeviceType.CPU),
                    key=lambda e: -e.cpu_time_total):
        log(f"[{tag}] scope {e.key}: {e.count} calls, "
            f"{e.cpu_time_total / 1000:.0f} ms host")
    ops = [e for e in events if e.device_type == DeviceType.CUDA and not _is_scope(e)]
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[{tag}] operation {e.key[:70]}: {e.count} launches, "
            f"{e.self_device_time_total / 1000:.1f} ms")
    out.write_text(
        f"{what}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
        f"{n_ops} device operations\n\nby self device time\n"
        + events.table(sort_by="self_device_time_total", row_limit=40)
        + "\n\nby host total\n"
        + events.table(sort_by="cpu_time_total", row_limit=40) + "\n")


def count_syncs(fn, sites: collections.Counter):
    """fn() under PyTorch's sync debug mode: every operation that makes the
    host wait for the card (a read-back, a copy from pageable memory) is
    added to `sites` under its calling line ("ov2slam_tpu_torch/...:line",
    or torch's own file for calls made inside torch). Returns fn()."""
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in ws:
        if "called a synchronizing CUDA operation" in str(w.message):
            f = w.filename
            f = "ov2slam_tpu_torch/" + f.split("/ov2slam_tpu_torch/")[-1] \
                if "/ov2slam_tpu_torch/" in f else f.split("site-packages/")[-1]
            sites[f"{f}:{w.lineno}"] += 1
    return out


def gate_site() -> str:
    """The call site of the epipolar gate's host read (frontend.gate_open,
    which both the eager step and the graph replays call)."""
    lines, start = inspect.getsourcelines(fe_mod.gate_open)
    k = next(i for i, line in enumerate(lines) if "bool(gate)" in line)
    return f"ov2slam_tpu_torch/slam/frontend.py:{start + k}"


def log_syncs(tag: str, sites: collections.Counter, n_frames: int):
    total = sum(sites.values())
    top = ", ".join(f"{k} {v}" for k, v in sites.most_common(8))
    log(f"[{tag}] host syncs: {total} in {n_frames} frames "
        f"({total / n_frames:.2f} per frame); by site: {top}")


def angle(R) -> float:
    return float(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))


def direction_angle(a, b) -> float:
    cos = abs(float(a @ b)) / max(float(np.linalg.norm(a) * np.linalg.norm(b)), 1e-12)
    return float(np.arccos(min(cos, 1.0)))


@contextlib.contextmanager
def recording_essential_ransac(calls: list):
    """Record every essential_ransac call's caller ("epipolar_filter" for
    the front end's filter, "_try_mono_init" for the mono bootstrap) and result."""
    real = mvg.essential_ransac

    def rec(*a, **k):
        out = real(*a, **k)
        calls.append((sys._getframe(1).f_code.co_name, out))
        return out
    mvg.essential_ransac = rec
    try:
        yield
    finally:
        mvg.essential_ransac = real


def ransac_pair(dev):
    """The port's own correspondences on a rendered pair 4 steps apart: the
    stereo system's first keyframe on frame 0, then tracking to frame 4
    (no filter, no P3P start)."""
    fl, fr, _ = syn.render_sequence(n_frames=5, step=MONO_STEP)
    slam = SlamSystem(SlamParams.from_dict(syn.slam_params_dict()), device=dev)
    slam.process_stereo(fl[0], fr[0], 0.0)
    st = slam.fe_state
    cur = fe_mod.preprocess(slam._to_device_u8(fl[4]), 3)
    grads = [im.scharr_gradients(a) for a in cur]
    lm_pos, lm_is3d = slam.map.device_landmarks()
    track_args = (st.pyr, cur, st.kps, lm_pos, lm_is3d, slam.cam_l, st.R_cw,
                  st.t_cw, st.R_cw, st.t_cw)
    track_kw = dict(prev_gpyr=tuple(zip(st.gx, st.gy)), cur_gpyr=tuple(grads))
    res = fe_mod.track_frame(*track_args, **track_kw)
    kps = res.kps
    slot = torch.clamp(kps.lmid, 0, lm_pos.shape[0] - 1)
    kp3d = kps.valid & kps.is3d & lm_is3d[slot] & (kps.lmid >= 0)
    focal = 0.5 * (slam.cam_l.fx + slam.cam_l.fy)
    return dict(ess=(st.kps.bv, kps.bv, kps.valid), p3p=(lm_pos[slot], kps.bv, kp3d),
                th=3.0 / focal, track=(track_args, track_kw))


def phase_ransac(dev):
    """essential_ransac (nister, K=512) and p3p_ransac (K=256), card vs CPU
    with the same indices; then track_frame with the epipolar filter."""
    pair = ransac_pair(dev)
    gen = torch.Generator()
    gen.manual_seed(0)
    cpu = torch.device("cpu")
    rows = {}
    for name, K, s in (("essential_ransac", 512, 5), ("p3p_ransac", 256, 3)):
        args = pair["ess" if s == 5 else "p3p"]
        valid = args[2]
        idx = mvg.draw_samples(valid.cpu(), K, s, gen)
        on = {d: ([x.to(d) for x in args], idx.to(d)) for d in (cpu, dev)}

        def call(d, name=name):
            a, i = on[d]
            if name == "essential_ransac":
                r = mvg.essential_ransac(*a, pair["th"], idx=i)
                T = mvg.decompose_essential(r.model, a[0], a[1], r.inliers)
                return r.inliers, r.success, T.R, T.t
            T, inl, _, ok = mvg.p3p_ransac(*a, pair["th"], idx=i)
            return inl, ok, T.R, T.t

        out_g = [x.cpu().numpy() for x in call(dev)]
        out_c = [x.numpy() for x in call(cpu)]
        syncs = collections.Counter()
        count_syncs(lambda: call(dev), syncs)
        agree = float((out_g[0] == out_c[0]).mean())
        d_rot, d_dir = angle(out_g[2].T @ out_c[2]), direction_angle(out_g[3], out_c[3])
        ms = host_ms(lambda: call(dev), 3)
        ops = profile_run(lambda: call(dev))[2]
        rows[name] = (ms, ops)
        log(f"[ransac] {name} K={K} on {int(valid.sum())} of {valid.shape[0]} "
            f"points: inliers card {int(out_g[0].sum())} / CPU "
            f"{int(out_c[0].sum())}, agree {agree:.4f}; rotation {d_rot:.3g} "
            f"rad, translation direction {d_dir:.3g} rad apart; card "
            f"{ms:.1f} ms per synchronised call (host clock), {ops} device "
            f"operations per call, {sum(syncs.values())} host syncs per call")
        assert not syncs, f"{name} waited for the card: {dict(syncs)}"
        if not (bool(out_g[1]) and bool(out_c[1]) and agree >= INL_AGREE
                and d_rot < ROT_TOL and d_dir < DIR_TOL):
            raise AssertionError(
                f"{name}: success {bool(out_g[1])}/{bool(out_c[1])}, inlier "
                f"agreement {agree:.4f} (need {INL_AGREE}), rotation {d_rot:.3g} "
                f"(tol {ROT_TOL}), direction {d_dir:.3g} (tol {DIR_TOL})")

    # the front end's filter on the same pair: the gate fires, the filter
    # applies (RANSAC success, inliers > half the tracked points) and no
    # outlier stays valid
    calls = []
    track_args, track_kw = pair["track"]
    gen_d = torch.Generator(device=dev)
    gen_d.manual_seed(0)
    with recording_essential_ransac(calls):
        res = fe_mod.track_frame(
            *track_args, **track_kw, do_epipolar=True,
            draw=lambda v, k, s: mvg.draw_samples(v, k, s, gen_d))
    assert len(calls) == 1, "the epipolar gate did not fire on ~11 px of parallax"
    assert calls[0][0] == "epipolar_filter", calls[0][0]
    eres = calls[0][1]
    n_tr, n_in = int(res.n_tracked), int(eres.n_inliers)
    kept = int(res.kps.valid.sum())
    log(f"[ransac] track_frame with the epipolar filter: gate fired, RANSAC "
        f"success {bool(eres.success)}, {n_in} inliers of {n_tr} tracked, "
        f"{kept} keypoints kept after PnP")
    assert bool(eres.success) and n_in > 0.5 * n_tr, (n_in, n_tr)
    assert not bool((res.kps.valid & ~eres.inliers).any()), "outlier kept"
    return rows


def phase_clahe(dev, frame):
    """clahe on the card vs the CPU on a rendered frame."""
    img = torch.from_numpy(np.ascontiguousarray(frame, np.float32))
    out_c = im.clahe(img, clip_limit=3.0)
    img_d = img.to(dev)
    out_g = im.clahe(img_d, clip_limit=3.0)
    err = float((out_g.cpu() - out_c).abs().max())
    ms = host_ms(lambda: im.clahe(img_d, clip_limit=3.0), 20)
    dev_ms = cuda_ms(lambda: im.clahe(img_d, clip_limit=3.0), 20)
    ops = profile_run(lambda: im.clahe(img_d, clip_limit=3.0))[2]
    log(f"[clahe] {tuple(img.shape)}: max |card - CPU| {err:.3g} gray levels "
        f"(tol {CLAHE_TOL}); {ms:.3f} ms per synchronised call (host clock), "
        f"{dev_ms:.3f} ms per call back to back (CUDA events), {ops} device "
        f"operations per call")
    assert err <= CLAHE_TOL, err
    return ms, ops


def phase_slice(dev, seq):
    """The stereo slice on the card, from the system's public entry points,
    with the epipolar filter on, over the first N_FRAMES frames of `seq`
    (the synthetic sequence, left, right, camera-to-world poses)."""
    fl, fr, gt = (x[:N_FRAMES] for x in seq)
    slam = SlamSystem(SlamParams.from_dict(syn.slam_params_dict()), device=dev)
    assert slam.params.doepipolar
    calls, syncs = [], collections.Counter()
    klt.LAUNCHES = lk.LAUNCHES = 0
    with recording_essential_ransac(calls):
        est, launches, is_kf, dts = run_frames(
            slam, lambda i: slam.process_stereo(fl[i], fr[i], i * 0.05), syncs)
    total = {"klt_track": klt.LAUNCHES, "lk_iterate": lk.LAUNCHES}
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
    track_launches = [launches[i] for i in track_frames]
    steady = float(np.sum(dts[1:]))
    log(f"[slice] ATE {ate:.5f} m, keyframes {n_kf}, landmarks {n3d}, "
        f"steady-state {(N_FRAMES - 1) / steady:.2f} fps "
        f"({1000 * steady / (N_FRAMES - 1):.1f} ms/frame over frames 1-"
        f"{N_FRAMES - 1}; first frame {1000 * dts[0]:.0f} ms)")
    log(f"[slice] klt_track launches: {total['klt_track']} total, "
        f"{stereo_launches} in the first keyframe's stereo matching, "
        f"{sorted(set(track_launches))} per tracking-only frame over "
        f"{len(track_frames)} such frames; lk_iterate launches: "
        f"{total['lk_iterate']}")
    gate_reads = syncs[gate_site()]
    log(f"[slice] epipolar gate: {gate_reads} host reads, fired "
        f"{len(calls)} times")
    log_syncs("slice", syncs, N_FRAMES)

    assert np.isfinite(est).all(), "non-finite pose"
    assert slam.initialized, "system never initialized"
    assert n_kf >= 2 and n3d > 50, (n_kf, n3d)
    assert ate < 0.05, f"ATE {ate:.4f} m"
    assert tum.shape == (N_FRAMES, 8) and kitti.shape == (N_FRAMES, 12), (
        tum.shape, kitti.shape)
    assert stereo_launches >= 1, "stereo matching never launched klt_track"
    assert track_frames and all(k == 1 for k in track_launches), (
        f"tracking-only frames must launch klt_track once: {track_launches}")
    assert total["lk_iterate"] == 0, "the per-chunk LK path ran on the slice"
    assert gate_reads == N_FRAMES - 1, f"{gate_reads} gate reads"
    return total, (fl, fr)


def run_frames(slam, step, syncs: collections.Counter):
    """Drive `step(i)` over the frames, each synchronised: poses, klt_track
    launches, keyframe flags and seconds per frame; the host syncs inside
    the steps go into `syncs` by call site."""
    est, launches, is_kf, dts = [], [], [], []
    for i in range(N_FRAMES):
        before = klt.LAUNCHES
        n_kf = len(slam.map.keyframes)
        t1 = time.perf_counter()
        T_wc = count_syncs(lambda: step(i), syncs)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t1)
        est.append(T_wc)
        launches.append(klt.LAUNCHES - before)
        is_kf.append(len(slam.map.keyframes) > n_kf)
    return est, launches, is_kf, dts


def mono_params():
    d = syn.slam_params_dict()
    d.update({"mono": 1, "stereo": 0, "doepipolar": 1, "dop3p": 1,
              "use_clahe": 1, "force_realtime": 0, "buse_loop_closer": 0})
    return SlamParams.from_dict(d)


def phase_mono(dev):
    """The mono slice on the card through process_mono."""
    fl, _, gt = syn.render_sequence(n_frames=N_FRAMES, step=MONO_STEP)
    slam = SlamSystem(mono_params(), device=dev)
    calls, inits, syncs = [], [], collections.Counter()
    klt.LAUNCHES = lk.LAUNCHES = 0

    def step(i):
        T = slam.process_mono(fl[i], i * 0.05)
        if slam.initialized and not inits:
            inits.append(i)
        return T

    with recording_essential_ransac(calls):
        est, launches, _, dts = run_frames(slam, step, syncs)
    total = {"klt_track": klt.LAUNCHES, "lk_iterate": lk.LAUNCHES}
    with tempfile.TemporaryDirectory() as out:
        slam.write_results(out)
        tum = np.loadtxt(Path(out) / "ov2slam_traj.txt")
        kitti = np.loadtxt(Path(out) / "ov2slam_traj_kitti.txt")
    est = np.stack(est)
    gt_t = np.stack([T[:3, 3] for T in gt])
    ate = ate_rmse(est[:, :3, 3], gt_t, with_scale=True)
    steady = float(np.sum(dts[1:]))
    n_gate = sum(1 for caller, _ in calls if caller == "epipolar_filter")
    gate_reads = syncs[gate_site()]
    n_kf, n3d = len(slam.map.keyframes), slam.map.n_3d()
    log(f"[mono] init at frame {inits[0] if inits else None}, keyframes "
        f"{n_kf}, landmarks {n3d}, Sim(3) ATE {ate:.5f} m, steady-state "
        f"{(N_FRAMES - 1) / steady:.2f} fps ({1000 * steady / (N_FRAMES - 1):.1f} "
        f"ms/frame over frames 1-{N_FRAMES - 1}; first frame "
        f"{1000 * dts[0]:.0f} ms)")
    log(f"[mono] klt_track launches {total['klt_track']} "
        f"({sorted(set(launches[1:]))} per frame after the first), lk_iterate "
        f"{total['lk_iterate']}; epipolar gate: {gate_reads} host reads, "
        f"fired {n_gate} times; bootstrap RANSACs {len(calls) - n_gate}")
    log_syncs("mono", syncs, N_FRAMES)
    assert np.isfinite(est).all(), "non-finite pose"
    assert slam.initialized, "mono never initialized"
    assert n3d > 40, n3d
    assert ate < MONO_ATE, f"Sim(3) ATE {ate:.4f} m"
    assert tum.shape == (N_FRAMES, 8) and kitti.shape == (N_FRAMES, 12), (
        tum.shape, kitti.shape)
    assert all(k == 1 for k in launches[1:]), (
        f"every mono frame after the first must launch klt_track once: {launches}")
    assert total["lk_iterate"] == 0, "the per-chunk LK path ran on the mono slice"
    assert gate_reads == N_FRAMES - 1, f"{gate_reads} gate reads"
    return total, fl


@contextlib.contextmanager
def counting_stereo_kf_steps(calls: list):
    """Record every keyframe step that runs a stereo match (one klt_track
    launch each)."""
    real = mapper_mod.kf_step

    def rec(*a, **k):
        if k.get("stereo", True):
            calls.append(1)
        return real(*a, **k)
    mapper_mod.kf_step = rec
    try:
        yield
    finally:
        mapper_mod.kf_step = real


def phase_tiers(tag: str, dev, names, hard):
    """Each tier of `names` through SlamSystem on the card, as
    scripts/torch_preset_tiers.py runs it, with this smoke's checks, under
    PyTorch's deterministic algorithms, as the CLI runs (without them the
    local BA's scatter-adds sum in another order in every run, and a tier's
    ATE moves from run to run: on an NVIDIA H100 80GB HBM3 at 700 W,
    ``accurate_stereo_rect`` read 0.0106-0.0120 m in seven of eight runs
    and 0.0376 m in the eighth, which took one keyframe more).
    Returns the launches of both kernels over the phase."""
    total = {"klt_track": 0, "lk_iterate": 0}
    rows = {}
    for name in names:
        d = tiers.tier_dict(name)
        mono = bool(d.get("mono"))
        frames = hard if tiers.TIERS[name] else tiers.kf2f_frames()
        slam = SlamSystem(SlamParams.from_dict(d), device=dev)
        syncs, per_call, stereo_kf = collections.Counter(), [], []

        def call(i, fn):
            k0, s0 = klt.LAUNCHES, len(stereo_kf)
            count_syncs(fn, syncs)
            per_call.append(klt.LAUNCHES - k0 - (len(stereo_kf) - s0))

        klt.LAUNCHES = lk.LAUNCHES = 0
        gate = []
        with tiers.deterministic(set()), counting_stereo_kf_steps(stereo_kf), \
                recording_essential_ransac(gate):
            row = tiers.run_tier(slam, frames, mono, call=call,
                                 sync=torch.cuda.synchronize)
        total["klt_track"] += klt.LAUNCHES
        total["lk_iterate"] += lk.LAUNCHES
        n = row["frames"]
        poses = np.stack(slam.logger.poses_wc)
        ref = REF_ATE[name]
        pc = slam.pipeline_counts
        rows[name] = row
        log(f"[{tag}] {name}: ATE {row['ate']:.5f} m (JAX CPU {ref:.5f}, "
            f"bound {ATE_SLACK * ref + ATE_ABS:.5f}), {row['fps']:.2f} fps "
            f"over frames 1-{n - 1} with the flush, keyframes "
            f"{row['keyframes']}, landmarks {row['landmarks']}, in-flight "
            f"depth {row['max_inflight']} (pipeline_depth "
            f"{slam.params.pipeline_depth if slam.params.force_realtime else 0}),"
            f" staged commits {pc['kf_commit_lag']} KF / {pc['lmm_commit_lag']}"
            f" merge, deferred BA writebacks {pc['ba_writeback']}; klt_track "
            f"{klt.LAUNCHES} ({len(stereo_kf)} in keyframe stereo matches, "
            f"per tracking call {sorted(set(per_call[1:]))}), lk_iterate "
            f"{lk.LAUNCHES}; epipolar gate fired {sum(c == 'epipolar_filter' for c, _ in gate)}"
            f" times")
        log_syncs(f"{tag} {name}", syncs, n)
        if slam.rect_maps is not None:
            remap_cost(slam, frames[0][0])
        assert poses.shape == (n, 4, 4) and np.isfinite(poses).all(), (
            f"{name}: {len(poses)} poses logged for {n} frames")
        assert slam.initialized, f"{name} never initialized"
        assert row["ate"] <= ATE_SLACK * ref + ATE_ABS, (
            f"{name}: ATE {row['ate']:.4f} m vs JAX {ref:.4f} m")
        assert per_call[0] == 0 and all(k == 1 for k in per_call[1:]), (
            f"{name}: tracking calls must launch klt_track once: {per_call}")
        assert lk.LAUNCHES == 0, f"{name}: the per-chunk LK path ran"
        if slam.params.force_realtime:
            assert row["max_inflight"] == slam.params.pipeline_depth, row
            if not mono:
                assert pc["kf_commit_lag"] >= 1 and pc["ba_writeback"] >= 1, (
                    f"{name}: no staged commit or deferred BA landed: {pc}")
    return total, rows


@contextlib.contextmanager
def timing_loop_closer(rec: collections.defaultdict, profile: bool = False):
    """Record in `rec` the host ms (the card synchronised before and after)
    and result of every LoopCloser.process_kf call ("process_kf") and every
    span BA ("span_ba"), and for every closure the event and how far the
    call moved the query keyframe ("moved", m); with `profile`, run each
    verification (``_verify_and_close``) under torch.profiler instead and
    record its wall ms, device operations and result ("verify")."""
    from ov2slam_tpu_torch.slam.estimator import Estimator
    from ov2slam_tpu_torch.slam.loopcloser import LoopCloser
    real = {(LoopCloser, "process_kf"): "process_kf",
            (Estimator, "span_ba"): "span_ba"}

    def timed(fn, key):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            rec[key].append((1000 * (time.perf_counter() - t0), out))
            return out
        return wrapper

    def moving(fn):
        def wrapper(self, m, kfid):
            before = kf_position(m, kfid)
            ev = fn(self, m, kfid)
            if ev is not None:
                rec["moved"].append((ev, float(np.linalg.norm(
                    kf_position(m, ev.query_kf) - before))))
            return ev
        return wrapper

    def profiled(fn):
        def wrapper(*a, **k):
            box = []
            wall, _, ops, _ = profile_run(lambda: box.append(fn(*a, **k)))
            rec["verify"].append((wall, ops, box[0]))
            return box[0]
        return wrapper

    saved = {(c, n): getattr(c, n) for c, n in real}
    saved[(LoopCloser, "_verify_and_close")] = LoopCloser._verify_and_close
    for (c, n), key in real.items():
        setattr(c, n, timed(saved[(c, n)], key))
    LoopCloser.process_kf = timed(moving(saved[(LoopCloser, "process_kf")]),
                                  "process_kf")
    if profile:
        LoopCloser._verify_and_close = profiled(saved[(LoopCloser, "_verify_and_close")])
    try:
        yield
    finally:
        for (c, n), fn in saved.items():
            setattr(c, n, fn)


def kf_position(m, kfid: int):
    """A keyframe's position in the world (None when it is not in the map)."""
    rec = m.keyframes.get(kfid)
    return None if rec is None else np.linalg.inv(rec.T_cw.astype(np.float64))[:3, 3]


def _ms_summary(ms) -> str:
    if not ms:
        return "none"
    a = np.asarray(ms)
    return (f"{len(a)} calls, median {np.median(a):.1f} ms, mean "
            f"{a.mean():.1f} ms, max {a.max():.1f} ms")


def drive_loop(run, total: dict, profile: bool = False):
    """run(call) under the launch counters of phase_tiers and the
    loop-closer timings (timing_loop_closer): (its row, the timings). The
    kernels' launches are added to `total`; every closure must have moved
    its query keyframe (MOVE_SHARE)."""
    per_call, stereo_kf = [], []
    rec = collections.defaultdict(list)

    def call(i, fn):
        k0, s0 = klt.LAUNCHES, len(stereo_kf)
        fn()
        per_call.append(klt.LAUNCHES - k0 - (len(stereo_kf) - s0))

    klt.LAUNCHES = lk.LAUNCHES = 0
    with counting_stereo_kf_steps(stereo_kf), timing_loop_closer(rec, profile):
        row = run(call)
    total["klt_track"] += klt.LAUNCHES
    total["lk_iterate"] += lk.LAUNCHES
    log(f"[loop] launches: klt_track {klt.LAUNCHES} ({len(stereo_kf)} in "
        f"keyframe stereo matches, per tracking call "
        f"{sorted(set(per_call[1:]))}), lk_iterate {lk.LAUNCHES}")
    assert per_call[0] == 0 and all(k == 1 for k in per_call[1:]), (
        f"tracking calls must launch klt_track once: {per_call}")
    assert lk.LAUNCHES == 0, "the per-chunk LK path ran"
    for ev, moved in rec["moved"]:
        log(f"[loop] closure ({ev.query_kf}, {ev.match_kf}): PnP pose jump "
            f"{ev.pose_jump:.5f}, query keyframe moved {moved:.5f} (at least "
            f"{MOVE_SHARE} x the jump)")
        assert moved >= MOVE_SHARE * ev.pose_jump, (ev, moved)
    return row, rec


def phase_lc_tier(dev, total: dict, frames):
    """11a. accurate_stereo, the shipped loop-closing preset, over the
    whole hard sequence (`frames`)."""
    name = "accurate_stereo"
    slam = tiers.make_system("torch", tiers.tier_dict(name), dev, tiers.LC_DETECTOR)
    assert slam.loopcloser is not None and slam.params.force_realtime
    ops = set()
    with tiers.deterministic(ops):
        row, rec = drive_loop(lambda call: tiers.run_tier(
            slam, frames, False, call=call, sync=torch.cuda.synchronize), total)
    n = row["frames"]
    poses = np.stack(slam.logger.poses_wc)
    ref, ref_opt = REF_ATE[name], REF_ATE[name + "_wlc_opt"]
    closures = [ms for ms, ev in rec["process_kf"] if ev is not None]
    per_kf = [ms for ms, ev in rec["process_kf"] if ev is None]
    log(f"[loop] {name}: {n} frames, ATE {row['ate']:.5f} m (JAX CPU "
        f"{ref:.5f}, bound {ATE_SLACK * ref + ATE_ABS:.5f}), wlc_opt ATE "
        f"{row['ate_wlc_opt']:.5f} m (JAX CPU {ref_opt:.5f}, bound "
        f"{ATE_SLACK * ref_opt + ATE_ABS:.5f}), {row['fps']:.2f} fps over "
        f"frames 1-{n - 1} with the flush, keyframes {row['keyframes']}, "
        f"landmarks {row['landmarks']}, loops [query, match, inliers, merged,"
        f" jump m] {row['loops']}, final passes {1000 * row['final_seconds']:.0f} ms;"
        f" deterministic algorithms on, operations without a deterministic "
        f"version: {sorted(ops) or 'none'}")
    log(f"[loop] {name}: loop-closing stage per keyframe without a closure: "
        f"{_ms_summary(per_kf)}; with a closure: {_ms_summary(closures)}; "
        f"span BA: {_ms_summary([ms for ms, _ in rec['span_ba']])}; budget "
        f"timeouts {slam.estimator.n_ba_timeouts}")
    assert poses.shape == (n, 4, 4) and np.isfinite(poses).all(), (
        f"{name}: {len(poses)} poses logged for {n} frames")
    assert any(e[2] >= MIN_INLIERS for e in row["loops"]), (
        f"{name}: no loop closure with >= {MIN_INLIERS} inliers: {row['loops']}")
    assert row["ate"] <= ATE_SLACK * ref + ATE_ABS, row["ate"]
    assert row["ate_wlc_opt"] <= ATE_SLACK * ref_opt + ATE_ABS, row["ate_wlc_opt"]


def loop_run(dev, name: str, frames, total: dict):
    """11b. One out-and-back run, as scripts/torch_preset_tiers.py runs it
    (deterministic algorithms on), with tests/test_loopclosing.py's gates."""
    slam = tiers.make_system("torch", tiers.oab_dict(name), dev)
    ops = set()
    with tiers.deterministic(ops):
        row, rec = drive_loop(lambda call: tiers.run_oab(
            slam, name, frames, call=call, sync=torch.cuda.synchronize),
            total, profile=name == "oab_stereo")
    ev = slam.last_loop_event
    log(f"[loop] {name} (beside the other out-and-back runs): {json.dumps(row)};"
        f" operations without a deterministic version: {sorted(ops) or 'none'}")
    if name == "oab_kidnap":
        assert row["reloc_err"] < RELOC_ERR and row["chain_gen"] >= 1, row
        return
    assert ev is not None and ev.n_inliers >= MIN_INLIERS, f"{name}: no loop"
    assert len(slam.logger.poses_wc) == row["frames"], row
    if name == "oab_stereo":
        wall, ops, _ = next(v for v in rec["verify"] if v[2] is not None)
        log(f"[loop] {name}: the closing verification under the profiler: "
            f"{wall:.0f} ms wall, {ops} device operations; loop-closing stage "
            f"per keyframe {_ms_summary([ms for ms, ev in rec['process_kf'] if ev is None])}")
        assert ev.n_pairs_local >= ev.n_pairs_init > 0, ev
        for f in ("ov2slam_full_traj_wlc.txt", "ov2slam_full_traj_wlc_opt.txt"):
            assert row["files"][f] == [row["frames"], 8, True], (f, row["files"])
        assert row["files"]["ov2slam_fullba_kfs_traj.txt"][2], row["files"]
        assert row["ate"] < OAB_ATE, row
    elif name == "oab_stereo_rt":
        assert row["max_step"] < OAB_MAX_STEP, row
        assert row["max_inflight"] == slam.params.pipeline_depth, row
    else:
        assert row["ate_wlc_opt"] < OAB_ATE, row
        assert row["ate_wlc_opt"] <= 1.2 * row["ate"] + 1e-3, row


@contextlib.contextmanager
def counting_tracking_calls(per_call: list, stereo_kf: list):
    """For every SlamSystem.process_stereo call, append to `per_call` the
    klt_track launches it made besides its keyframe stereo matches (those
    recorded in `stereo_kf` by counting_stereo_kf_steps)."""
    real = SlamSystem.process_stereo

    def rec(self, *a, **k):
        k0, s0 = klt.LAUNCHES, len(stereo_kf)
        out = real(self, *a, **k)
        per_call.append(klt.LAUNCHES - k0 - (len(stereo_kf) - s0))
        return out
    SlamSystem.process_stereo = rec
    try:
        yield
    finally:
        SlamSystem.process_stereo = real


def phase_cli(total: dict, frames, root: Path):
    """12. cli: the port's command-line entry point, in this process (so
    the launch counters are read), over the first CLI_FRAMES frames of the
    hard sequence written as an EuRoC ASL tree under `root`, the shipped
    accurate_stereo_nolc preset as YAML: (a) as shipped (force_realtime,
    frames dropped by the wall clock), (b) with force_realtime 0, twice;
    log_timings on in all three. Returns the tree's stamps."""
    from ov2slam_tpu_torch import run
    from ov2slam_tpu_torch.io import datasets
    from ov2slam_tpu_torch.io.profiler import Profiler
    L, R, gt = (x[:CLI_FRAMES] for x in frames)
    t0 = time.perf_counter()
    stamps = cli.write_dataset(str(root / "seq"), L, R)
    t_write = time.perf_counter() - t0
    pngs = sorted((root / "seq" / "mav0" / "cam0" / "data").glob("*.png"))
    t0 = time.perf_counter()
    datasets.read_png_gray(str(pngs[0]))    # builds the C++ unfilter
    log(f"[cli] png_unfilter.cpp built (g++) and first image read in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    decoded = [datasets.read_png_gray(str(f)) for f in pngs]
    decode_ms = 1000 * (time.perf_counter() - t0) / len(pngs)
    assert all(np.array_equal(d, l.astype(np.float32))
               for d, l in zip(decoded, L)), "a PNG decoded wrong"
    log(f"[cli] {CLI_FRAMES} stereo pairs written as an EuRoC tree in "
        f"{t_write:.1f} s; decode {decode_ms:.3f} ms per 752x480 grey "
        f"image (host, every row filter type), pixels equal")
    trajs = {}
    for name, realtime, timings in (("a", 1, 1), ("b1", 0, 1), ("b2", 0, 1)):
        params = str(root / f"{name}.yaml")
        cli.write_params(params, realtime, timings)
        out = root / f"out_{name}"
        Profiler.instance().reset()
        per_call, stereo_kf = [], []
        klt.LAUNCHES = lk.LAUNCHES = 0
        with counting_stereo_kf_steps(stereo_kf), \
                counting_tracking_calls(per_call, stereo_kf):
            res = run.main([params, str(root / "seq"), "--out", str(out)])
        total["klt_track"] += klt.LAUNCHES
        total["lk_iterate"] += lk.LAUNCHES
        rows, ate = cli.trajectory_ate(str(out / "ov2slam_traj.txt"), stamps, gt)
        traj = np.loadtxt(out / "ov2slam_traj.txt", ndmin=2)
        labels = sorted(Profiler.instance().timers)
        log(f"[cli] run ({name}), force_realtime {realtime}: processed "
            f"{res['frames']}, dropped {res['dropped']}, {res['keyframes']} "
            f"keyframes, {res['frames'] / res['seconds']:.2f} fps, {rows} rows, ATE "
            f"{ate:.5f} m ("
            + ("not gated: the frames processed depend on the clock" if realtime
               else f"JAX CLI on the CPU {REF_CLI_ATE:.5f}, bound "
               f"{ATE_SLACK * REF_CLI_ATE + ATE_ABS:.5f}")
            + "); "
            f"klt_track {klt.LAUNCHES} ({len(stereo_kf)} in keyframe "
            f"stereo matches, per tracking call {sorted(set(per_call[1:]))}),"
            f" lk_iterate {lk.LAUNCHES}; profiler labels {labels}")
        assert res["frames"] + res["dropped"] == CLI_FRAMES, res
        assert traj.shape == (res["frames"], 8) and np.isfinite(traj).all(), (
            f"({name}): {traj.shape} rows for {res['frames']} frames")
        assert len(per_call) == res["frames"], (len(per_call), res)
        assert per_call[0] == 0 and all(k == 1 for k in per_call[1:]), (
            f"({name}): tracking calls must launch klt_track once: {per_call}")
        assert klt.LAUNCHES == res["frames"] - 1 + len(stereo_kf)
        assert lk.LAUNCHES == 0, f"({name}): the per-chunk LK path ran"
        missing = (set(CLI_LABELS) | set(CLI_BA_LABELS[realtime] if
                                         res["keyframes"] > 1 else ())
                   ) - set(labels)
        assert not missing, f"({name}): no {sorted(missing)} in the table"
        if name == "a":
            idx = np.rint((traj[:, 0] - stamps[0] * 1e-9) / 0.05).astype(int)
            log(f"[cli] run (a) processed frames {idx.tolist()}")
        else:
            assert res["dropped"] == 0
            assert ate <= ATE_SLACK * REF_CLI_ATE + ATE_ABS, ate
            trajs[name] = {f.name: f.read_bytes()
                           for f in sorted(out.glob("*.txt"))}
    assert trajs["b1"] == trajs["b2"], (
        "(b): two runs over the same frames wrote different files: "
        + str([f for f in trajs["b1"] if trajs["b1"][f] != trajs["b2"].get(f)]))
    log(f"[cli] (b) twice: {len(trajs['b1'])} trajectory files, "
        "byte-identical")
    return stamps


@contextlib.contextmanager
def counting_graph_runs(runs: list):
    """Record every StepGraphs that ran a chunk (its graphs, their klt_track
    nodes and replays are read after the run)."""
    real = graphs_mod.StepGraphs.run

    def rec(self, *a, **k):
        if self not in runs:
            runs.append(self)
        return real(self, *a, **k)
    graphs_mod.StepGraphs.run = rec
    try:
        yield
    finally:
        graphs_mod.StepGraphs.run = real


def graph_counts(runs: list):
    """(captures, klt_track launches the replays made) of the recorded
    StepGraphs caches."""
    gs = [g for c in runs for g in c.graphs.values()]
    return len(gs), sum(g.graph_launches() for g in gs)


def chunked(slam, frames, start: int = 0, end: int = None):
    """Feed frames[start:end] (left, right, time) to process_stereo_chunk in
    chunks of CHUNK (counted from frame 0)."""
    end = len(frames) if end is None else end
    for i in range(start, end, CHUNK):
        slam.process_stereo_chunk(frames[i:min(i + CHUNK, end)])


def graph_vs_eager(dev):
    """13a. One replay of the captured frame step against the eager
    frame_step from the same state and generator state: on the next frame
    (the parallax gate shut) and four frames on (open, so the filter's
    graph replays too)."""
    fl, fr, _ = syn.render_sequence(n_frames=8, step=MONO_STEP)
    slam = SlamSystem(SlamParams.from_dict(syn.slam_params_dict()), device=dev)
    for i in range(3):
        slam.process_stereo(fl[i], fr[i], i * 0.05)
    st, kw = slam.fe_state, slam._step_kwargs()
    lm = slam.map.device_landmarks()
    cache = graphs_mod.StepGraphs()
    for j, gate in ((3, "shut"), (7, "open")):
        img = slam._to_device_u8(fl[j])
        g0 = st.gen.get_state()
        new_e, s_e = fe_mod.frame_step(st, img, *lm, slam.cam_l, **kw)
        g_eager = st.gen.get_state()
        st.gen.set_state(g0)
        before = dict(cache.last.replays) if cache.last else {}
        new_g, s_g = cache.run(st, img[None], *lm, slam.cam_l, kw)
        torch.cuda.synchronize()
        filtered = cache.last.replays.get("filter", 0) - before.get("filter", 0)
        d_stats = float((s_g[0] - s_e).abs().max())
        d_pose = float(torch.cat([(new_g.R_cw - new_e.R_cw).abs().flatten(),
                                  (new_g.t_cw - new_e.t_cw).abs()]).max())
        same_valid = bool(torch.equal(new_g.kps.valid, new_e.kps.valid))
        log(f"[chunk] graph replay vs eager frame_step, gate {gate}: filter "
            f"graph replayed {filtered} times, keypoint masks equal "
            f"{same_valid}, stats {d_stats:.3g}, pose {d_pose:.3g} apart "
            f"(tolerance {GRAPH_TOL}), generator advanced alike "
            f"{bool(torch.equal(st.gen.get_state(), g_eager))}")
        assert filtered == (gate == "open"), (gate, filtered)
        assert same_valid and d_stats <= GRAPH_TOL and d_pose <= GRAPH_TOL
        assert torch.equal(st.gen.get_state(), g_eager)
    log(f"[chunk] graphs captured in {cache.last.capture_s:.2f} s (warm-up "
        f"and three captures: front, filter, back)")


def phase_chunk(dev, total: dict, seq, cli_root: Path, cli_stamps, cli_gt):
    """13. chunk: the throughput path (process_stereo_chunk, CUDA-graph
    replays of the frame step) on the bench surface at full width (`seq`:
    the synthetic sequence of CHUNK_FRAMES frames), then the CLI with
    --chunk over the cli phase's tree. Returns the klt_track launches of
    the graph replays."""
    from ov2slam_tpu_torch import run
    graph_vs_eager(dev)
    fl, fr, gt = seq
    gt_t = np.stack([T[:3, 3] for T in gt])
    frames = [(fl[i], fr[i], i * 0.05) for i in range(CHUNK_FRAMES)]
    params = SlamParams.from_dict(syn.slam_params_dict())
    assert params.doepipolar and not params.force_realtime

    # (a) the gated run: ATE, launches, host syncs inside each chunk call
    slam = SlamSystem(params, device=dev)
    per_chunk, stereo_kf, runs = [], [], []
    real_chunk_step = fe_mod.frame_chunk_step

    def counted(*a, **k):
        sites = collections.Counter()
        out = count_syncs(lambda: real_chunk_step(*a, **k), sites)
        per_chunk.append(sites)
        return out

    klt.LAUNCHES = lk.LAUNCHES = 0
    fe_mod.frame_chunk_step = counted
    try:
        with counting_stereo_kf_steps(stereo_kf), counting_graph_runs(runs):
            chunked(slam, frames)
            slam.flush()
            torch.cuda.synchronize()
    finally:
        fe_mod.frame_chunk_step = real_chunk_step
    captures, replay_launches = graph_counts(runs)
    total["klt_track"] += klt.LAUNCHES
    total["lk_iterate"] += lk.LAUNCHES
    est = np.stack([np.asarray(T)[:3, 3] for T in slam.logger.poses_wc])
    ate = ate_rmse(est, gt_t)
    n_chunked = CHUNK_FRAMES - CHUNK
    g = runs[0].last
    kf_frames = [j for j, k in enumerate(slam.logger.is_kf) if k]
    steady = collections.Counter()
    for c in per_chunk[1:]:
        steady.update(c)
    bound = ATE_SLACK * REF_CHUNK_ATE + ATE_ABS
    log(f"[chunk] bench surface, {CHUNK_FRAMES} frames in chunks of {CHUNK}: "
        f"ATE {ate:.5f} m (JAX process_stereo_chunk on the CPU "
        f"{REF_CHUNK_ATE:.5f}, bound {bound:.5f}), keyframes "
        f"{len(slam.map.keyframes)} at frames {kf_frames}, landmarks "
        f"{slam.map.n_3d()}; {len(per_chunk)} chunk calls, graphs captured "
        f"{captures} time(s) (warm-up and captures {g.capture_s:.2f} s); "
        f"klt_track by its wrapper "
        f"{klt.LAUNCHES} ({CHUNK - 1} frame-by-frame tracking calls, "
        f"{len(stereo_kf)} keyframe stereo matches, the warm-up and capture "
        f"of each graph), by graph replays {replay_launches} (nodes "
        f"{g.nodes}, replays {g.replays}); lk_iterate {lk.LAUNCHES}")
    log_syncs("chunk, calls after the capture", steady, n_chunked - CHUNK)
    log(f"[chunk] host syncs of the capturing call: {dict(per_chunk[0])}")
    assert len(slam.logger.poses_wc) == CHUNK_FRAMES and np.isfinite(est).all()
    assert ate <= bound, f"chunked ATE {ate:.4f} m, bound {bound:.4f}"
    assert all(j < CHUNK or j % CHUNK == CHUNK - 1 for j in kf_frames), kf_frames
    assert captures == 1, f"{captures} captures for one key"
    assert replay_launches == n_chunked, (replay_launches, n_chunked)
    assert klt.LAUNCHES == CHUNK - 1 + len(stereo_kf) + 2 * sum(g.nodes.values())
    assert lk.LAUNCHES == 0, "the per-chunk LK path ran"
    assert set(steady) <= {gate_site()}, f"host syncs in a chunk: {dict(steady)}"
    assert steady[gate_site()] == n_chunked - CHUNK, steady

    # ms per frame, chunked and frame by frame, in turns; then frames
    # TIMED_TO.. TIMED_TO + 15 of the last two under the profiler
    last = {}
    for mode in ("chunk", "frame", "frame", "chunk"):
        slam = SlamSystem(params, device=dev)
        if mode == "chunk":
            chunked(slam, frames, 0, TIMED_FROM)
        else:
            for f in frames[:TIMED_FROM]:
                slam.process_stereo(*f)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "chunk":
            chunked(slam, frames, TIMED_FROM, TIMED_TO)
        else:
            for f in frames[TIMED_FROM:TIMED_TO]:
                slam.process_stereo(*f)
        torch.cuda.synchronize()
        ms = 1000 * (time.perf_counter() - t0) / (TIMED_TO - TIMED_FROM)
        log(f"[chunk] {mode}: {ms:.1f} ms/frame over frames {TIMED_FROM}-"
            f"{TIMED_TO - 1} ({1000 / ms:.2f} fps), keyframes "
            f"{len(slam.map.keyframes)}")
        last[mode] = slam
    for mode, slam in last.items():
        seg = frames[TIMED_TO:TIMED_TO + 2 * CHUNK]
        run_p = profile_run(lambda: chunked(slam, seg) if mode == "chunk"
                            else [slam.process_stereo(*f) for f in seg])
        wall, busy, ops, _ = run_p
        log(f"[chunk] {mode} under the profiler, frames {TIMED_TO}-"
            f"{TIMED_TO + 2 * CHUNK - 1}: wall {wall / len(seg):.1f} ms/frame, "
            f"device busy {busy / len(seg):.1f} ms/frame (idle share "
            f"{1 - busy / wall:.3f}), {ops / len(seg):.0f} device operations "
            f"per frame")

    # (b) the CLI with --chunk over the cli phase's tree, force_realtime 0
    params_path = str(cli_root / "chunk.yaml")
    cli.write_params(params_path, 0)
    out = cli_root / "out_chunk"
    stereo_kf, runs = [], []
    klt.LAUNCHES = lk.LAUNCHES = 0
    with counting_stereo_kf_steps(stereo_kf), counting_graph_runs(runs):
        res = run.main([params_path, str(cli_root / "seq"), "--out", str(out),
                        "--chunk", str(CHUNK)])
    captures, cli_replays = graph_counts(runs)
    total["klt_track"] += klt.LAUNCHES
    total["lk_iterate"] += lk.LAUNCHES
    rows, ate = cli.trajectory_ate(str(out / "ov2slam_traj.txt"), cli_stamps,
                                   cli_gt)
    bound = ATE_SLACK * REF_CLI_CHUNK_ATE + ATE_ABS
    log(f"[chunk] CLI --chunk {CHUNK}, force_realtime 0: processed "
        f"{res['frames']}, {res['keyframes']} keyframes, "
        f"{res['frames'] / res['seconds']:.2f} fps, {rows} rows, ATE {ate:.5f} m "
        f"(JAX CLI --chunk {CHUNK} on the CPU {REF_CLI_CHUNK_ATE:.5f}, bound "
        f"{bound:.5f}); klt_track by its wrapper {klt.LAUNCHES} ({len(stereo_kf)} "
        f"keyframe stereo matches), by graph replays {cli_replays}, graphs "
        f"captured {captures} time(s); lk_iterate {lk.LAUNCHES}")
    assert res["frames"] == rows == CLI_FRAMES and res["dropped"] == 0, res
    assert ate <= bound, f"CLI --chunk ATE {ate:.4f} m, bound {bound:.4f}"
    assert captures == 1 and cli_replays == CLI_FRAMES - CHUNK, (captures, cli_replays)
    assert lk.LAUNCHES == 0
    return replay_launches + cli_replays


def phase_repeat(dev, total: dict, hard):
    """13c. P4: accurate_stereo_rect twice in this process with PyTorch's
    deterministic algorithms off: the two trajectories equal element for
    element (the BA's and the pose graph's sums are ordered); then once
    under torch.use_deterministic_algorithms(True) without warn_only, which
    raises on any operation that has no deterministic version."""
    name = "accurate_stereo_rect"
    assert not torch.are_deterministic_algorithms_enabled()
    trajs = []
    klt.LAUNCHES = lk.LAUNCHES = 0
    for k in range(3):
        slam = SlamSystem(SlamParams.from_dict(tiers.tier_dict(name)), device=dev)
        if k < 2:
            row = tiers.run_tier(slam, hard, False, sync=torch.cuda.synchronize)
        else:
            torch.use_deterministic_algorithms(True)
            try:
                row = tiers.run_tier(slam, hard, False,
                                     sync=torch.cuda.synchronize)
            finally:
                torch.use_deterministic_algorithms(False)
        trajs.append(np.stack(slam.logger.poses_wc))
        log(f"[repeat] {name} run {k + 1}"
            + (" under torch.use_deterministic_algorithms(True)" if k == 2
               else ", deterministic algorithms off")
            + f": ATE {row['ate']:.8f} m, keyframes {row['keyframes']}, "
            f"landmarks {row['landmarks']}")
    total["klt_track"] += klt.LAUNCHES
    total["lk_iterate"] += lk.LAUNCHES
    same = trajs[0].shape == trajs[1].shape and np.array_equal(trajs[0], trajs[1])
    log(f"[repeat] {name}: runs 1 and 2 equal element for element: {same}; "
        f"run 3 raised on no operation")
    assert same, "two runs in one process parted"


def start_loop_runs():
    """Start the four out-and-back runs, one process each (this script with
    --loop-run NAME), all at once: they share the card and the host, so
    their host times are not clean timings."""
    return [(name, subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--loop-run", name],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name in LOOP_RUNS]


def finish_loop_runs(procs, total: dict, timeout_s: float = 900):
    """Wait for the runs, relay their output, add their launches to
    `total`; raise if one failed. Every process is ended on the way out."""
    try:
        for name, proc in procs:
            out, _ = proc.communicate(timeout=timeout_s)
            lines = out.strip().splitlines()
            for line in lines[:-1]:
                log(line)
            if proc.returncode != 0 or not lines:
                raise AssertionError(f"loop run {name} failed (exit "
                                     f"{proc.returncode}): {lines[-1:]}")
            counts = json.loads(lines[-1])["launches"]
            for k in total:
                total[k] += counts[k]
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def loop_child(name: str) -> int:
    """--loop-run NAME: one out-and-back run on the card; the last line is
    its kernels' launches."""
    device_mod.set_precision_policy()
    _build.build(["lk_iterate", "klt_track"])
    total = {"klt_track": 0, "lk_iterate": 0}
    loop_run(torch.device("cuda", 0), name, tiers.oab_frames(), total)
    print(json.dumps({"loop_run": name, "launches": total}), flush=True)
    return 0


def remap_cost(slam, img):
    """The per-frame rectification of one image: host ms per synchronised
    `_rectify` call (pinned upload + bicubic remap), device ms of the remap
    alone back to back (CUDA events), its device operations, and the least
    time of its bytes (image and grid read once, output written once)."""
    grid = slam.rect_maps[0]
    src = slam._upload(np.asarray(img, np.float32))
    ms = host_ms(lambda: slam._rectify(img, 0), 20)
    dev_ms = cuda_ms(lambda: im.remap_bicubic(src, grid), 20)
    ops = profile_run(lambda: im.remap_bicubic(src, grid))[2]
    nbytes = 4 * src.numel() + 8 * grid.shape[0] * grid.shape[1] + 4 * grid[..., 0].numel()
    log(f"[rect] remap of one {tuple(src.shape)} image: {ms:.3f} ms per "
        f"synchronised _rectify call (host clock), {dev_ms:.4f} ms per remap "
        f"back to back (CUDA events), {ops} device operations per remap; "
        f"bound {1e3 * nbytes / HBM_BPS:.5f} ms by bytes ({nbytes} B); two "
        f"per stereo frame")


@contextlib.contextmanager
def klt_path(name: str):
    """Run the system's KLT calls through the fused kernel ("fused") or the
    per-chunk path ("per-chunk") for a before/after comparison."""
    fused = klt.fb_klt_tracking
    if name == "per-chunk":
        klt.fb_klt_tracking = per_chunk_klt()
    try:
        yield
    finally:
        klt.fb_klt_tracking = fused


def _slice_system(dev, frames, doepipolar: int = 1):
    fl, fr = frames
    d = syn.slam_params_dict()
    d["doepipolar"] = doepipolar
    slam = SlamSystem(SlamParams.from_dict(d), device=dev)
    slam.process_stereo(fl[0], fr[0], 0.0)
    torch.cuda.synchronize()
    return slam


def phase_compare(dev, frames):
    """Frames 1-59 of the slice in turns: through each KLT path (fused,
    per-chunk, fused, per-chunk), then with the epipolar filter on and off
    (on, off, on, off; fused KLT): steady-state fps and launches per frame
    of the two kernels."""
    fl, fr = frames
    turns = ([(k, 1) for k in ("fused", "per-chunk", "fused", "per-chunk")]
             + [("fused", e) for e in (1, 0, 1, 0)])
    for name, epi in turns:
        with klt_path(name):
            slam = _slice_system(dev, frames, doepipolar=epi)
            k0, l0 = klt.LAUNCHES, lk.LAUNCHES
            t0 = time.perf_counter()
            for i in range(1, N_FRAMES):
                slam.process_stereo(fl[i], fr[i], i * 0.05)
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        n = N_FRAMES - 1
        log(f"[compare] {name}, epipolar filter {'on' if epi else 'off'}: "
            f"{n / dt:.2f} fps ({1000 * dt / n:.1f} ms/frame over frames "
            f"1-{n}); per frame {(klt.LAUNCHES - k0) / n:.2f} klt_track and "
            f"{(lk.LAUNCHES - l0) / n:.2f} lk_iterate launches; "
            f"{len(slam.map.keyframes)} keyframes")


def phase_profile(dev, frames, mono_frames, out: Path, hard, n_prof: int = 20):
    """Frames 1..n_prof of the stereo slice once more under torch.profiler,
    through each KLT path, frames 20-29 of the mono slice, and frames 20-39
    of two pipelined preset tiers: device busy share, device operations per
    frame, and the host scopes and operations that take the time."""
    fl, fr = frames
    out.mkdir(parents=True, exist_ok=True)
    for name in ("fused", "per-chunk"):
        with klt_path(name):
            slam = _slice_system(dev, frames)
            run = profile_run(lambda: [slam.process_stereo(fl[i], fr[i], i * 0.05)
                                       for i in range(1, n_prof + 1)])
        log_profile(f"profile {name}", f"frames 1-{n_prof}, KLT path {name}",
                    n_prof, run, out / f"torch_profile_slice_{name}.txt")
    slam = SlamSystem(mono_params(), device=dev)
    for i in range(20):
        slam.process_mono(mono_frames[i], i * 0.05)
    run = profile_run(lambda: [slam.process_mono(mono_frames[i], i * 0.05)
                               for i in range(20, 30)])
    log_profile("profile mono", "mono frames 20-29", 10, run,
                out / "torch_profile_mono.txt")
    L, R, _ = hard
    for name in ("accurate_stereo_nolc", "fast_mono"):
        slam = SlamSystem(SlamParams.from_dict(tiers.tier_dict(name)), device=dev)
        mono = slam.params.mono

        def step(i):
            if mono:
                slam.process_mono(L[i], i * tiers.FRAME_DT)
            else:
                slam.process_stereo(L[i], R[i], i * tiers.FRAME_DT)
        for i in range(20):
            step(i)
        run = profile_run(lambda: [step(i) for i in range(20, 40)])
        log_profile(f"profile {name}", f"{name} frames 20-39 (pipelined)", 20,
                    run, out / f"torch_profile_{name}.txt")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", type=Path,
                    help="also compare the slice before and after the fused "
                         "kernel and with the epipolar filter on and off, "
                         "profile it and the mono slice (torch.profiler) and "
                         "write the tables into DIR")
    ap.add_argument("--loop-run", choices=LOOP_RUNS,
                    help="run one out-and-back run of phase 11 alone (the "
                         "smoke starts these itself)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's GPU path cannot run "
              "here", file=sys.stderr)
        return 2
    # before cuBLAS is first used: it then keeps one summation order, which
    # the loop paths' deterministic algorithms rely on
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if args.loop_run:
        return loop_child(args.loop_run)
    t_start = time.perf_counter()

    def phase_done(what: str):
        log(f"[time] {what} done at {time.perf_counter() - t_start:.1f} s")

    # the hard sequence, rendered once by worker processes: the preset
    # tiers take its first TIER_FRAMES frames, the loop tier all of them
    hard_all = tiers.hard_frames(tiers.HARD_N)
    hard = tuple(x[:TIER_FRAMES] for x in hard_all)
    log(f"[render] {tiers.HARD_N} frames of the hard sequence in "
        f"{time.perf_counter() - t_start:.1f} s")
    smi = smi_line()
    log(smi)
    device_mod.set_precision_policy()
    dev = torch.device("cuda", 0)
    log(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build(["lk_iterate", "klt_track"])
    lk._kernel_fn()
    klt._kernel_fn()
    log(f"[build] {time.perf_counter() - t0:.1f} s for both libraries (one "
        f"nvcc each, in parallel)")
    for name in ("lk_iterate", "klt_track"):
        log(f"[build] {name}.cu: {_build.BUILD_SECONDS.get(name, 0.0):.1f} s nvcc")
        for line in _build.BUILD_LOG.get(name, "").splitlines():
            if "Used" in line or "spill" in line or "smem" in line:
                log(f"[build] {name}: {line.strip()}")

    phase_done("build")
    lk_worst, lk_times = phase_kernel(dev)
    fl, fr, _ = syn.render_sequence(n_frames=4, step=0.05)
    klt_worst, klt_times = phase_klt(dev, (fl, fr))
    phase_done("kernels")
    phase_ransac(dev)
    phase_clahe(dev, fl[0])
    # the synthetic sequence: the slice takes its first N_FRAMES frames, the
    # chunk phase all of them (bench.py's surface)
    t0 = time.perf_counter()
    seq = syn.render_sequence(n_frames=CHUNK_FRAMES, step=STEP, yaw_rate=YAW)
    log(f"[render] {CHUNK_FRAMES} synthetic frames at {syn.W}x{syn.H} in "
        f"{time.perf_counter() - t0:.1f} s")
    launches, frames = phase_slice(dev, seq)
    mono, mono_frames = phase_mono(dev)
    phase_done("slices")
    presets, _ = phase_tiers("presets", dev, PRESET_TIERS, hard)
    rect, _ = phase_tiers("rect", dev, RECT_TIERS, hard)
    phase_done("preset and rect tiers")
    loop = {"klt_track": 0, "lk_iterate": 0}
    phase_lc_tier(dev, loop, hard_all)
    phase_done("loop tier")
    cli_total = {"klt_track": 0, "lk_iterate": 0}
    chunk = {"klt_track": 0, "lk_iterate": 0}
    with tempfile.TemporaryDirectory() as tmp:
        cli_root = Path(tmp)
        stamps = phase_cli(cli_total, hard, cli_root)
        phase_done("cli")
        graph_launches = phase_chunk(dev, chunk, seq, cli_root, stamps,
                                     hard[2][:CLI_FRAMES])
    phase_done("chunk (a), (b)")
    # the out-and-back runs beside 13c, which needs no clean timing
    procs = start_loop_runs()
    try:
        phase_repeat(dev, chunk, hard)
        phase_done("chunk (c)")
    finally:
        finish_loop_runs(procs, loop)
    phase_done("out-and-back runs")
    launches = {k: launches[k] + mono[k] + presets[k] + rect[k] + loop[k]
                + cli_total[k] + chunk[k] for k in launches}
    if args.profile:
        phase_compare(dev, frames)
        phase_profile(dev, frames, mono_frames, args.profile, hard)

    k_ms, p_ms, b_ms, b_by = klt_times["temporal"]
    lk_ms, lp_ms, lb_ms, lb_by = lk_times[(192, 10)]
    log(smi)
    print(json.dumps({"kernels": [
        {"name": "klt_track", "route": "cuda",
         "source": "ov2slam_tpu_torch/csrc/klt_track.cu",
         "replaces": "ov2slam_tpu/ops/pallas_lk.py:175",
         "launches": launches["klt_track"], "max_abs_err": klt_worst,
         "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
         "library_ms": None, "graph_replay_launches": graph_launches},
        {"name": "lk_iterate", "route": "cuda",
         "source": "ov2slam_tpu_torch/csrc/lk_iterate.cu",
         "replaces": "ov2slam_tpu/ops/pallas_lk.py:175",
         "launches": launches["lk_iterate"], "max_abs_err": lk_worst,
         "ms": lk_ms, "plain_ms": lp_ms, "bound_ms": lb_ms, "bound_by": lb_by,
         "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
