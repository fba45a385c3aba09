"""GPU smoke run of the PyTorch/CUDA port (ov2slam_tpu_torch).

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (any failure raises; nothing falls back to the CPU):
1. device: ``nvidia-smi`` name and power limit, precision policy, CUDA check;
2. build: compile ``csrc/lk_iterate.cu``, ``csrc/klt_track.cu`` and the
   empty kernel ``csrc/launch_floor.cu`` with one nvcc each, started
   together, and print ptxas' registers, shared memory and spills;
3. kernel lk_iterate: the per-chunk LK loop against its plain PyTorch
   version on the card, on seeded inputs at the slice's shapes; device time
   by CUDA-graph replay; its N = 1 chain (the slowest point alone over
   ``n_iters`` 1 / 10 / 30: the slope per GN step and the intercept) beside
   the launch floor (the empty kernel by graph replay);
4. kernel klt_track: the fused forward-backward KLT against
   ``fb_klt_tracking_plain`` on the card, on two rendered 752x480 frames at
   N = 192 and 320 (temporal pair with prior jitter 0 and 1.5 px; stereo
   pair without gradient pyramids), on float16 planes (the front end's
   storage) and on float32 planes; then the kernel on each plane type by
   CUDA-graph replay, the two in turns, and on float16 planes the whole
   ``fb_klt_tracking`` call and the per-chunk path (the plain glue around
   the ``lk_iterate`` kernel) by host clock, in turns;
5. ransac: ``essential_ransac`` (5-point, K = 512) and ``p3p_ransac``
   (K = 256) on the card and on the CPU with the same sample indices, on
   the correspondences of a rendered 752x480 pair 4 steps apart (step 0.05,
   ~11 px of parallax); host time and device operations per call, and no
   host sync inside either call; then the port's ``track_frame`` with the
   epipolar filter on that pair (the gate must fire and the filter apply);
   then ``triangulate_midpoint`` at a keyframe's point count, with one
   transform and with one per point: host ms, device ms by graph replay,
   device operations per call, the points within ``TRI_TOL`` of the truth;
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
   run on the card. Phases 1-8 run alone, one after the other;
   ``accurate_stereo`` runs in a process of its own (``--tier-run
   accurate_stereo``) started after them, beside phases 9 and 10 (so
   their host times, fps and latency percentiles, are not clean timings),
   and is waited for before phase 12, so that 12, 13 (a)-(b) and 14
   (a)-(b) run alone; the four out-and-back runs come last, as processes
   of their own (``--loop-run NAME``) started together beside phases 13
   (c) and 14 (c);
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
   beside the out-and-back runs of phase 11;
14. sharded: the multi-device path (``parallel/sharded.py``) on virtual
   meshes on the card. (a) the slice's last local BA problem (captured in
   phase 7) and ``accurate_stereo_nolc``'s (captured in phase 9), each
   solved on ``SHARDS`` shards: each solve repeats bit for bit, its
   inliers agree with ``solve_ba``'s, its final cost is within
   ``BA_COST_RTOL`` of it, and its poses and landmarks are within the JAX
   package's sharded tolerances of it, or, where the problem leaves a flat
   direction (far landmarks that any summation order moves along), within
   ``BA_WITNESS_X`` times the gaps between two single-device solves of it
   in two observation orders, measured in the same run; host ms of single
   and ``BA_TIMED_SHARDS`` shards in turns on ``accurate_stereo_nolc``'s;
   (b) ``essential_ransac_sharded`` on the card against the CPU on
   the same per-shard indices: inliers equal on every point; (c)
   ``accurate_stereo_rect`` through ``SlamSystem(mesh=...)`` on
   ``TIER_SHARDS`` shards under phase 10's checks, each ATE within 1.5x +
   5 mm of the JAX package's at the same ``n_devices`` on the CPU
   (``REF_SHARDED_ATE``), and the ATE spread across shard counts (ROADMAP
   C/R6); (d) with more than one card, (a) over distinct cards. (c) runs
   beside the out-and-back runs of phase 11, after 13 (c);
15. bench and rigs: (a) ``scripts/torch_bench.py``'s main (``bench.py``'s
   surface at full width, ``CHUNK_FRAMES`` frames) frame by frame and in
   chunks of ``CHUNK``, ``BENCH_PASSES`` timed passes each in this process:
   its JSON line (printed on a line of its own), each ATE within 1.5x + 5 mm
   of the JAX package's ``bench.py`` on the CPU (``REF_BENCH_ATE``), the
   card's name and power limit and the per-stage device ms in ``extra``
   with no TPU figure, one ``klt_track`` launch per tracking call and one
   graph replay launch per chunked frame. (a) runs beside (c) alone,
   before the out-and-back runs. (b) ``kitti_stereo`` (1241x376, the KITTI 00-02
   preset with ``bdo_stereo_rect``), ``tartanair_stereo`` (640x480, no
   distortion) and ``average_stereo``, each with its loop closer as shipped,
   over the first ``TIER_FRAMES`` frames of their rigs' hard sequences
   under phase 9's checks, live and ``wlc_opt`` ATEs held to ``REF_ATE``;
   then ``klt_track`` against ``fb_klt_tracking_plain`` on the KITTI rig's
   pyramid (level widths 1241, 621, 311, 156) and its device time beside
   its bound, on float16 and float32 planes. (c) ``accurate_mono_lc`` (the
   mono preset with the loop closer
   on) over all 1000 frames under phase 11's checks: a loop must close,
   live and ``wlc_opt`` Sim(3) ATEs within their bounds. (b) and (c) run
   in processes of their own (``--tier-run``, the EuRoC frames mapped from
   ``.npy`` files the smoke writes): (c) starts with (a), (b) with the
   out-and-back runs;
16. tools: (a) ``scripts/torch_profile_frame.py`` over the bench surface's
   ``CHUNK_FRAMES`` frames: every stage's mean per real frame finite, one
   replayed step per tracked frame, the gate-open share; (b) the latency fields of phase 9's tier rows
   (``fps_steady``, ``frame_ms_p50/p90/p99``, keyframe and cruise calls,
   ``warmup_s``, ``tracked_pct``; read, not run again); (c)
   ``scripts/torch_euroc_bench.py`` on the first ``EUROC_FRAMES`` frames of
   the hard sequence as an EuRoC tree with its ground-truth CSV,
   ``EUROC_REPEATS`` repeats: each finishes with a finite ATE and its
   trajectories renamed. (a) and (c) run in a process of their own
   (``--tier-run tools``) started with the out-and-back runs, so their
   times are not clean timings; (b) runs here after them.

The hard sequence is rendered once, at the start, by worker processes.

Each path's launch counts are set to 0 just before it runs and read just
after; the ``kernels`` line sums them over every path (phase 15 (a): over
its timed passes).
The last three lines of standard output are the card's ``nvidia-smi`` name
and power limit, a JSON object describing the kernels (``klt_track`` with
the numbers of its float16 planes, the main path's, and each plane type's
under ``planes``, and the launches its graph replays made,
``graph_replay_launches``), and ``{"ok": true, "device": {...}}``.

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
import ctypes
import functools
import inspect
import json
import os
import re
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
from ov2slam_tpu_torch.core import lie  # noqa: E402
from ov2slam_tpu_torch.io.trajectories import ate_rmse  # noqa: E402
from ov2slam_tpu_torch.ops import _build, klt, lk  # noqa: E402
from ov2slam_tpu_torch.ops import image as im  # noqa: E402
from ov2slam_tpu_torch.ops import mvg  # noqa: E402
from ov2slam_tpu_torch.opt import ba as ba_mod  # noqa: E402
from ov2slam_tpu_torch.parallel import sharded  # noqa: E402
from ov2slam_tpu_torch.slam import frontend as fe_mod  # noqa: E402
from ov2slam_tpu_torch.slam import graphs as graphs_mod  # noqa: E402
from ov2slam_tpu_torch.slam import mapper as mapper_mod  # noqa: E402
from ov2slam_tpu_torch.slam.estimator import Estimator  # noqa: E402
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
# the plane types klt_track takes: float16 (the front end's storage, the
# main path's) first, then float32
KLT_DTYPES = (torch.float16, torch.float32)
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32
# FLOP/s outside the tensor cores. One GN step costs ~30 FLOPs per patch
# sample (four hat weights, two taps per row, the blend, the residual and
# two multiply-adds).
HBM_BPS, F32_FLOPS, FLOPS_PER_SAMPLE = 3.35e12, 67e12, 30
# the N = 1 chain of klt_track (one warp alone: its latency) at these
# iteration budgets
KLT_CHAIN_ITERS = (1, 10, 30)
# lk_iterate's N = 1 chain at these n_iters
LK_CHAIN_ITERS = (1, 10, 30)
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
           "accurate_stereo_wlc_opt": REF_LC_WLC_OPT,
           "kitti_stereo": 0.019862658057194914,
           "kitti_stereo_wlc_opt": 0.01709556665262417,
           "tartanair_stereo": 0.005888699105020849,
           "tartanair_stereo_wlc_opt": 0.0055777191946200155,
           "average_stereo": 0.016601479208192875,
           "average_stereo_wlc_opt": 0.013120911765358153,
           "accurate_mono_lc": 0.05873727709656155,
           "accurate_mono_lc_wlc_opt": 0.04406910692129278}
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
# the midpoint triangulation at a keyframe's point count (the slice's
# kp_cap), held within TRI_TOL m of the true points
TRI_N, TRI_TOL = 192, 0.1
# the sharded phase: the slice's last local BA problem (captured in phase 7)
# solved on virtual meshes of SHARDS shards on the card, held to the
# single-device solve as tests/test_sharded.py holds the JAX package's
# (poses BA_POSE_TOL, landmarks BA_LM_TOL m, BA_INL_AGREE of the inliers,
# the final cost within BA_COST_RTOL of the single solve's) and repeated bit
# for bit; accurate_stereo_nolc's last (phase 9) on the same shards, held to
# the same bounds, and host ms of single and BA_TIMED_SHARDS shards of it in
# BA_TURNS turns. A problem that the observations leave free along a flat
# direction parts from itself under another summation order alone: two
# single-device solves of it, the observations in reverse order in the
# second, give the witness, and the pose and landmark bounds widen to
# BA_WITNESS_X times its gaps where those pass them (the cost bound does
# not widen); the sharded RANSAC (RANSAC_SHARDS x
# RANSAC_HYPS hypotheses) on the card against the CPU on the same indices;
# then the rect tier on TIER_SHARDS virtual shards, each ATE held to the JAX
# package's at the same n_devices on the CPU
# (`python3 scripts/torch_order_probe.py --backend jax --tier
# accurate_stereo_rect --n-devices 0,2,4,8`, 8 virtual CPU devices)
SHARDS, BA_TIMED_SHARDS, BA_TURNS = (2, 4, 8), 4, 3
BA_POSE_TOL, BA_LM_TOL, BA_INL_AGREE = 1e-4, 1e-3, 0.99
BA_COST_RTOL, BA_WITNESS_X = 1e-4, 2.0
RANSAC_SHARDS, RANSAC_HYPS = 4, 128
TIER_SHARDS = (4, 8)
REF_SHARDED_ATE = {("accurate_stereo_rect", 4): 0.013126949970873455,
                   ("accurate_stereo_rect", 8): 0.01214081804701655}
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
# the bench and rigs phase: scripts/torch_bench.py's main on bench.py's
# surface (CHUNK_FRAMES frames of the synthetic sequence) frame by frame and
# in chunks of CHUNK, BENCH_PASSES timed passes each, each ATE held to the
# JAX package's bench.py on the CPU (`JAX_PLATFORMS=cpu BENCH_PASSES=1
# BENCH_ACCOUNTING=0 python3 bench.py`, with BENCH_CHUNK=8 for the chunked
# line; bench.py prints it to 5 decimals); the KITTI, TartanAir and average
# stereo tiers (loop closer on as shipped) over the first TIER_FRAMES frames
# of their rigs' hard sequences, and accurate_mono_lc over all 1000 frames,
# which must close a loop (REF_ATE, from scripts/torch_preset_tiers.py
# --backend jax); klt_track against its plain version on the KITTI rig's
# frames 0-1 at the KITTI preset's kp_cap, pyramid levels and grid cell
BENCH_PASSES = 2
REF_BENCH_ATE = {0: 0.00234, CHUNK: 0.0028}
RIG_TIERS = ("kitti_stereo", "tartanair_stereo", "average_stereo")
MONO_LC = "accurate_mono_lc"
KITTI_KLT_N, KITTI_LEVELS, KITTI_CELL = 448, 3, 35
LC_MIN_INLIERS = {"accurate_stereo": MIN_INLIERS, MONO_LC: 1}
# the tools phase: scripts/torch_euroc_bench.py over the first EUROC_FRAMES
# frames of the hard sequence as an EuRoC tree with its ground truth, and
# the latency fields each preset tier's row must carry
EUROC_FRAMES, EUROC_REPEATS, EUROC_SEQ = 30, 2, "SYN_01"
LATENCY_KEYS = ("fps_steady", "frame_ms_p50", "frame_ms_p90", "frame_ms_p99",
                "frame_ms_max", "warmup_s", "tracked_pct", "first_call_ms")


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


def lk_check(tag: str, args, kw) -> float:
    """lk_iterate against lk_iterate_plain on the same inputs: points that
    stopped alike to PTS_TOL, every point to EPS, the active and converged
    masks equal on MASK_AGREE of the points; returns max |dp|."""
    pk, ak, ck = lk.lk_iterate(*args, **kw)
    pp, ap, cp = lk.lk_iterate_plain(*args, **kw)
    torch.cuda.synchronize()
    same = (ck == cp) & (ak == ap) & ~(ak & ap)
    err = (pk - pp).abs().amax(-1)
    err_same = float(err[same].max()) if bool(same.any()) else 0.0
    err_all = float(err.max())
    a_agree = float((ak == ap).float().mean())
    c_agree = float((ck == cp).float().mean())
    log(f"{tag}: max |dp| {err_all:.3g} px (stopped alike {err_same:.3g}), "
        f"active agree {a_agree:.4f}, converged agree {c_agree:.4f}")
    if err_same > PTS_TOL or err_all > EPS or min(a_agree, c_agree) < MASK_AGREE:
        raise AssertionError(
            f"{tag}: point error {err_same:.3g} px (stopped alike, tol "
            f"{PTS_TOL}), {err_all:.3g} px (all, tol {EPS}); mask agreement "
            f"active {a_agree:.4f} converged {c_agree:.4f} (need {MASK_AGREE})")
    return err_all


def lk_point_steps(args, kw) -> torch.Tensor:
    """(N,) GN steps each point takes in lk_iterate_plain on these inputs."""
    calls = []
    recording_lk(calls)(*args, **kw)
    return steps_per_point(calls)


def lk_chain(args, iters=LK_CHAIN_ITERS) -> dict:
    """lk_iterate's N = 1 chain: the point of `args` that takes the most GN
    steps in the plain version at n_iters = max(iters), alone (one warp on
    the card), by graph replay at each n_iters in `iters`, beside the GN
    steps the plain version takes for it there; the least-squares line of
    time over steps gives the per-step slope and the intercept (the launch,
    the window and template loads). Returns the keys of ``klt_chain``."""
    kw = dict(win=WIN, eps=EPS, margin=MARGIN)
    i = int(lk_point_steps(args, dict(kw, n_iters=max(iters))).argmax())
    a = [x[i:i + 1].contiguous() for x in args]
    us, steps = [], []
    for it in iters:
        k = dict(kw, n_iters=it)
        us.append(1000 * graph_ms(lambda: lk.lk_iterate(*a, **k)))
        steps.append(int(lk_point_steps(a, k).sum()))
    slope, intercept = (np.polyfit(steps, us, 1) if len(set(steps)) > 1
                        else (float("nan"), float("nan")))
    return dict(point=i, iters=list(iters), us=us, steps=steps,
                slope_us=float(slope), intercept_us=float(intercept))


def launch_floor_us(blocks: int, threads: int) -> float:
    """Device time per launch of csrc/launch_floor.cu's empty kernel at
    this grid, by graph replay as ``graph_ms`` times a kernel."""
    fn = _build.load("launch_floor").launch_floor_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch():
        err = fn(blocks, threads, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")
    return 1000 * graph_ms(launch)


def lk_ptxas(summary: dict) -> dict:
    """_build.ptxas_summary rows of lk_iterate.cu by instantiation ("<3>",
    "<8>": the samples per lane; "lk_iterate_kernel" where the kernel is no
    template); raises when no kernel entry is there."""
    out = {}
    for f, v in summary.items():
        m = re.search(r"lk_iterate_kernel(?:ILi(\d+)E)?", f)
        if m:
            f = f"<{m.group(1)}>" if m.group(1) else "lk_iterate_kernel"
        out[f] = v
    if not any("registers" in v for v in out.values()):
        raise AssertionError(f"lk_iterate.cu: no kernel in ptxas' log: "
                             f"{sorted(summary)}")
    return out


def phase_kernel(dev):
    """lk_iterate vs plain at N in {192, 320} and n_iters in {1, 10, 30},
    each call's device time beside its bound; then the N = 1 chain and the
    launch floor."""
    worst = 0.0
    times = {}
    for N in (192, 320):
        args = lk_case(N, seed=N, dev=dev)
        for n_iters in (1, 10, 30):
            kw = dict(win=WIN, n_iters=n_iters, eps=EPS, margin=MARGIN)
            worst = max(worst, lk_check(
                f"[kernel lk_iterate] N={N} n_iters={n_iters}", args, kw))
            k_ms = graph_ms(lambda: lk.lk_iterate(*args, **kw))
            p_ms = cuda_ms(lambda: lk.lk_iterate_plain(*args, **kw), 20)
            b_ms, b_by, nbytes, ops, calls = lk_bound(args, kw)
            per_point = steps_per_point(calls)
            times[(N, n_iters)] = (k_ms, p_ms, b_ms, b_by)
            log(f"[kernel lk_iterate] N={N} n_iters={n_iters}: device "
                f"{k_ms:.5f} ms (graph replay), plain {p_ms:.4f} ms; bound "
                f"{b_ms:.6f} ms by {b_by} ({nbytes} B; {ops} FLOP, "
                f"{int(per_point.sum())} GN steps, at most "
                f"{int(per_point.max())} for one point)")
    chain = lk_chain(lk_case(192, seed=192, dev=dev))
    floor = {"1x32": launch_floor_us(1, 32),
             "48x128": launch_floor_us(48, 128)}
    log(f"[kernel lk_iterate] N=1 chain (point {chain['point']} of the "
        f"N=192 seed-192 case, alone; graph replay): "
        f"{chain_text(chain, 'n_iters')}; launch floor (an empty kernel by "
        f"graph replay) {floor['1x32']:.2f} us at 1 block of 32 threads, "
        f"{floor['48x128']:.2f} us at 48 blocks of 128")
    torch.cuda.synchronize()
    return worst, times, dict(chain, launch_floor_us=floor)


def klt_window_origins(q, shape, ws: int):
    """ops/klt.py's window origins: clamp(round(q) - ws // 2) per axis."""
    H, W = shape
    o = torch.round(q).long() - ws // 2
    return torch.stack([o[:, 0].clamp(0, W - ws), o[:, 1].clamp(0, H - ws)], -1)


def klt_bound(args, kw):
    """Least time of one fb_klt_tracking call on these inputs, from the
    plain version's run. Bytes: the pixels its patches read, each read once
    at the planes' element size (per plane, the union of the footprints of
    the template patches, of every GN step's patch and of the level-0 error
    patch), plus the per-point inputs and outputs. Operations: those
    patches' samples. Planes are named: prev/next image and gradients per
    level."""
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
    esize = p0[0].element_size()        # 2 for float16 planes, 4 for float32
    nbytes = (esize * sum(int(m.sum()) for m in masks.values())
              + N * (8 + 8 + 1 + 8 + 1 + 4))
    ops = patches * P * FLOPS_PER_SAMPLE
    return bound(nbytes, ops) + (nbytes, ops, calls)


def per_chunk_klt():
    """fb_klt_tracking_plain around the lk_iterate kernel: the per-chunk
    path that the fused kernel replaced, for before/after timings."""
    return functools.partial(klt.fb_klt_tracking_plain, lk_fn=lk.lk_iterate)


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def klt_check(tag: str, args, kw) -> float:
    """klt_track against fb_klt_tracking_plain on the same inputs: status
    equal on MASK_AGREE of the points, points to PTS_TOL and error to
    ERR_TOL where both tracked, at least 100 of them; returns max |dp|."""
    r = klt.fb_klt_tracking(*args, **kw)
    rp = klt.fb_klt_tracking_plain(*args, **kw)
    torch.cuda.synchronize()
    agree = float((r.status == rp.status).float().mean())
    both = r.status & rp.status
    dp = float((r.points - rp.points).abs()[both].max()) if bool(both.any()) else 0.0
    de = float((r.error - rp.error).abs()[both].max()) if bool(both.any()) else 0.0
    log(f"{tag}: tracked {int(r.status.sum())} / plain "
        f"{int(rp.status.sum())} of {int(args[4].sum())} valid, status agree "
        f"{agree:.4f}, max |dp| {dp:.3g} px, max |derr| {de:.3g} where both "
        f"tracked")
    if agree < MASK_AGREE or dp > PTS_TOL or de > ERR_TOL or int(both.sum()) < 100:
        raise AssertionError(
            f"{tag}: status agree {agree:.4f} (need {MASK_AGREE}), |dp| "
            f"{dp:.3g} (tol {PTS_TOL}), |derr| {de:.3g} (tol {ERR_TOL}), "
            f"{int(both.sum())} tracked by both")
    return dp


def klt_ptxas(summary: dict) -> dict:
    """_build.ptxas_summary rows of klt_track.cu by instantiation
    ("<float, 3>", "<__half, 8>", ...; the plane type and the samples per
    lane); a device function left out of line keeps its mangled name."""
    out = {}
    for f, v in summary.items():
        m = re.search(r"klt_track_kernelI(f|6__half)(?:Li(\d+)E)?", f)
        if m:
            f = "<" + ("float" if m.group(1) == "f" else "__half") + (
                f", {m.group(2)}>" if m.group(2) else ">")
        out[f] = v
    return out


def point_steps(args, kw) -> torch.Tensor:
    """(N,) GN steps each point takes in fb_klt_tracking_plain on these
    inputs, over every level, chunk and the backward track."""
    calls = []
    klt.fb_klt_tracking_plain(*args, **kw, lk_fn=recording_lk(calls))
    return steps_per_point(calls)


def klt_chain(args, kw, iters=KLT_CHAIN_ITERS) -> dict:
    """The N = 1 chain: the case's slowest point (most GN steps in the
    plain version at the case's settings) tracked alone, one warp on the
    card, by graph replay at each max_iters in `iters`, beside the GN
    steps the plain version takes for it there. A least-squares line of
    time over steps gives the per-step slope and the intercept (window
    round trips, template set-up, the launch). Returns {"point", "us",
    "steps", "slope_us", "intercept_us"}."""
    i = int(point_steps(args, kw).argmax())
    a = list(args[:2]) + [x[i:i + 1].contiguous() for x in args[2:]]
    us, steps = [], []
    for it in iters:
        k = dict(kw, max_iters=it)
        us.append(1000 * graph_ms(lambda: klt.fb_klt_tracking(*a, **k)))
        steps.append(int(point_steps(a, k).sum()))
    slope, intercept = (np.polyfit(steps, us, 1) if len(set(steps)) > 1
                        else (float("nan"), float("nan")))
    return dict(point=i, iters=list(iters), us=us, steps=steps,
                slope_us=float(slope), intercept_us=float(intercept))


def chain_text(c: dict, budget: str = "max_iters") -> str:
    return (f"{budget} {' / '.join(map(str, c['iters']))}: "
            f"{' / '.join(f'{v:.2f}' for v in c['us'])} us, GN steps "
            f"{' / '.join(map(str, c['steps']))}; {c['slope_us']:.4f} us per "
            f"step, intercept {c['intercept_us']:.2f} us")


def kernel_only_kw(args, kw) -> dict:
    """kw with gradient pyramids (made once here, as the wrapper would
    make them) where the call has none: the kernel alone."""
    if "prev_grad_pyr" in kw:
        return kw
    return dict(kw, prev_grad_pyr=[klt._stored_grads(a) for a in args[0]],
                next_grad_pyr=[klt._stored_grads(a) for a in args[1]])


def phase_klt(dev, frames):
    """klt_track vs fb_klt_tracking_plain on the card on float16 and
    float32 planes, then the timings of both plane types in turns and the
    N = 1 chain on float16 planes. Returns ({dtype: max |dp|}, {(pair,
    dtype): (ms, plain ms, bound ms, by, [ms of each turn])}, the chain
    (``klt_chain``))."""
    worst = {}
    for dtype in KLT_DTYPES:
        worst[dtype] = 0.0
        for N in (192, 320):
            for pair, jitter in KLT_CASES:
                args, kw = klt_inputs.klt_case(frames, N, pair, jitter, dev,
                                               dtype=dtype)
                worst[dtype] = max(worst[dtype], klt_check(
                    f"[kernel klt_track] {dtype_name(dtype)} N={N} {pair} "
                    f"jitter {jitter}", args, kw))

    # timings at the slice's shapes (N = kp_cap = 192): the front end's
    # tracking call and the mapper's stereo call, each plane type by graph
    # replay in turns on one card; the whole call against the per-chunk
    # path on the front end's float16 planes
    times = {}
    for pair, jitter in (("temporal", 1.5), ("stereo", 0.0)):
        cases = {dt: klt_inputs.klt_case(frames, 192, pair, jitter, dev,
                                         dtype=dt) for dt in KLT_DTYPES}
        kernel_kw = {dt: kernel_only_kw(*cases[dt]) for dt in KLT_DTYPES}
        k_turns = {dt: [] for dt in KLT_DTYPES}
        for _ in range(2):
            for dt in KLT_DTYPES:
                k_turns[dt].append(graph_ms(
                    lambda dt=dt: klt.fb_klt_tracking(*cases[dt][0],
                                                      **kernel_kw[dt])))
        args, kw = cases[KLT_DTYPES[0]]
        fused = lambda: klt.fb_klt_tracking(*args, **kw)          # noqa: E731
        chunked = lambda: per_chunk_klt()(*args, **kw)            # noqa: E731
        turns = [host_ms(fused, 50), host_ms(chunked, 20),
                 host_ms(fused, 50), host_ms(chunked, 20)]
        log(f"[kernel klt_track] N=192 {pair} on float16 planes: whole call "
            f"{turns[0]:.4f} / {turns[2]:.4f} ms vs per-chunk path "
            f"{turns[1]:.4f} / {turns[3]:.4f} ms (host clock, in turns)")
        for dt in KLT_DTYPES:
            a, k = cases[dt]
            p_ms = host_ms(lambda: klt.fb_klt_tracking_plain(*a, **k), 3)
            b_ms, b_by, nbytes, ops, calls = klt_bound(a, kernel_kw[dt])
            per_point = steps_per_point(calls)
            k_ms = float(np.mean(k_turns[dt]))
            times[(pair, dt)] = (k_ms, p_ms, b_ms, b_by, k_turns[dt])
            log(f"[kernel klt_track] timing N=192 {pair} {dtype_name(dt)}: "
                f"device {' / '.join(f'{v:.5f}' for v in k_turns[dt])} ms "
                f"(graph replay, turns with the other plane type); plain "
                f"{p_ms:.3f} ms; bound {b_ms:.6f} ms by {b_by} ({nbytes} B; "
                f"{ops} FLOP, {int(per_point.sum())} GN steps, at most "
                f"{int(per_point.max())} for one point)")
        if pair == "temporal":
            dt = KLT_DTYPES[0]
            chain = klt_chain(cases[dt][0], kernel_kw[dt])
            log(f"[kernel klt_track] N=1 chain on {dtype_name(dt)} planes "
                f"(point {chain['point']} of the N=192 {pair} case, alone; "
                f"graph replay): {chain_text(chain)}")
    torch.cuda.synchronize()
    return worst, times, chain


def _is_scope(e) -> bool:
    """The port's record_function scopes ("0.Full-Front_End", ...,
    "9.Host_GC")."""
    return e.key[:2] in ("0.", "1.", "2.", "9.")


def profile_run(fn, prof_timers=None):
    """fn() under torch.profiler: (wall ms, device busy ms, device
    operations (kernel launches and copies), the profiler's key_averages).
    `prof_timers`, the system's Profiler, is enabled for the run, so that
    its scopes reach the trace (disabled, a scope opens none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    was = prof_timers.enabled if prof_timers is not None else None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if prof_timers is not None:
            prof_timers.enabled = True
        try:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1000 * (time.perf_counter() - t0)
        finally:
            if prof_timers is not None:
                prof_timers.enabled = was
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


@contextlib.contextmanager
def recording_local_ba(solves: list):
    """Record every local BA solve of the estimator (``Estimator._solve``)
    as (problem, solver settings), single-device or sharded."""
    real = Estimator._solve

    def rec(self, prob, max_iters):
        solves.append((prob, self.solver_settings(max_iters)))
        return real(self, prob, max_iters)
    Estimator._solve = rec
    try:
        yield
    finally:
        Estimator._solve = real


def ransac_pair(dev):
    """The port's own correspondences on a rendered pair 4 steps apart: the
    stereo system's first keyframe on frame 0, then tracking to frame 4
    (no filter, no P3P start)."""
    fl, fr, _ = syn.render_sequence(n_frames=5, step=MONO_STEP)
    slam = SlamSystem(SlamParams.from_dict(syn.slam_params_dict()), device=dev)
    slam.process_stereo(fl[0], fr[0], 0.0)
    st = slam.fe_state
    cur, gx, gy = fe_mod.stored_pyramids(slam._to_device_u8(fl[4]), 3)
    lm_pos, lm_is3d = slam.map.device_landmarks()
    track_args = (st.pyr, cur, st.kps, lm_pos, lm_is3d, slam.cam_l, st.R_cw,
                  st.t_cw, st.R_cw, st.t_cw)
    track_kw = dict(prev_gpyr=tuple(zip(st.gx, st.gy)),
                    cur_gpyr=tuple(zip(gx, gy)))
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


def phase_triangulation(dev):
    """mvg.triangulate_midpoint at a keyframe's point count (TRI_N, the
    slice's kp_cap) as mapper.triangulate_stereo calls it (one transform, a
    0.11 m baseline) and as triangulate_temporal does (a transform per
    point): host ms per synchronised call, device ms by graph replay,
    device operations per call, and the largest distance to the true
    points (3-12 m deep)."""
    gen = torch.Generator().manual_seed(5)
    X = (torch.rand(TRI_N, 3, generator=gen) * torch.tensor([12.0, 8.0, 9.0])
         + torch.tensor([-6.0, -4.0, 3.0]))
    poses = {"stereo": lie.SE3(torch.eye(3), torch.tensor([0.11, 0.0, 0.0])),
             "temporal": lie.SE3(
                 lie.so3_exp(0.02 * torch.randn(TRI_N, 3, generator=gen)),
                 0.05 * torch.randn(TRI_N, 3, generator=gen)
                 + torch.tensor([0.3, 0.0, 0.0]))}
    for tag, T in poses.items():
        X_b = torch.einsum("...ji,...j->...i", T.R, X - T.t)
        args = (lie.SE3(T.R.to(dev), T.t.to(dev)),
                (X / X.norm(dim=-1, keepdim=True)).to(dev),
                (X_b / X_b.norm(dim=-1, keepdim=True)).to(dev))

        def call(args=args):
            return mvg.triangulate_midpoint(*args)

        err = float((call().cpu() - X).abs().max())
        ms, d_ms = host_ms(call, 20), graph_ms(call)
        ops = profile_run(call)[2]
        log(f"[triangulation] triangulate_midpoint, {tag}, N={TRI_N}: "
            f"{ms:.4f} ms per synchronised call (host clock), {d_ms:.5f} ms "
            f"of device time by graph replay, {ops} device operations per "
            f"call; at most {err:.3g} m from the true points")
        assert err < TRI_TOL, (tag, err)


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


def phase_slice(dev, seq, captured: dict):
    """The stereo slice on the card, from the system's public entry points,
    with the epipolar filter on, over the first N_FRAMES frames of `seq`
    (the synthetic sequence, left, right, camera-to-world poses). Its last
    local BA problem and solver settings are kept in `captured["slice"]`."""
    fl, fr, gt = (x[:N_FRAMES] for x in seq)
    slam = SlamSystem(SlamParams.from_dict(syn.slam_params_dict()), device=dev)
    assert slam.params.doepipolar
    calls, syncs, solves = [], collections.Counter(), []
    klt.LAUNCHES = lk.LAUNCHES = 0
    with recording_essential_ransac(calls), recording_local_ba(solves):
        est, launches, is_kf, dts = run_frames(
            slam, lambda i: slam.process_stereo(fl[i], fr[i], i * 0.05), syncs)
    captured["slice"] = solves[-1]
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


def phase_tiers(tag: str, dev, names, hard, shards: int = 0,
                captured: dict = None):
    """Each tier of `names` through SlamSystem on the card, as
    scripts/torch_preset_tiers.py runs it, with this smoke's checks, under
    PyTorch's deterministic algorithms, as the CLI runs (without them the
    local BA's scatter-adds sum in another order in every run, and a tier's
    ATE moves from run to run: on an NVIDIA H100 80GB HBM3 at 700 W,
    ``accurate_stereo_rect`` read 0.0106-0.0120 m in seven of eight runs
    and 0.0376 m in the eighth, which took one keyframe more). With
    `shards`, each system's local BA runs on a virtual mesh of that many
    shards on the card, and the ATE is held to the JAX package's at the
    same n_devices (``REF_SHARDED_ATE``). With `captured`, the last local
    BA problem of each tier and its solver settings are kept there. `hard`
    holds the hard sequence's frames, or a dict of them by the tiers'
    datasets. A tier with the loop closer on also holds its ``wlc_opt`` ATE
    to the JAX package's. Returns the launches of both kernels over the
    phase and each tier's row."""
    total = {"klt_track": 0, "lk_iterate": 0}
    rows = {}
    for name in names:
        d = tiers.tier_dict(name)
        mono = bool(d.get("mono"))
        t = tiers.TIERS[name]
        frames = (tiers.kf2f_frames() if t is None
                  else hard[t.dataset] if isinstance(hard, dict) else hard)
        mesh = sharded.make_mesh(devices=[dev] * shards) if shards else None
        slam = SlamSystem(SlamParams.from_dict(d), device=dev, mesh=mesh)
        syncs, per_call, stereo_kf = collections.Counter(), [], []

        def call(i, fn):
            k0, s0 = klt.LAUNCHES, len(stereo_kf)
            count_syncs(fn, syncs)
            per_call.append(klt.LAUNCHES - k0 - (len(stereo_kf) - s0))

        klt.LAUNCHES = lk.LAUNCHES = 0
        gate, solves = [], []
        with tiers.deterministic(set()), counting_stereo_kf_steps(stereo_kf), \
                recording_essential_ransac(gate), recording_local_ba(solves):
            row = tiers.run_tier(slam, frames, mono, call=call,
                                 sync=torch.cuda.synchronize)
        total["klt_track"] += klt.LAUNCHES
        total["lk_iterate"] += lk.LAUNCHES
        if captured is not None and solves:
            captured[name] = solves[-1]
        n = row["frames"]
        poses = np.stack(slam.logger.poses_wc)
        ref = REF_SHARDED_ATE[name, shards] if shards else REF_ATE[name]
        pc = slam.pipeline_counts
        rows[name] = row
        log(f"[{tag}] {name}"
            + (f" on {shards} shards ({len(solves)} sharded local BAs)"
               if shards else "")
            + f": ATE {row['ate']:.5f} m (JAX CPU {ref:.5f}, "
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
        if "ate_wlc_opt" in row and not shards:
            ref_opt = REF_ATE[name + "_wlc_opt"]
            log(f"[{tag}] {name}: wlc_opt ATE {row['ate_wlc_opt']:.5f} m (JAX "
                f"CPU {ref_opt:.5f}, bound {ATE_SLACK * ref_opt + ATE_ABS:.5f}),"
                f" loops {row['loops']}, final passes "
                f"{1000 * row['final_seconds']:.0f} ms")
            assert row["ate_wlc_opt"] <= ATE_SLACK * ref_opt + ATE_ABS, row
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


def phase_lc_tier(dev, total: dict, frames, name: str = "accurate_stereo",
                  tag: str = "loop"):
    """11a. accurate_stereo, the shipped loop-closing preset, over the
    whole hard sequence (`frames`); 15 (c) the same for accurate_mono_lc."""
    slam = tiers.make_system("torch", tiers.tier_dict(name), dev, tiers.LC_DETECTOR)
    assert slam.loopcloser is not None and slam.params.force_realtime
    mono = bool(slam.params.mono)
    ops = set()
    with tiers.deterministic(ops):
        row, rec = drive_loop(lambda call: tiers.run_tier(
            slam, frames, mono, call=call, sync=torch.cuda.synchronize), total)
    n = row["frames"]
    poses = np.stack(slam.logger.poses_wc)
    ref, ref_opt = REF_ATE[name], REF_ATE[name + "_wlc_opt"]
    closures = [ms for ms, ev in rec["process_kf"] if ev is not None]
    per_kf = [ms for ms, ev in rec["process_kf"] if ev is None]
    log(f"[{tag}] {name}: {n} frames, ATE {row['ate']:.5f} m (JAX CPU "
        f"{ref:.5f}, bound {ATE_SLACK * ref + ATE_ABS:.5f}), wlc_opt ATE "
        f"{row['ate_wlc_opt']:.5f} m (JAX CPU {ref_opt:.5f}, bound "
        f"{ATE_SLACK * ref_opt + ATE_ABS:.5f}), {row['fps']:.2f} fps over "
        f"frames 1-{n - 1} with the flush, keyframes {row['keyframes']}, "
        f"landmarks {row['landmarks']}, loops [query, match, inliers, merged,"
        f" jump m] {row['loops']}, final passes {1000 * row['final_seconds']:.0f} ms;"
        f" deterministic algorithms on, operations without a deterministic "
        f"version: {sorted(ops) or 'none'}")
    log(f"[{tag}] {name}: loop-closing stage per keyframe without a closure: "
        f"{_ms_summary(per_kf)}; with a closure: {_ms_summary(closures)}; "
        f"span BA: {_ms_summary([ms for ms, _ in rec['span_ba']])}; budget "
        f"timeouts {slam.estimator.n_ba_timeouts}")
    assert poses.shape == (n, 4, 4) and np.isfinite(poses).all(), (
        f"{name}: {len(poses)} poses logged for {n} frames")
    assert any(e[2] >= LC_MIN_INLIERS[name] for e in row["loops"]), (
        f"{name}: no loop closure with >= {LC_MIN_INLIERS[name]} inliers: "
        f"{row['loops']}")
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


def ba_gaps(a, b, prob) -> tuple:
    """(pose gap, landmark gap (m), inlier agreement) of two BA results of
    `prob`, over its valid landmarks and live observations."""
    n_obs, lm = prob.obs_kf.shape[0], prob.lm_valid.cpu()
    pose = max(float((a.R - b.R).abs().max()), float((a.t - b.t).abs().max()))
    lmk = float((a.Xw.cpu() - b.Xw.cpu())[lm].abs().max())
    agree = float((a.obs_inlier[:n_obs].cpu()
                   == b.obs_inlier[:n_obs].cpu()).float().mean())
    return pose, lmk, agree


def order_witness(prob, kw: dict, single) -> tuple:
    """(pose gap, landmark gap (m), relative cost gap) between `single`,
    the single-device solve of `prob`, and a single-device solve of it
    with its observations in reverse order: how far another summation
    order alone moves the solve."""
    rev = ba_mod.solve_ba(reversed_order(prob), **kw)
    pose, lmk, _ = ba_gaps(rev, single, prob)
    return pose, lmk, cost_gap(rev, single)


def cost_gap(a, b) -> float:
    """|a.cost - b.cost| relative to b.cost."""
    return abs(float(a.cost) - float(b.cost)) / float(b.cost)


def check_sharded_ba(tag: str, prob, kw: dict, single, mesh,
                     witness: tuple) -> None:
    """The sharded solve of `prob` over `mesh` twice: bit for bit the same,
    its inliers as the single-device solve's, its final cost within
    BA_COST_RTOL of it, and its poses and landmarks within BA_POSE_TOL and
    BA_LM_TOL of it, or within BA_WITNESS_X times the gaps of `witness`
    (``order_witness``) where those are the larger."""
    padded = sharded.pad_observations(prob, len(mesh))
    r1 = sharded.solve_ba_sharded(padded, mesh, **kw)
    r2 = sharded.solve_ba_sharded(padded, mesh, **kw)
    same = all(torch.equal(x, y) for x, y in zip(r1[:7], r2[:7]))
    pose, lmk, agree = ba_gaps(r1, single, prob)
    cost = cost_gap(r1, single)
    pose_tol = max(BA_POSE_TOL, BA_WITNESS_X * witness[0])
    lmk_tol = max(BA_LM_TOL, BA_WITNESS_X * witness[1])
    log(f"[sharded] {tag}: {len(mesh)} shards on {sorted({str(d) for d in mesh})}"
        f": repeats bit for bit {same}; against the single-device solve "
        f"poses {pose:.3g} apart (bound {pose_tol:.3g}), landmarks "
        f"{lmk:.3g} m ({lmk_tol:.3g}), inliers agree {agree:.4f}; cost "
        f"{float(r1.cost0):.4f} -> {float(r1.cost):.4f} (single "
        f"{float(single.cost):.4f}, {cost:.3g} apart, bound {BA_COST_RTOL:g}),"
        f" {r1.n_iters} iterations")
    assert same, f"{tag}: two sharded solves parted"
    assert agree >= BA_INL_AGREE, (tag, agree)
    assert pose < pose_tol and lmk < lmk_tol, (tag, pose, lmk)
    assert cost <= BA_COST_RTOL, (tag, cost)


def reversed_order(prob):
    """The problem with its observations in reverse order: the same
    function, another summation order."""
    rev = torch.arange(prob.obs_kf.shape[0] - 1, -1, -1, device=prob.obs_kf.device)
    return prob._replace(**{k: getattr(prob, k)[rev] for k in (
        "obs_kf", "obs_lm", "obs_px", "obs_right", "obs_valid")})


def phase_sharded(dev, captured: dict):
    """14 (a), (b), (d). The multi-device path (parallel/sharded.py) on
    virtual meshes on the card: (a) the slice's last local BA problem and
    accurate_stereo_nolc's (phase 9) on SHARDS shards against the
    single-device solve (bit-equal repeats, inliers, the final cost, poses
    and landmarks within the tolerances or, on a problem with a flat
    direction, within BA_WITNESS_X times the gaps of two single-device
    solves in two observation orders), and host ms of single and sharded
    solves of accurate_stereo_nolc's in turns; (b) the sharded essential
    RANSAC on the card against the CPU; (d) (a) over a mesh of distinct
    cards where there are several."""
    single, witness = {}, {}
    for name, label in (("slice", "the slice's"),
                        ("accurate_stereo_nolc", "accurate_stereo_nolc's")):
        prob, kw = captured[name]
        single[name] = ba_mod.solve_ba(prob, **kw)
        witness[name] = w = order_witness(prob, kw, single[name])
        log(f"[sharded] {label} last local BA: {prob.R.shape[0]} keyframes, "
            f"{int(prob.lm_valid.sum())} landmarks, {prob.obs_kf.shape[0]} "
            f"observations, {kw['method']}, l2_refine {kw['l2_refine']}; two "
            f"single-device solves, the observations in reverse order in the "
            f"second: poses {w[0]:.3g} apart, landmarks {w[1]:.3g} m, cost "
            f"{w[2]:.3g}")
        for n in SHARDS:
            check_sharded_ba(f"(a) {name}", prob, kw, single[name],
                             sharded.make_mesh(devices=[dev] * n), w)
    prob, kw = captured["accurate_stereo_nolc"]
    mesh = sharded.make_mesh(devices=[dev] * BA_TIMED_SHARDS)
    padded = sharded.pad_observations(prob, BA_TIMED_SHARDS)
    ms = {"single": [], "sharded": []}
    for _ in range(BA_TURNS):
        ms["single"].append(host_ms(lambda: ba_mod.solve_ba(prob, **kw), 1))
        ms["sharded"].append(host_ms(
            lambda: sharded.solve_ba_sharded(padded, mesh, **kw), 1))
    log(f"[sharded] (a) host ms per solve in turns: single "
        f"{_ms_summary(ms['single'])}; {BA_TIMED_SHARDS} shards on one card "
        f"{_ms_summary(ms['sharded'])}")

    # (b) the sharded RANSAC, card against CPU, the same indices per shard
    pair = ransac_pair(dev)
    bv_a, bv_b, valid = pair["ess"]
    gen = torch.Generator().manual_seed(1)
    idx = [mvg.draw_samples(valid.cpu(), RANSAC_HYPS, 5, gen)
           for _ in range(RANSAC_SHARDS)]
    cpu = [x.cpu() for x in (bv_a, bv_b, valid)]
    rc = sharded.essential_ransac_sharded(
        *cpu, pair["th"], sharded.make_mesh(RANSAC_SHARDS, device="cpu"),
        idx=idx)
    mesh_r = sharded.make_mesh(devices=[dev] * RANSAC_SHARDS)
    t0 = time.perf_counter()
    rg = sharded.essential_ransac_sharded(bv_a, bv_b, valid, pair["th"],
                                          mesh_r, idx=[i.to(dev) for i in idx])
    torch.cuda.synchronize()
    r_ms = 1000 * (time.perf_counter() - t0)
    agree = float((rg.inliers.cpu() == rc.inliers).float().mean())
    log(f"[sharded] (b) essential_ransac_sharded, {RANSAC_SHARDS} x "
        f"{RANSAC_HYPS} hypotheses: card {int(rg.n_inliers)} / CPU "
        f"{int(rc.n_inliers)} inliers, masks agree {agree:.4f}, success "
        f"{bool(rg.success)} / {bool(rc.success)}; {r_ms:.1f} ms on the card "
        f"(first call, host clock)")
    assert agree == 1.0 and bool(rg.success) and bool(rc.success), agree

    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        check_sharded_ba("(d)", *captured["slice"], single["slice"],
                         sharded.make_mesh(min(n_cards, BA_TIMED_SHARDS)),
                         witness["slice"])
    else:
        log("[sharded] (d) one card: the mesh of distinct cards waits for a "
            "machine with more than one")


def phase_sharded_tier(dev, total: dict, hard, rect_ate: float):
    """14 (c). The rect tier on TIER_SHARDS virtual shards through
    SlamSystem(mesh=...), each ATE held to the JAX package's at the same
    n_devices, and the ATE spread across shard counts with `rect_ate`
    (phase 10, one device). Runs beside the out-and-back runs: its fps are
    not clean timings. Adds its launches to `total`."""
    ates = {0: rect_ate}
    for n in TIER_SHARDS:
        t0 = time.perf_counter()
        launches, rows = phase_tiers("sharded (c)", dev,
                                     ["accurate_stereo_rect"], hard, shards=n)
        for k in total:
            total[k] += launches[k]
        ates[n] = rows["accurate_stereo_rect"]["ate"]
        log(f"[sharded] (c) {n} shards: {time.perf_counter() - t0:.1f} s, "
            f"klt_track {launches['klt_track']}")
    log(f"[sharded] (c) R6: accurate_stereo_rect ATE by shard count on the "
        f"card: " + ", ".join(f"{n}: {a:.5f} m" for n, a in sorted(ates.items()))
        + f"; spread {max(ates.values()) - min(ates.values()):.5f} m")


def phase_bench(dev, total: dict, seq) -> int:
    """15 (a). scripts/torch_bench.py's main on the card, frame by frame and
    in chunks of CHUNK, BENCH_PASSES passes each: its JSON line (printed
    by it), the ATE held to bench.py's on the CPU, the accounting present
    without a TPU figure; one klt_track launch per tracking call besides
    the keyframe stereo matches, and in chunks one graph replay launch per
    chunked frame. `seq`: the surface's frames (phase 13's). Adds the
    wrapper's launches of the timed passes to `total`; returns the graph
    replays' launches."""
    import torch_bench
    replays = 0
    for chunk in (0, CHUNK):
        per_call, stereo_kf = [], []
        klt.LAUNCHES = lk.LAUNCHES = 0
        with counting_stereo_kf_steps(stereo_kf), \
                counting_tracking_calls(per_call, stereo_kf):
            out = torch_bench.main(["--frames", str(CHUNK_FRAMES), "--passes",
                                    str(BENCH_PASSES), "--chunk", str(chunk)],
                                   frames=seq)
        ex = out["extra"]
        ref = REF_BENCH_ATE[chunk]
        bound = ATE_SLACK * ref + ATE_ABS
        total["klt_track"] += ex["klt_track_launches"]
        total["lk_iterate"] += lk.LAUNCHES
        replays += ex["klt_track_graph_launches"]
        stages = ex.get("per_stage_ms", {})
        log(f"[bench] {'chunks of ' + str(chunk) if chunk else 'frame by frame'}"
            f": best {out['value']:.2f} fps, passes "
            f"{[round(f, 2) for f in ex['fps_passes_best_to_worst']]}, ATE "
            f"{ex['ate_rmse_m']:.5f} m (JAX bench.py on the CPU {ref:.5f}, "
            f"bound {bound:.5f}), keyframes {ex['n_keyframes']}, landmarks "
            f"{ex['n_landmarks_3d']}; frame step "
            f"{ex.get('frame_step_eager_ms')} ms eager; "
            f"stages {stages}; klt_track {stages.get('fb_klt')}"
            f" ms vs bound {ex.get('klt_bound_ms')} ms (share "
            f"{ex.get('klt_bound_share')}); klt_track over the passes by its "
            f"wrapper {ex['klt_track_launches']}, by graph replays "
            f"{ex['klt_track_graph_launches']}; lk_iterate {lk.LAUNCHES}")
        assert "accounting_error" not in ex, ex["accounting_error"]
        assert ex["ate_rmse_m"] <= bound, (chunk, ex["ate_rmse_m"], bound)
        assert len(ex["fps_passes_best_to_worst"]) == BENCH_PASSES
        assert smi_line() in ex["backend"], ex["backend"]
        assert set(stages) == {"preprocess_grads", "fb_klt"}
        assert not {"mfu_est", "hbm_util_est", "flops_per_frame"} & set(ex)
        assert lk.LAUNCHES == 0, "the per-chunk LK path ran"
        # frame-by-frame calls (every system's first is its initial keyframe)
        assert set(per_call) <= {0, 1} and per_call.count(1) >= (
            BENCH_PASSES * (CHUNK_FRAMES - 1 if not chunk else CHUNK - 1)), (
            sorted(collections.Counter(per_call).items()))
        if chunk:
            assert ex["klt_track_graph_launches"] == BENCH_PASSES * (
                CHUNK_FRAMES - CHUNK), ex["klt_track_graph_launches"]
    return replays


def klt_kitti(dev, kitti) -> dict:
    """15 (b). klt_track against its plain version on the KITTI rig's
    frames 0-1 (level widths 1241, 621, 311, 156: odd origins and odd row
    strides, which a float16 plane's 2-byte elements leave unaligned), on
    float16 and float32 planes, then each one's device time by graph
    replay beside its bound. Returns {dtype name: (max |dp|, ms, bound ms,
    by)}."""
    out = {}
    for dtype in KLT_DTYPES:
        args, kw = klt_inputs.klt_case(
            (kitti[0][:2], kitti[1][:2]), KITTI_KLT_N, "temporal", 1.5, dev,
            nlevels=KITTI_LEVELS, cell=KITTI_CELL, dtype=dtype)
        shapes = [tuple(a.shape) for a in args[0]]
        assert shapes[-1][1] % 2 == 0 and all(w % 2 for _, w in shapes[:-1]), shapes
        dp = klt_check(f"[rigs] klt_track on the KITTI rig, {dtype_name(dtype)}"
                       f" levels {shapes}, N={KITTI_KLT_N}", args, kw)
        k_ms = graph_ms(lambda: klt.fb_klt_tracking(*args, **kw))
        b_ms, b_by, nbytes, ops, _ = klt_bound(args, kw)
        log(f"[rigs] klt_track on the KITTI rig, {dtype_name(dtype)}: device "
            f"{k_ms:.5f} ms (graph replay), bound {b_ms:.6f} ms by {b_by} "
            f"({nbytes} B; {ops} FLOP)")
        out[dtype_name(dtype)] = (dp, k_ms, b_ms, b_by)
    return out


def save_frames(frames, root: Path, seq) -> Path:
    """The hard sequence's left and right images and its gt positions, and
    the synthetic sequence `seq`, as .npy files (a child process maps them
    instead of rendering again)."""
    np.save(root / "left.npy", np.stack(frames[0]))
    np.save(root / "right.npy", np.stack(frames[1]))
    np.save(root / "gt.npy", frames[2])
    for k, x in zip(("left", "right", "gt"), seq):
        np.save(root / f"syn_{k}.npy", np.stack(x))
    return root


def tier_child(name: str, root: Path) -> int:
    """--tier-run NAME over the frames saved under `root`, on the card: 11,
    the loop tier ("accurate_stereo"), 15 (b), the rig tiers ("rigs": the
    KITTI and TartanAir frames rendered here, the EuRoC ones mapped) and
    klt_track on the KITTI rig, 15 (c), the mono loop tier, or 16 (a) and
    (c), the tools ("tools": the synthetic sequence and the hard sequence
    mapped). The last line is its
    kernels' launches (and the KITTI kernel check's numbers)."""
    device_mod.set_precision_policy()
    _build.build(["lk_iterate", "klt_track"])
    dev = torch.device("cuda", 0)
    left = np.load(root / "left.npy", mmap_mode="r")
    gt = np.load(root / "gt.npy")
    total = {"klt_track": 0, "lk_iterate": 0}
    out = {"tier_run": name, "launches": total}
    if name == "tools":
        seq = tuple(list(np.load(root / f"syn_{k}.npy"))
                    for k in ("left", "right", "gt"))
        hard = (left[:EUROC_FRAMES],
                np.load(root / "right.npy", mmap_mode="r")[:EUROC_FRAMES],
                gt[:EUROC_FRAMES])
        phase_tools(dev, seq, hard, root, total)
    elif name == "rigs":
        right = np.load(root / "right.npy", mmap_mode="r")[:TIER_FRAMES]
        rigs = {"euroc": (left[:TIER_FRAMES], right, gt[:TIER_FRAMES]), **{
            tiers.TIERS[n].dataset: tiers.hard_frames(
                TIER_FRAMES, dataset=tiers.TIERS[n].dataset)
            for n in RIG_TIERS if tiers.TIERS[n].dataset != "euroc"}}
        launches, _ = phase_tiers("rigs", dev, RIG_TIERS, rigs)
        total.update(launches)
        out["kitti_klt"] = klt_kitti(dev, rigs["kitti"])
    elif name == MONO_LC:
        phase_lc_tier(dev, total, (left, left, gt), name, tag="mono lc")
    else:
        phase_lc_tier(dev, total, (left, np.load(root / "right.npy",
                                                 mmap_mode="r"), gt), name)
    print(json.dumps(out), flush=True)
    return 0


def start_runs(runs):
    """Start a process of this script for each (name, arguments) of `runs`,
    all at once: they share the card and the host, so their host times are
    not clean timings."""
    return [(name, subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), *argv],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, argv in runs]


def start_loop_runs():
    """The four out-and-back runs, one process each (--loop-run NAME)."""
    return start_runs([(name, ["--loop-run", name]) for name in LOOP_RUNS])


def start_tier_run(name: str, root: Path):
    """Phase 15's run `name` in a process of its own (--tier-run)."""
    return start_runs([(name, ["--tier-run", name, "--frames-dir", str(root)])])


def finish_loop_runs(procs, total: dict, timeout_s: float = 900) -> dict:
    """Wait for the runs, relay their output, add their launches to
    `total`; raise if one failed. Every process is ended on the way out.
    Returns each run's last line."""
    last = {}
    try:
        for name, proc in procs:
            out, _ = proc.communicate(timeout=timeout_s)
            lines = out.strip().splitlines()
            for line in lines[:-1]:
                log(line)
            if proc.returncode != 0 or not lines:
                raise AssertionError(f"run {name} failed (exit "
                                     f"{proc.returncode}): {lines[-1:]}")
            last[name] = json.loads(lines[-1])
            counts = last[name]["launches"]
            for k in total:
                total[k] += counts[k]
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return last


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
                                       for i in range(1, n_prof + 1)], slam.prof)
        log_profile(f"profile {name}", f"frames 1-{n_prof}, KLT path {name}",
                    n_prof, run, out / f"torch_profile_slice_{name}.txt")
    slam = SlamSystem(mono_params(), device=dev)
    for i in range(20):
        slam.process_mono(mono_frames[i], i * 0.05)
    run = profile_run(lambda: [slam.process_mono(mono_frames[i], i * 0.05)
                               for i in range(20, 30)], slam.prof)
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
        run = profile_run(lambda: [step(i) for i in range(20, 40)], slam.prof)
        log_profile(f"profile {name}", f"{name} frames 20-39 (pipelined)", 20,
                    run, out / f"torch_profile_{name}.txt")


def phase_tools(dev, seq, hard, root: Path, total: dict):
    """16 (a), (c). (a) scripts/torch_profile_frame.py over the bench
    surface's CHUNK_FRAMES frames (`seq`): every stage's mean per real
    frame finite, one replayed step per tracked frame, the gate-open share
    in [0, 1] and the card's name and power limit in its line; (c) scripts/torch_euroc_bench.py on the first
    EUROC_FRAMES frames of the hard sequence written under `root` as an
    EuRoC tree with its ground truth, EUROC_REPEATS repeats: each run logs
    every frame, its ATE is finite and its trajectories are renamed. Runs
    in a process of its own beside the out-and-back runs: its times are not
    clean timings (``python3 scripts/torch_profile_frame.py`` alone gives
    those). Adds its kernels' launches to `total`."""
    import dataset_np as dnp
    import torch_euroc_bench
    import torch_profile_frame
    klt.LAUNCHES = lk.LAUNCHES = 0
    out = torch_profile_frame.main(["--frames", str(CHUNK_FRAMES)], frames=seq)
    m = out["per_frame_mean_ms"]
    log(f"[tools] torch_profile_frame over {out['frames']} frames "
        f"({out['frame_steps']} steps), mean per real frame: "
        + ", ".join(f"{k} {v:.4f}" for k, v in m.items())
        + f" ms; gate open on {out['gate_open_share']:.3f} of the frames, "
        f"the filter's RANSAC {out['essential_ransac_ms_when_open']} ms "
        f"when open; "
        f"{out['profile_s']:.1f} s")
    assert out["frame_steps"] == CHUNK_FRAMES - 1, out["frame_steps"]
    assert all(v is not None and np.isfinite(v) and v >= 0
               for v in m.values()), m
    assert 0.0 <= out["gate_open_share"] <= 1.0, out["gate_open_share"]
    assert smi_line() in out["backend"], out["backend"]

    data = root / "euroc"
    L, R, gt = (x[:EUROC_FRAMES] for x in hard)
    stamps = cli.write_dataset(str(data / EUROC_SEQ), L, R)
    dnp.write_euroc_groundtruth(str(data / EUROC_SEQ), stamps, gt)
    cli.write_params(str(data / "params.yaml"), realtime=0)
    out_dir = root / "euroc_out"
    runs = torch_euroc_bench.main([
        "--data-root", str(data), "--preset", str(data / "params.yaml"),
        "--sequences", EUROC_SEQ, "--repeats", str(EUROC_REPEATS),
        "--out", str(out_dir)])
    log(f"[tools] torch_euroc_bench, {EUROC_REPEATS} runs of {EUROC_FRAMES} "
        f"frames: ATE {[r['ate_rmse_m'] for r in runs]} m, "
        f"{[round(r['fps'], 2) for r in runs]} fps")
    assert len(runs) == EUROC_REPEATS, runs
    for i, r in enumerate(runs):
        assert r["ate_rmse_m"] is not None and np.isfinite(r["ate_rmse_m"]), r
        assert r["rows"] == EUROC_FRAMES, r
        assert (out_dir / f"ov2slam_traj_{EUROC_SEQ}_{i}.txt").exists(), r
        assert (out_dir / f"ov2slam_kfs_traj_{EUROC_SEQ}_{i}.txt").exists(), r
        assert not (out_dir / f"{EUROC_SEQ}_{i}" / "ov2slam_traj.txt").exists()
    total["klt_track"] += klt.LAUNCHES
    total["lk_iterate"] += lk.LAUNCHES


def check_tier_rows(tier_rows: dict):
    """16 (b). The latency fields of phase 9's tier rows (read; the tiers
    do not run again): finite, p50 <= p90 <= p99 <= max, every frame
    tracked, every call steady (no tier there is longer than the
    warm-up)."""
    for name, row in tier_rows.items():
        vals = {k: row[k] for k in LATENCY_KEYS}
        split = {k: row[k] for k in row if k.startswith(("frame_ms_kf",
                                                         "frame_ms_cruise"))}
        log(f"[tools] {name} row: {vals}; keyframe / cruise calls {split}; "
            f"pose lag {row['pose_lag_frames']} frames")
        assert all(np.isfinite(v) for v in vals.values()), vals
        assert (row["frame_ms_p50"] <= row["frame_ms_p90"]
                <= row["frame_ms_p99"] <= row["frame_ms_max"]), vals
        assert row["tracked_pct"] == 100.0, vals
        assert row["steady_calls"] == row["frames"] <= tiers.WARMUP_FRAMES, row


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
    ap.add_argument("--tier-run", choices=("accurate_stereo", "rigs", MONO_LC,
                                           "tools"),
                    help="run phase 15 (b) or (c) alone over the frames "
                         "saved in --frames-dir (the smoke starts them "
                         "itself)")
    ap.add_argument("--frames-dir", type=Path)
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
    if args.tier_run:
        return tier_child(args.tier_run, args.frames_dir)
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
    _build.build(["lk_iterate", "klt_track", "launch_floor"])
    lk._kernel_fn()
    klt._kernel_fn()
    log(f"[build] {time.perf_counter() - t0:.1f} s for the three libraries "
        f"(one nvcc each, in parallel)")
    ptxas = {}
    for name in ("lk_iterate", "klt_track"):
        log(f"[build] {name}.cu: {_build.BUILD_SECONDS.get(name, 0.0):.1f} s nvcc")
        for line in _build.BUILD_LOG.get(name, "").splitlines():
            if "Used" in line or "spill" in line or "smem" in line:
                log(f"[build] {name}: {line.strip()}")
        ptxas[name] = _build.ptxas_summary(_build.BUILD_LOG.get(name, ""))
    klt_build = klt_ptxas(ptxas["klt_track"])
    lk_build = lk_ptxas(ptxas["lk_iterate"])
    log(f"[build] klt_track ptxas: {json.dumps(klt_build)}")
    log(f"[build] lk_iterate ptxas: {json.dumps(lk_build)}")

    phase_done("build")
    lk_worst, lk_times, lk_chain_row = phase_kernel(dev)
    fl, fr, _ = syn.render_sequence(n_frames=4, step=0.05)
    klt_worst, klt_times, klt_chain_row = phase_klt(dev, (fl, fr))
    phase_done("kernels")
    phase_ransac(dev)
    phase_triangulation(dev)
    phase_clahe(dev, fl[0])
    # the synthetic sequence: the slice takes its first N_FRAMES frames, the
    # chunk phase all of them (bench.py's surface)
    t0 = time.perf_counter()
    seq = tiers.synthetic_sequence(CHUNK_FRAMES)
    assert tiers.KF2F_STEP == STEP and tiers.KF2F_YAW == YAW
    log(f"[render] {CHUNK_FRAMES} synthetic frames at {syn.W}x{syn.H} in "
        f"{time.perf_counter() - t0:.1f} s")
    captured = {}
    launches, frames = phase_slice(dev, seq, captured)
    mono, mono_frames = phase_mono(dev)
    phase_done("slices")
    loop = {"klt_track": 0, "lk_iterate": 0}
    cli_total = {"klt_track": 0, "lk_iterate": 0}
    chunk = {"klt_track": 0, "lk_iterate": 0}
    bench = {"klt_track": 0, "lk_iterate": 0}
    sharded_total = {"klt_track": 0, "lk_iterate": 0}
    with tempfile.TemporaryDirectory() as tmp:
        root = save_frames(hard_all, Path(tmp), seq)
        # the loop tier (11) in a process of its own beside phases 9 and
        # 10, whose host times it therefore shares, and waited for before
        # 12, so that 12-14 (b) run alone as in PRs 7-9; 15 (c) in another
        # process beside 15 (a); then the out-and-back runs, 15 (b) and 16
        # (a, c), processes too, beside 13 (c) and 14 (c)
        procs = start_tier_run("accurate_stereo", root)
        try:
            presets, preset_rows = phase_tiers(
                "presets", dev, PRESET_TIERS, hard, captured=captured)
            rect, rect_rows = phase_tiers("rect", dev, RECT_TIERS, hard)
            phase_done("preset and rect tiers")
            finish_loop_runs(procs, loop)
            procs = []
            phase_done("loop tier (beside 9 and 10)")
            with tempfile.TemporaryDirectory() as cli_tmp:
                cli_root = Path(cli_tmp)
                stamps = phase_cli(cli_total, hard, cli_root)
                phase_done("cli")
                graph_launches = phase_chunk(dev, chunk, seq, cli_root, stamps,
                                             hard[2][:CLI_FRAMES])
            phase_done("chunk (a), (b)")
            phase_sharded(dev, captured)
            phase_done("sharded (a), (b)")
            procs += start_tier_run(MONO_LC, root)
            graph_launches += phase_bench(dev, bench, seq)
            phase_done("bench (a)")
            procs += (start_loop_runs() + start_tier_run("rigs", root)
                      + start_tier_run("tools", root))
            phase_repeat(dev, chunk, hard)
            phase_done("chunk (c)")
            phase_sharded_tier(dev, sharded_total, hard,
                               rect_rows["accurate_stereo_rect"]["ate"])
            phase_done("sharded (c)")
        finally:
            last = finish_loop_runs(procs, loop)
        kitti = last["rigs"]["kitti_klt"]
    check_tier_rows(preset_rows)
    phase_done("out-and-back runs, rigs (b), mono lc (c), tools")
    launches = {k: launches[k] + mono[k] + presets[k] + rect[k] + loop[k]
                + cli_total[k] + chunk[k] + sharded_total[k] + bench[k]
                for k in launches}
    if args.profile:
        phase_compare(dev, frames)
        phase_profile(dev, frames, mono_frames, args.profile, hard)

    planes = {}
    for dt in KLT_DTYPES:
        k_ms, p_ms, b_ms, b_by, turns = klt_times[("temporal", dt)]
        s_ms, _, s_b, s_by, _ = klt_times[("stereo", dt)]
        kitti_dp, kitti_ms, kitti_b, kitti_by = kitti[dtype_name(dt)]
        log(f"[rigs] klt_track on {dtype_name(dt)} planes: N=192 on the "
            f"EuRoC rig {k_ms:.5f} ms (bound {b_ms:.6f} ms by {b_by}); at "
            f"N={KITTI_KLT_N} on the KITTI rig {kitti_ms:.5f} ms (bound "
            f"{kitti_b:.6f} ms by {kitti_by})")
        planes[dtype_name(dt)] = dict(
            ms=k_ms, ms_turns=turns, plain_ms=p_ms, bound_ms=b_ms,
            bound_by=b_by, max_abs_err=max(klt_worst[dt], kitti_dp),
            stereo_ms=s_ms, stereo_bound_ms=s_b, stereo_bound_by=s_by,
            kitti_ms=kitti_ms, kitti_bound_ms=kitti_b,
            kitti_bound_by=kitti_by)
    # the main path's planes (the front end's float16) give the row's numbers
    main = planes[dtype_name(KLT_DTYPES[0])]
    lk_ms, lp_ms, lb_ms, lb_by = lk_times[(192, 10)]
    log(smi)
    print(json.dumps({"kernels": [
        {"name": "klt_track", "route": "cuda",
         "source": "ov2slam_tpu_torch/csrc/klt_track.cu",
         "replaces": "ov2slam_tpu/ops/pallas_lk.py:175",
         "launches": launches["klt_track"],
         "max_abs_err": main["max_abs_err"],
         "ms": main["ms"], "plain_ms": main["plain_ms"],
         "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
         "library_ms": None, "graph_replay_launches": graph_launches,
         "planes": planes, "ptxas": klt_build,
         "chain_n1": {k: klt_chain_row[k] for k in (
             "iters", "us", "steps", "slope_us", "intercept_us")}},
        {"name": "lk_iterate", "route": "cuda",
         "source": "ov2slam_tpu_torch/csrc/lk_iterate.cu",
         "replaces": "ov2slam_tpu/ops/pallas_lk.py:175",
         "launches": launches["lk_iterate"], "max_abs_err": lk_worst,
         "ms": lk_ms, "plain_ms": lp_ms, "bound_ms": lb_ms, "bound_by": lb_by,
         "library_ms": None, "ptxas": lk_build,
         "chain_n1": {k: lk_chain_row[k] for k in (
             "iters", "us", "steps", "slope_us", "intercept_us",
             "launch_floor_us")}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
