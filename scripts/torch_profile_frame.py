"""Per-stage device time of the port's frame step on each real frame of
bench.py's surface: the counterpart of ``scripts/profile_frame.py``.

    python3 scripts/torch_profile_frame.py [--frames N] [--device cuda|cpu]
        [--out FILE]

It runs the bench surface once (``scripts/torch_bench.py``'s settings:
``tests/synthetic_np.py``'s sequence at 752x480, ``slam_params_dict()``,
``force_realtime`` 1, frame by frame from a new system) and records what
every call of the front end's frame step started from: the state, the
image, the landmark arena and the generator's state. Then it replays each
recorded frame alone and times its stages:

* ``preprocess``: ``frontend.preprocess`` (the float32 pyramid);
* ``grad_pyrs``: the Scharr gradient pyramids and the float16 storage cast
  of the pyramids (``frontend.cast_pyr``);
* ``fb_klt``: the frame's ``fb_klt_tracking`` call (one ``klt_track``
  launch on float16 planes), its arguments recorded from an eager
  ``step_front``;
* ``parallax_gate``: ``frontend.parallax_gate`` on that step's keypoints;
* the frame step as the CUDA graphs of ``slam/graphs.py`` (one capture; each
  recorded state loaded into its buffers): ``front`` (graph A: the stages
  above and the motion model), ``essential_ransac`` (graph B, the epipolar
  filter's 5-point RANSAC, on frames whose gate opened) and ``pnp`` (graph
  C: PnP, the velocity update, the stats and the state write-back), and
  ``frame_step_graph`` from A's start to C's end (the gate's read
  included);
* ``frame_step_eager``: ``frontend.frame_step`` as the system runs it.

On the card each stage but the eager step is timed as a CUDA graph, with
CUDA events (the device time, without the host's launches); the eager step
by CUDA events around it (the host issues its work, so that is its wall
time). On the CPU every stage runs eagerly by host clock. The JSON line
holds the mean per real frame of each stage (``essential_ransac`` counts 0
on a frame whose gate stayed shut), the gate-open share, the RANSAC's mean
over the frames whose gate opened, and the card's ``nvidia-smi`` name and
power limit.
``scripts/profile_frame.py``'s XLA cost analysis has no counterpart here:
``chip_smoke.klt_bound`` gives the KLT's bytes and operations.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests"), str(ROOT / "scripts")]

FRAME_DT = 0.05
REPS = 10        # replays of each stage's graph per frame on the card
STAGES = ("preprocess", "grad_pyrs", "fb_klt", "parallax_gate", "front",
          "essential_ransac", "pnp", "frame_step_graph", "frame_step_eager")


class Recorded(NamedTuple):
    """What one frame step started from."""
    state: object              # frontend.FEState
    img: torch.Tensor          # (H, W) uint8 on the system's device
    lm_pos: torch.Tensor
    lm_is3d: torch.Tensor
    gen_state: torch.Tensor    # the state's generator before the step


def record_run(slam, fl, fr) -> list:
    """Drive `slam` over the frames (then flush) and return a Recorded per
    call of its frame step."""
    rec = []
    step = slam._frame_step

    def recording(img):
        lm_pos, lm_is3d = slam.map.device_landmarks()
        st = slam.fe_state
        rec.append(Recorded(st, img, lm_pos, lm_is3d, st.gen.get_state()))
        return step(img)

    slam._frame_step = recording
    try:
        for j in range(len(fl)):
            slam.process_stereo(fl[j], fr[j], j * FRAME_DT)
        slam.flush()
    finally:
        del slam._frame_step
    return rec


def recording_klt(calls: list):
    """klt.fb_klt_tracking that keeps its arguments in `calls`."""
    from ov2slam_tpu_torch.ops import klt
    real = klt.fb_klt_tracking

    def fn(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)
    return real, fn


def front_of(r: Recorded, cam, kw: dict):
    """An eager step_front of the recorded frame: (front, the KLT call's
    arguments and keywords)."""
    from ov2slam_tpu_torch.ops import klt
    from ov2slam_tpu_torch.slam import frontend as fe
    calls = []
    real, klt.fb_klt_tracking = recording_klt(calls)
    try:
        front = fe.step_front(r.state, r.img, r.lm_pos, r.lm_is3d, cam, **kw)
    finally:
        klt.fb_klt_tracking = real
    return front, calls[0]


def stage_fns(r: Recorded, front, klt_call, cam, kw: dict) -> dict:
    """The frame's stages that run alone: name -> function."""
    from ov2slam_tpu_torch.ops import klt
    from ov2slam_tpu_torch.slam import frontend as fe
    levels, uc, cc = kw["levels"], kw["use_clahe"], kw["clahe_clip"]
    pyr = fe.preprocess(r.img, levels, uc, cc)
    use_kf = bool(kw.get("track_from_kf")) and r.state.kf_pyr is not None
    R_ref = r.state.R_kf if use_kf else r.state.R_cw
    tr = front.tracked
    return {
        "preprocess": lambda: fe.preprocess(r.img, levels, uc, cc),
        "grad_pyrs": lambda: (fe.cast_pyr(pyr),
                              *(fe.cast_pyr(g) for g in fe._grad_pyrs(pyr))),
        "fb_klt": lambda: klt.fb_klt_tracking(*klt_call[0], **klt_call[1]),
        "parallax_gate": lambda: fe.parallax_gate(
            tr.kps, tr.prev_bv, tr.n_tracked, front.R_prior, R_ref, cam,
            kw["fransac_err"])}


def eager_step(r: Recorded, cam, kw: dict):
    """frontend.frame_step from the recorded state and generator state."""
    from ov2slam_tpu_torch.slam import frontend as fe
    r.state.gen.set_state(r.gen_state)
    return fe.frame_step(r.state, r.img, r.lm_pos, r.lm_is3d, cam, **kw)


def profile_cpu(rec: list, cam, kw: dict) -> list:
    """Each recorded frame's stages by host clock, eagerly: a dict of ms
    per frame (and "gate_open")."""
    from ov2slam_tpu_torch.ops import mvg
    from ov2slam_tpu_torch.slam import frontend as fe

    def ms(fn):
        t0 = time.perf_counter()
        out = fn()
        return 1e3 * (time.perf_counter() - t0), out

    rows = []
    for r in rec:
        t_front, (front, klt_call) = ms(lambda: front_of(r, cam, kw))
        row = {k: ms(f)[0] for k, f in stage_fns(r, front, klt_call, cam,
                                                  kw).items()}
        row["front"] = t_front
        tr = front.tracked
        is_open = tr.gate is not None and fe.gate_open(tr.gate)
        row["gate_open"] = is_open
        row["essential_ransac"] = 0.0
        if is_open:
            r.state.gen.set_state(r.gen_state)
            idx = mvg.draw_samples(tr.kps.valid, kw["n_ransac_hyps"], 5,
                                   r.state.gen)
            row["essential_ransac"] = ms(lambda: fe.epipolar_filter(
                tr, cam, idx, kw["fransac_err"]))[0]
        row["pnp"] = ms(lambda: fe.step_back(r.state, front, cam, **kw))[0]
        row["frame_step_eager"] = ms(lambda: eager_step(r, cam, kw))[0]
        row["frame_step_graph"] = None
        rows.append(row)
    return rows


def profile_cuda(rec: list, cam, kw: dict) -> list:
    """Each recorded frame's stages on the card: the stages alone as CUDA
    graphs (REPS calls each), the frame step as the graphs of
    ``slam/graphs.py`` with each recorded state loaded, the eager step by
    CUDA events."""
    import chip_smoke as cs
    from ov2slam_tpu_torch.slam import frontend as fe
    from ov2slam_tpu_torch.slam import graphs
    r0 = rec[0]
    use_kf = bool(kw.get("track_from_kf")) and r0.state.kf_pyr is not None
    g = graphs.FrameGraphs(r0.state, r0.img, r0.lm_pos, r0.lm_is3d, cam, kw,
                           use_kf)
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    rows = []
    for r in rec:
        front, klt_call = front_of(r, cam, kw)
        row = {k: cs.graph_ms(f, REPS) for k, f in
               stage_fns(r, front, klt_call, cam, kw).items()}
        # the frame step's graphs from this frame's state
        g.load(r.state, r.lm_pos, r.lm_is3d)
        g.img.copy_(r.img)
        r.state.gen.set_state(r.gen_state)
        torch.cuda.synchronize()
        # A | the gate's read | B (gate open) | C
        e = [ev() for _ in range(5)]
        e[0].record()
        is_open = False
        if g.g_front is not None:
            g.g_front.replay()
            e[1].record()
            is_open = fe.gate_open(g.front.tracked.gate)
            e[2].record()
            if is_open:
                g.g_filter.replay()
        e[3].record()
        g.g_back.replay()
        e[4].record()
        torch.cuda.synchronize()
        row["front"] = e[0].elapsed_time(e[1]) if g.g_front is not None else None
        row["essential_ransac"] = e[2].elapsed_time(e[3]) if is_open else 0.0
        row["pnp"] = e[3].elapsed_time(e[4])
        row["frame_step_graph"] = e[0].elapsed_time(e[4])
        row["gate_open"] = is_open
        e0, e1 = ev(), ev()
        e0.record()
        eager_step(r, cam, kw)
        e1.record()
        torch.cuda.synchronize()
        row["frame_step_eager"] = e0.elapsed_time(e1)
        rows.append(row)
    return rows


def summarize(rows: list) -> dict:
    """Means per real frame, the gate-open share and the RANSAC's mean
    over the frames whose gate opened."""
    mean = {}
    for k in STAGES:
        vals = [row[k] for row in rows if row[k] is not None]
        mean[k] = float(np.mean(vals)) if vals else None
    opened = [row["essential_ransac"] for row in rows if row["gate_open"]]
    return dict(per_frame_mean_ms=mean,
                gate_open_share=len(opened) / max(len(rows), 1),
                essential_ransac_ms_when_open=(float(np.mean(opened))
                                               if opened else None))


def main(argv=None, frames=None) -> dict:
    """Run the profile, print its JSON line and return it. `frames`: the
    surface's (left, right, gt poses) if already rendered."""
    import torch_bench
    import torch_preset_tiers as tiers
    from ov2slam_tpu_torch import device as device_mod
    from ov2slam_tpu_torch.slam.manager import SlamSystem
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    ap.add_argument("--out", type=Path, help="also append the line here")
    args = ap.parse_args(argv)
    dev = device_mod.resolve_device(args.device)
    if dev.type == "cuda":
        device_mod.set_precision_policy()
    fl, fr, _ = frames or tiers.synthetic_sequence(args.frames)
    fl, fr = fl[:args.frames], fr[:args.frames]
    slam = SlamSystem(torch_bench.bench_params(), device=dev)
    t0 = time.perf_counter()
    rec = record_run(slam, fl, fr)
    run_s = time.perf_counter() - t0
    kw = slam._step_kwargs()
    t0 = time.perf_counter()
    rows = (profile_cuda if dev.type == "cuda" else profile_cpu)(
        rec, slam.cam_l, kw)
    out = dict(tool="torch_profile_frame", surface="bench.py", frames=len(fl),
               frame_steps=len(rows), backend=torch_bench.backend_name(dev),
               timer=("CUDA events, stages as CUDA graphs"
                      if dev.type == "cuda" else "host clock, eager"),
               run_s=run_s, profile_s=time.perf_counter() - t0,
               **summarize(rows))
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
