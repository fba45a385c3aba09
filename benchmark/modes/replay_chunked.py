"""Replay of a recorded stereo sequence through
``SlamSystem.process_stereo_chunk``: the throughput mode a mapping user
runs over a log (the CLI's ``run --chunk N``).

Set-up renders the traffic file's frames on the device from the seed
(``world.py``), copies them to host uint8 arrays, builds the system from
the configuration file and feeds it the warm-up frames (map
initialisation, the frame step's CUDA-graph capture, the first keyframes
and local BAs). The window then continues the same sequence, with no
reset, chunk after chunk until ``seconds`` have passed or the frames run
out; each chunk's uploads are paid inside it, as in a replay. Nothing of
the program is edited: this mode wraps the front end's chunk step at run
time, to keep what the reference judges and what the per-layer metrics
count. A rig that the system rectifies is refused: the reference has no
judge of rectified frames yet.
"""

from __future__ import annotations

import time
import warnings
from typing import List

import numpy as np

import devtrace as trace_mod
import world
from kltbound import klt_bound


def slam_params(cfg: dict, log_timings: bool) -> dict:
    """The system's settings: the preset's, the rig's calibration, the
    configuration's overrides."""
    r = cfg["rig"]
    d = dict(cfg["params"])
    for s in ("l", "r"):
        d.update({f"Camera.model_{'left' if s == 'l' else 'right'}": "pinhole",
                  f"Camera.{'left' if s == 'l' else 'right'}_nwidth": r["W"],
                  f"Camera.{'left' if s == 'l' else 'right'}_nheight": r["H"],
                  f"Camera.fx{s}": r["fx"], f"Camera.fy{s}": r["fy"],
                  f"Camera.cx{s}": r["cx"], f"Camera.cy{s}": r["cy"],
                  f"Camera.k1{s}": r.get("k1", 0.0),
                  f"Camera.k2{s}": r.get("k2", 0.0),
                  f"Camera.p1{s}": 0.0, f"Camera.p2{s}": 0.0})
    d["T_left_right"] = [[1.0, 0.0, 0.0, r["baseline"]], [0.0, 1.0, 0.0, 0.0],
                         [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]]
    d.update(cfg.get("overrides", {}))
    d["log_timings"] = int(log_timings)
    return d


def is_rectified(d: dict) -> bool:
    return bool(d.get("bdo_stereo_rect")) and any(
        abs(d[k]) > 1e-9 for k in ("Camera.k1l", "Camera.k2l", "Camera.k1r",
                                   "Camera.k2r"))


def _clone(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        return type(x)(*[_clone(v) for v in x]) if hasattr(x, "_fields") \
            else tuple(_clone(v) for v in x)
    return x


class ChunkRecorder:
    """Wraps ``frontend.frame_chunk_step``: per window chunk keeps its stats
    (device) and the keypoints before and after it (clones of positions,
    landmark ids and validity); in traced chunks marked for it, a clone of
    the whole input (state, first image, landmark arena) for the bound of
    its first ``klt_track`` call."""

    def __init__(self, fe_mod):
        self.fe_mod = fe_mod
        self.orig = fe_mod.frame_chunk_step
        self.active = False
        self.first = -1
        self.keep_input = False
        self.chunks: List[dict] = []
        self.inputs: List[dict] = []

    def __call__(self, state, imgs, lm_pos, lm_is3d, cam, graphs=None, **kw):
        if not self.active:
            return self.orig(state, imgs, lm_pos, lm_is3d, cam, graphs=graphs, **kw)
        k = state.kps
        pre = (k.px.clone(), k.lmid.clone(), k.valid.clone())
        if self.keep_input:
            self.inputs.append(dict(state=_clone(state), img=imgs[0].clone(),
                                    lm_pos=lm_pos.clone(), lm_is3d=lm_is3d.clone(),
                                    cam=cam, kw=dict(kw), first=self.first))
        new, stats = self.orig(state, imgs, lm_pos, lm_is3d, cam, graphs=graphs, **kw)
        k = new.kps
        self.chunks.append(dict(first=self.first, n=int(imgs.shape[0]),
                                stats=stats, pre=pre,
                                post=(k.px.clone(), k.lmid.clone(), k.valid.clone())))
        return new, stats

    def __enter__(self):
        self.fe_mod.frame_chunk_step = self
        return self

    def __exit__(self, *a):
        self.fe_mod.frame_chunk_step = self.orig


def klt_inputs(fe_mod, klt_mod, inp: dict, step_kwargs: dict):
    """The arguments of the first klt_track call of a chunk: its front step
    replayed eagerly from the chunk's input, the kernel call captured."""
    got = []
    orig = klt_mod.fb_klt_tracking

    def capture(*args, **kw):
        got.append((args, kw))
        return orig(*args, **kw)
    klt_mod.fb_klt_tracking = capture
    try:
        fe_mod.step_front(inp["state"], inp["img"], inp["lm_pos"],
                          inp["lm_is3d"], inp["cam"], **step_kwargs)
    finally:
        klt_mod.fb_klt_tracking = orig
    return got[0]


def run(ctx: dict) -> dict:
    import torch
    from ov2slam_tpu_torch.config import SlamParams
    from ov2slam_tpu_torch.io.profiler import Profiler
    from ov2slam_tpu_torch.ops import klt as klt_mod
    from ov2slam_tpu_torch.slam import frontend as fe_mod
    from ov2slam_tpu_torch.slam.manager import SlamSystem

    cfg, tr = ctx["config"], ctx["traffic"]
    dev = torch.device(ctx["device"])
    cuda = dev.type == "cuda"
    seed, seconds, traced = ctx["seed"], ctx["seconds"], ctx["trace"]
    rig = world.rig_of(cfg["rig"])
    traj, room_cfg = tr["trajectory"], tr["world"]
    n, chunk, warm, rate = tr["frames"], tr["chunk"], tr["warmup_frames"], tr["rate_hz"]

    # -------------------------------------------------------- the frames
    gt = world.loop_poses(n, traj["radius"], traj["step_m"], traj.get("bob", 0.02))
    room = world.RoomWorld(seed, room_cfg["half"], room_cfg["height"],
                           room_cfg["tex_size"], device=dev)
    t_render = time.perf_counter()
    left, right = world.render_sequence(room, rig, gt)
    del room
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # -------------------------------------------------------- the system
    pd = slam_params(cfg, log_timings=bool(traced))
    if is_rectified(pd):
        raise SystemExit("benchmark: rectified rigs are not judged yet")
    t_system = time.perf_counter()
    slam = SlamSystem(SlamParams.from_dict(pd), device=dev)
    for c in ctx.get("controls", ()):
        c(slam)
    prof = Profiler.instance()

    def frames(i):
        return [(left[j], right[j], j / rate) for j in range(i, i + chunk)]

    with ChunkRecorder(fe_mod) as rec:
        i = 0
        warm_s = []
        while i + chunk <= warm:
            t = time.perf_counter()
            slam.process_stereo_chunk(frames(i))
            i += chunk
            warm_s.append(time.perf_counter() - t)
        if cuda:
            torch.cuda.synchronize()
        t_warm_end = time.perf_counter()
        w0 = i
        prof.reset()
        rec.active = True
        sites = []
        trace_from, trace_n = tr["trace_from_chunk"], tr["trace_chunks"]
        klt_n = tr["klt_samples"]
        traced_chunks: List[dict] = []
        tp = {}                        # the profiler and its span, while on

        def trace_on():
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            tp["prof"] = torch.profiler.profile(activities=acts)
            tp["prof"].__enter__()
            tp["span"] = torch.profiler.record_function(trace_mod.WINDOW_SPAN)
            tp["span"].__enter__()

        def trace_off():
            # the profiler's own stop is no part of the window's time
            t = time.perf_counter()
            if cuda:
                torch.cuda.synchronize()
            tp.pop("span").__exit__(None, None, None)
            tp["prof"].__exit__(None, None, None)
            tp["done"] = tp.pop("prof")
            tp["stop_s"] = time.perf_counter() - t

        catcher = warnings.catch_warnings(record=True)
        if traced:
            sites = catcher.__enter__()
            warnings.simplefilter("always")
            if cuda:
                torch.cuda.set_sync_debug_mode("warn")
        chunk_s = []
        t_start = time.perf_counter()
        setup_s = t_start - ctx["t0"]
        k = 0
        try:
            while i + chunk <= n:
                if traced and k == trace_from:
                    trace_on()
                in_trace = "span" in tp
                rec.keep_input = in_trace and k < trace_from + klt_n
                launches = klt_mod.LAUNCHES
                rec.first = i
                t = time.perf_counter()
                slam.process_stereo_chunk(frames(i))
                chunk_s.append(time.perf_counter() - t)
                if in_trace:
                    traced_chunks.append(dict(first=i, eager_klt=klt_mod.LAUNCHES - launches))
                i += chunk
                k += 1
                if in_trace and k == trace_from + trace_n:
                    trace_off()
                if time.perf_counter() - t_start - tp.get("stop_s", 0.0) >= seconds:
                    break
            if cuda:
                torch.cuda.synchronize()
            window_s = time.perf_counter() - t_start - tp.get("stop_s", 0.0)
        finally:
            if "span" in tp:
                trace_off()
            if traced:
                if cuda:
                    torch.cuda.set_sync_debug_mode("default")
                catcher.__exit__(None, None, None)
        rec.active = False
        w1 = i

    peak = torch.cuda.max_memory_allocated() if cuda else 0
    timers = {lab: dict(n=st.n, total_ms=st.n * st.mean)
              for lab, st in prof.timers.items()}
    n_syncs = sum(1 for w in sites
                  if "called a synchronizing CUDA operation" in str(w.message))

    # -------------------------------------------------------- outputs
    stats = np.concatenate([c["stats"].cpu().numpy() for c in rec.chunks])
    lg = slam.logger
    est = np.full((w1, 4, 4), np.nan)
    for t, T in zip(lg.times, lg.poses_wc):
        f = int(round(t * rate))
        if f < w1:
            est[f] = T
    win_kf = sum(1 for t, kf in zip(lg.times, lg.is_kf)
                 if kf and w0 <= int(round(t * rate)) < w1)
    pairs = []
    for c in rec.chunks:
        pre = [a.cpu().numpy() for a in c["pre"]]
        post = [a.cpu().numpy() for a in c["post"]]
        pairs.append(dict(frame_before=c["first"] - 1,
                          frame_after=c["first"] + c["n"] - 1,
                          px_before=pre[0], lmid_before=pre[1], valid_before=pre[2],
                          px_after=post[0], lmid_after=post[1], valid_after=post[2]))
    m = slam.map
    keep = m.lm_valid & m.lm_is3d
    kf_T_cw = {kid: np.asarray(r.T_cw, np.float64) for kid, r in m.keyframes.items()}
    kf_frame = {kid: int(round(r.time * rate)) for kid, r in m.keyframes.items()}
    kf_obs = {kid: (r.px[r.valid & (r.lmid >= 0)].astype(np.float64),
                    r.lmid[r.valid & (r.lmid >= 0)].astype(np.int64))
              for kid, r in m.keyframes.items()}
    record = dict(
        stats=stats, gt_T_wc=gt[:w1], est_T_wc=est, window=(w0, w1), rig=cfg["rig"],
        room=room_cfg, track_pairs=pairs,
        lm_ids=np.nonzero(keep)[0], lm_pos=m.lm_pos[keep].copy(),
        lm_kf=m.lm_anchor[keep].copy(), kf_T_cw=kf_T_cw, kf_frame=kf_frame,
        kf_obs=kf_obs)
    run_info = dict(
        frames=w1 - w0, window_s=window_s, setup_s=setup_s, keyframes=win_kf,
        timers=timers, syncs=n_syncs if traced else None,
        map_capacity=m.cap,
        landmarks=int(keep.sum()),
        setup_parts=dict(before_render=t_render - ctx["t0"],
                         render=t_system - t_render,
                         warm_up=t_warm_end - t_system,
                         warm_chunks=[round(x, 3) for x in warm_s]),
        first_chunks=[round(x, 3) for x in chunk_s[:12]])

    # -------------------------------------------------------- the trace
    device_trace, klt = None, None
    tprof = tp.pop("done", None)
    if tprof is not None:
        t = time.perf_counter()
        device_trace = trace_mod.reduce(tprof)
        run_info["trace_read_s"] = time.perf_counter() - t
        if device_trace is not None:
            device_trace["frames"] = sum(chunk for _ in traced_chunks)
            bounds = []
            kw = slam._step_kwargs()
            for inp in rec.inputs:
                args, kkw = klt_inputs(fe_mod, klt_mod, inp, kw)
                bounds.append((inp["first"], klt_bound(args, kkw)))
            # the kernel of each sampled call, by its place in the trace:
            # a chunk's frames each replay one klt_track, then its
            # keyframe path launches its own
            order, pos = {}, 0
            for c in traced_chunks:
                order[c["first"]] = pos
                pos += chunk + c["eager_klt"]
            ms = device_trace["klt_ms"]
            klt = dict(expected=pos, found=len(ms),
                       bound_ms=[b[1][0] for b in bounds],
                       bound_by=[b[1][1] for b in bounds],
                       kernel_ms=[ms[order[f]] for f, _ in bounds
                                  if f in order and order[f] < len(ms)])
        del tprof
    run_info["trace"] = device_trace
    run_info["klt"] = klt
    failed = int((stats[:, 0] <= 0.5).sum())
    del slam, rec
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return dict(record=record, run=run_info, attempted=w1 - w0, failed=failed,
                memory_peak_bytes=int(peak))
