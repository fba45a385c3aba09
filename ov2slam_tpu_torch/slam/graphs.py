"""The frame step as CUDA graphs: the card's counterpart of the JAX
package's ``lax.scan`` over the frame step (``frontend.frame_chunk_step``),
which has no module of its own there.

A frame step issues some nine thousand small device operations, and eager
PyTorch pays the host's launch cost for each (the device idles ~94% of a
frame). Here the step is captured once with ``torch.cuda.graph`` and then
replayed per frame. It is split where the host must decide: graph A runs
preprocessing, the motion model, the fused KLT and the parallax gate's
predicate; the host reads the gate (``frontend.gate_open``, the step's one
host sync, as in the per-frame path); graph B, the epipolar filter's
5-point RANSAC, replays only when the gate is open; graph C runs PnP, the
velocity update and the stats, and ends by writing the new state into the
static input buffers, so the next replay starts from it. Without
``do_epipolar`` A and C are one graph. The RANSAC's samples are drawn only
when the gate is open, on both paths, so a frame tracked through the graphs
equals the same frame through ``frontend.frame_step``.

What a replay needs, and how it gets it:

* static inputs. A graph replays fixed addresses, so the image, the
  landmark arena (at its capacity) and every ``FEState`` tensor (pyramids,
  gradient pyramids, the keyframe templates when tracking from the
  keyframe, the keypoint table, the poses) live in buffers owned by the
  graphs. ``load`` copies the manager's state into them at the start of
  every chunk (keyframe re-anchoring, pose syncs and BA write-backs replace
  state tensors between chunks), and ``state_out`` hands out copies at the
  end
  (so no later step of the manager can alias a buffer a replay rewrites);
* the kernel's level table. ``klt_track``'s wrapper builds its table of
  plane pointers at capture, from the static pyramids, and the kernel takes
  the table by value: the graph's kernel node keeps it. The wrapper runs
  (and counts its launch) at capture only; each graph records how many
  ``klt_track`` launches it holds (``nodes``) and how often it replayed;
* random draws. The filter's and the P3P start's samples come from the
  system's own CUDA generator (``FEState.gen``); it is registered with the
  graphs that draw, so each replay advances it as the eager draws would;
* no host sync inside a capture (one would abort it), and none between
  frames but the gate's read.

Graphs are captured once per key (image shape, landmark capacity, keypoint
capacity, camera, step flags, keyframe templates or not, the generator)
and reused across chunks. A capture or replay that fails raises: nothing
falls back to the eager step on the card.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import torch

from ov2slam_tpu_torch.ops import klt as klt_mod
from ov2slam_tpu_torch.slam import frontend as fe
from ov2slam_tpu_torch.slam.frame import FrameKps

# FEState fields a frame step rewrites (the keyframe rotation, the keyframe
# templates and the generator stay as they were)
_STEPPED = ("pyr", "gx", "gy", "kps", "R_cw", "t_cw", "R_vel", "t_vel",
            "has_vel")
_KF = ("kf_pyr", "kf_gx", "kf_gy")


def _fields(state: fe.FEState, names) -> Tuple[torch.Tensor, ...]:
    """The tensors of the named state fields, flattened."""
    out = []
    for name in names:
        v = getattr(state, name)
        out.extend(v if isinstance(v, (tuple, list)) else [v])
    return tuple(out)


def _copy_into(dst, src):
    for d, s in zip(dst, src):
        if d is not s:
            d.copy_(s)


def _clone_state(state: fe.FEState, use_kf: bool) -> fe.FEState:
    c = lambda seq: tuple(a.clone() for a in seq)  # noqa: E731
    kf = ({k: c(getattr(state, k)) for k in _KF} if use_kf
          else dict(kf_pyr=None, kf_gx=None, kf_gy=None))
    return state._replace(
        pyr=c(state.pyr), gx=c(state.gx), gy=c(state.gy),
        kps=FrameKps(*c(state.kps)), R_cw=state.R_cw.clone(),
        t_cw=state.t_cw.clone(), R_vel=state.R_vel.clone(),
        t_vel=state.t_vel.clone(), has_vel=state.has_vel.clone(),
        R_kf=state.R_kf.clone(), **kf)


class FrameGraphs:
    """The captured graphs of one key, with their static buffers."""

    def __init__(self, state: fe.FEState, img: torch.Tensor,
                 lm_pos: torch.Tensor, lm_is3d: torch.Tensor, cam, kw: dict,
                 use_kf: bool):
        self.kw = kw
        self.use_kf = use_kf
        self.state = _clone_state(state, use_kf)
        self.img = img.clone()
        self.lm_pos, self.lm_is3d = lm_pos.clone(), lm_is3d.clone()
        self.cam = cam
        self.epipolar = bool(kw.get("do_epipolar"))
        self.nodes: Dict[str, int] = {}     # klt_track launches per graph
        self.replays: Dict[str, int] = {}
        t0 = time.perf_counter()
        self._warm_up()
        self._capture()
        # host seconds of the warm-up and the captures
        self.capture_s = time.perf_counter() - t0

    # the three parts of frame_step on the static buffers
    def _front(self) -> fe.StepFront:
        return fe.step_front(self.state, self.img, self.lm_pos, self.lm_is3d,
                             self.cam, **self.kw)

    def _filter(self, front: fe.StepFront, gen) -> torch.Tensor:
        return fe.step_filter(front, gen, self.cam, **self.kw)

    def _back(self, front: fe.StepFront, state: fe.FEState):
        return fe.step_back(state, front, self.cam, **self.kw)

    def _warm_up(self):
        """One eager run of every part on a side stream (the gate taken as
        open, the draws from a generator of its own, the results dropped),
        so that what is made at first use (the kernel's library, cuBLAS
        and cuSOLVER handles, the 5-point solver's tables) exists before
        any capture."""
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            gen = torch.Generator(device=self.img.device)
            gen.manual_seed(0)
            front = self._front()
            if self.epipolar:
                self._filter(front, gen)
            self._back(front, self.state._replace(gen=gen))
        torch.cuda.current_stream().wait_stream(s)
        torch.cuda.synchronize()

    def _graph(self, draws: bool) -> torch.cuda.CUDAGraph:
        g = torch.cuda.CUDAGraph()
        if draws:
            g.register_generator_state(self.state.gen)
        return g

    def _capture(self):
        kw = self.kw
        dop3p = bool(kw.get("dop3p"))
        stepped = _fields(self.state, _STEPPED)
        before = klt_mod.LAUNCHES

        def back(front):
            new_state, stats = self._back(front, self.state)
            _copy_into(stepped, _fields(new_state, _STEPPED))
            return stats

        if not self.epipolar:
            self.g_front = None
            self.g_back = self._graph(dop3p)
            with torch.cuda.graph(self.g_back):
                self.stats = back(self._front())
            self.nodes["back"] = klt_mod.LAUNCHES - before
        else:
            self.g_front = self._graph(False)
            with torch.cuda.graph(self.g_front):
                front = self._front()
                tr = front.tracked
                # the filter's output lands in a buffer of this graph
                front = front._replace(tracked=tr._replace(
                    kps=tr.kps._replace(valid=tr.kps.valid.clone())))
            self.front = front
            self.nodes["front"] = klt_mod.LAUNCHES - before
            self.g_filter = self._graph(True)
            with torch.cuda.graph(self.g_filter):
                front.tracked.kps.valid.copy_(
                    self._filter(front, self.state.gen))
            self.g_back = self._graph(dop3p)
            with torch.cuda.graph(self.g_back):
                self.stats = back(front)

    def load(self, state: fe.FEState, lm_pos: torch.Tensor,
             lm_is3d: torch.Tensor):
        """Copy the manager's state and landmark arena into the buffers."""
        names = _STEPPED + ("R_kf",) + (_KF if self.use_kf else ())
        _copy_into(_fields(self.state, names), _fields(state, names))
        self.lm_pos.copy_(lm_pos)
        self.lm_is3d.copy_(lm_is3d)

    def step(self, img: torch.Tensor) -> torch.Tensor:
        """One frame from the buffers' state: its (12,) stats (a buffer the
        next step rewrites); the state advances in place."""
        self.img.copy_(img)
        if self.g_front is not None:
            self.g_front.replay()
            self._count("front")
            if fe.gate_open(self.front.tracked.gate):
                self.g_filter.replay()
                self._count("filter")
        self.g_back.replay()
        self._count("back")
        return self.stats

    def _count(self, name: str):
        self.replays[name] = self.replays.get(name, 0) + 1

    def graph_launches(self) -> int:
        """klt_track launches made by replays so far."""
        return sum(n * self.replays.get(k, 0) for k, n in self.nodes.items())

    def state_out(self, state: fe.FEState) -> fe.FEState:
        """The stepped state (copies of the buffers), with `state`'s fields
        that a step leaves as they were."""
        st = self.state
        c = lambda seq: tuple(a.clone() for a in seq)  # noqa: E731
        return state._replace(
            pyr=c(st.pyr), gx=c(st.gx), gy=c(st.gy), kps=FrameKps(*c(st.kps)),
            R_cw=st.R_cw.clone(), t_cw=st.t_cw.clone(),
            R_vel=st.R_vel.clone(), t_vel=st.t_vel.clone(),
            has_vel=st.has_vel.clone())


class StepGraphs:
    """The frame step's graphs of one system, by key; captured at first
    use, reused by every later chunk with the same key."""

    def __init__(self):
        self.graphs: Dict[tuple, FrameGraphs] = {}
        self.last: Optional[FrameGraphs] = None

    @staticmethod
    def key(state: fe.FEState, img, lm_pos, cam, kw: dict, use_kf: bool):
        return (tuple(img.shape), tuple(lm_pos.shape), state.kps.cap, cam,
                tuple(sorted(kw.items())), use_kf, id(state.gen))

    def get(self, state, img, lm_pos, lm_is3d, cam, kw) -> FrameGraphs:
        use_kf = bool(kw.get("track_from_kf")) and state.kf_pyr is not None
        k = self.key(state, img, lm_pos, cam, kw, use_kf)
        if k not in self.graphs:
            self.graphs[k] = FrameGraphs(state, img, lm_pos, lm_is3d, cam, kw,
                                         use_kf)
        self.last = self.graphs[k]
        return self.last

    def run(self, state: fe.FEState, imgs_u8: torch.Tensor,
            lm_pos: torch.Tensor, lm_is3d: torch.Tensor, cam, kw: dict):
        """frame_chunk_step on the card: (new_state, stats (N, 12))."""
        g = self.get(state, imgs_u8[0], lm_pos, lm_is3d, cam, kw)
        g.load(state, lm_pos, lm_is3d)
        stats = torch.empty((imgs_u8.shape[0], 12), dtype=torch.float32,
                            device=imgs_u8.device)
        for j in range(imgs_u8.shape[0]):
            stats[j].copy_(g.step(imgs_u8[j]))
        return g.state_out(state), stats
