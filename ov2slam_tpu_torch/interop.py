"""Carry the JAX package's state across to the port.

Each function takes a JAX-package container (``Camera``, ``FrameKps``,
``FEState``, ``BAProblem``, ``PoseGraphProblem``, ``SE3``, ``MapStore``, or
the landmark arenas) whose fields are array-likes — JAX arrays or numpy — reads every field through
``numpy.asarray``, and returns the port's counterpart as tensors on the
given device (``device=None`` is torch's default, the CPU: this module
feeds the CPU parity tests and, unlike the system's entry points, keeps
that default). Nothing here imports jax: the containers are read by field
name. This system has no weights; this state plays their part, so module
tests start both packages from identical inputs.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ov2slam_tpu_torch.core.camera import Camera
from ov2slam_tpu_torch.core.lie import SE3
from ov2slam_tpu_torch.opt.ba import BAProblem
from ov2slam_tpu_torch.opt.posegraph import PoseGraphProblem
from ov2slam_tpu_torch.opt.residuals import Calib
from ov2slam_tpu_torch.slam.frame import FrameKps
from ov2slam_tpu_torch.slam.frontend import FEState
from ov2slam_tpu_torch.slam.map import KeyframeRecord, MapStore


def tensor(a, device=None, dtype=None) -> torch.Tensor:
    """Array-like -> tensor on `device`; float arrays become float32, integer
    arrays int64 (torch's index type), bools stay bool."""
    x = np.asarray(a)
    if dtype is None:
        if x.dtype == np.bool_:
            dtype = torch.bool
        elif np.issubdtype(x.dtype, np.integer):
            dtype = torch.int64
        else:
            dtype = torch.float32
    if x.dtype == np.uint32:
        x = x.astype(np.int64)
    return torch.as_tensor(np.array(x), device=device).to(dtype)   # a copy


def camera(cam) -> Camera:
    """JAX ``Camera`` -> port ``Camera`` (Python-float calibration)."""
    f = lambda v: float(np.asarray(v, np.float32))  # noqa: E731
    return Camera(
        model=int(cam.model), width=int(cam.width), height=int(cam.height),
        fx=f(cam.fx), fy=f(cam.fy), cx=f(cam.cx), cy=f(cam.cy),
        dist=tuple(float(v) for v in np.asarray(cam.dist, np.float32)),
        roi_x0=f(cam.roi_x0), roi_y0=f(cam.roi_y0),
        roi_x1=f(cam.roi_x1), roi_y1=f(cam.roi_y1))


def calib(c) -> Calib:
    f = lambda v: float(np.asarray(v, np.float32))  # noqa: E731
    return Calib(f(c.fx), f(c.fy), f(c.cx), f(c.cy))


def se3(T, device=None) -> SE3:
    return SE3(tensor(T.R, device), tensor(T.t, device))


def frame_kps(kps, device=None) -> FrameKps:
    return FrameKps(*(tensor(getattr(kps, name), device)
                      for name in FrameKps._fields))


def fe_state(state, device=None, seed: int = 0) -> FEState:
    """JAX ``FEState`` -> port ``FEState``. Pyramids (the keyframe
    templates too, where set) keep their dtype (float16, both packages'
    storage); the PRNG key becomes a seeded generator."""
    lvl = lambda seq: tuple(  # noqa: E731
        torch.as_tensor(np.array(a), device=device) for a in seq)
    dev = torch.device("cpu") if device is None else torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return FEState(
        pyr=lvl(state.pyr), gx=lvl(state.gx), gy=lvl(state.gy),
        kps=frame_kps(state.kps, device),
        R_cw=tensor(state.R_cw, device), t_cw=tensor(state.t_cw, device),
        R_vel=tensor(state.R_vel, device), t_vel=tensor(state.t_vel, device),
        has_vel=tensor(state.has_vel, device, torch.bool),
        R_kf=tensor(state.R_kf, device), gen=gen,
        **{k: lvl(getattr(state, k)) for k in ("kf_pyr", "kf_gx", "kf_gy")
           if getattr(state, k, None) is not None})


def ba_problem(p, device=None) -> BAProblem:
    return BAProblem(
        R=tensor(p.R, device), t=tensor(p.t, device),
        pose_opt=tensor(p.pose_opt, device), Xw=tensor(p.Xw, device),
        anchor=tensor(p.anchor, device), bearing=tensor(p.bearing, device),
        lam=tensor(p.lam, device), lm_valid=tensor(p.lm_valid, device),
        obs_kf=tensor(p.obs_kf, device), obs_lm=tensor(p.obs_lm, device),
        obs_px=tensor(p.obs_px, device), obs_right=tensor(p.obs_right, device),
        obs_valid=tensor(p.obs_valid, device), calib_l=calib(p.calib_l),
        calib_r=calib(p.calib_r), T_rl=se3(p.T_rl, device))


def landmarks(lm_pos, lm_is3d, device=None):
    """Landmark arenas (positions (L, 3), is3d (L,)) -> tensors."""
    return tensor(lm_pos, device), tensor(lm_is3d, device, torch.bool)


def pose_graph_problem(p, device=None) -> PoseGraphProblem:
    return PoseGraphProblem(*(tensor(getattr(p, f), device)
                              for f in PoseGraphProblem._fields))


_MAP_DEVICE_CACHES = ("device", "_dev_pos", "_dev_is3d", "_dev_valid",
                      "_device_dirty")


def map_store(m, device=None) -> MapStore:
    """JAX ``MapStore`` -> port ``MapStore``: a deep copy of its host state
    (landmark arenas, observation sets, free list, keyframe records,
    covisibility); the device mirrors are rebuilt on the port's side."""
    out = MapStore(lm_capacity=m.cap, kf_capacity=m.kf_capacity,
                   device=torch.device("cpu") if device is None else device)
    for k, v in vars(m).items():
        if k not in _MAP_DEVICE_CACHES and k != "keyframes":
            setattr(out, k, copy.deepcopy(v))
    out.keyframes = {k: KeyframeRecord(**{
        f: copy.deepcopy(getattr(rec, f)) for f in vars(rec)})
        for k, rec in m.keyframes.items()}
    out._device_dirty = True
    return out
