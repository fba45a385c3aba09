"""Per-frame keypoint state: a fixed-capacity padded table (port of
``ov2slam_tpu/slam/frame.py``).

Replaces the reference's Frame keypoint store (frame.hpp:46-237): a (K,)
padded struct of tensors with validity masks. ``lmid`` doubles as the
landmark's arena slot in the map store; -1 marks an empty slot, so every
gather through it clamps first and masks after.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ov2slam_tpu_torch.core import camera as cam_mod
from ov2slam_tpu_torch.core.camera import Camera


class FrameKps(NamedTuple):
    """Padded keypoint table (capacity K)."""

    px: torch.Tensor        # (K, 2) raw pixel coords
    unpx: torch.Tensor      # (K, 2) undistorted pixel coords
    bv: torch.Tensor        # (K, 3) unit bearing (left cam frame)
    lmid: torch.Tensor      # (K,) int64 — landmark arena slot, -1 = empty
    valid: torch.Tensor     # (K,) bool
    is3d: torch.Tensor      # (K,) bool — landmark has a triangulated position
    rpx: torch.Tensor       # (K, 2) right-cam pixel observation
    has_right: torch.Tensor # (K,) bool
    kf_bv: torch.Tensor     # (K, 3) bearing at the last keyframe
    kf_px: torch.Tensor     # (K, 2) raw pixel coords at the last keyframe

    @property
    def cap(self) -> int:
        return self.px.shape[0]

    @staticmethod
    def empty(cap: int, device=None, dtype=torch.float32) -> "FrameKps":
        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
        b = lambda: torch.zeros(cap, dtype=torch.bool, device=device)  # noqa: E731
        return FrameKps(
            px=z(cap, 2), unpx=z(cap, 2), bv=z(cap, 3),
            lmid=torch.full((cap,), -1, dtype=torch.int64, device=device),
            valid=b(), is3d=b(), rpx=z(cap, 2), has_right=b(),
            kf_bv=z(cap, 3), kf_px=z(cap, 2))


def update_positions(kps: FrameKps, cam: Camera, new_px: torch.Tensor,
                     ok: torch.Tensor) -> FrameKps:
    """After tracking: move keypoints to new_px, drop failures, recompute
    undistorted coords and bearings (frame.cpp updateKeypoint :246-262)."""
    valid = kps.valid & ok & cam_mod.in_image(cam, new_px)
    unpx = cam_mod.undistort_px(cam, new_px)
    bv = cam_mod.bearing_from_undist_px(cam, unpx)
    v = valid[:, None]
    return kps._replace(
        px=torch.where(v, new_px, kps.px),
        unpx=torch.where(v, unpx, kps.unpx),
        bv=torch.where(v, bv, kps.bv),
        valid=valid,
        has_right=torch.zeros_like(kps.has_right))


def insert_keypoints(kps: FrameKps, cam: Camera, new_px: torch.Tensor,
                     new_ok: torch.Tensor, new_lmids: torch.Tensor) -> FrameKps:
    """Place up to M new keypoints into free slots: free slots and accepted
    candidates are both ranked by cumsum; candidate i goes to the i-th free
    slot. Candidates that find no slot are written to a spare row that is
    cut away (JAX's dropped out-of-range scatter)."""
    K = kps.cap
    dev = kps.px.device
    free = ~kps.valid
    free_rank = torch.cumsum(free.to(torch.int64), 0) - 1
    cand_rank = torch.cumsum(new_ok.to(torch.int64), 0) - 1
    n_free = torch.sum(free)

    slot_of_rank = torch.full((K + 1,), K, dtype=torch.int64, device=dev)
    slot_ids = torch.arange(K, dtype=torch.int64, device=dev)
    slot_of_rank[torch.where(free, free_rank, torch.full_like(free_rank, K))] = \
        torch.where(free, slot_ids, torch.full_like(slot_ids, K))
    accept = new_ok & (cand_rank < n_free)
    tgt = torch.where(accept, slot_of_rank[torch.clamp(cand_rank, 0, K)],
                      torch.full_like(cand_rank, K))

    unpx = cam_mod.undistort_px(cam, new_px)
    bv = cam_mod.bearing_from_undist_px(cam, unpx)

    def scat(dest, src):
        ext = torch.cat([dest, dest[:1]])
        ext[tgt] = src.to(dest.dtype)
        return ext[:K]

    return kps._replace(
        px=scat(kps.px, new_px), unpx=scat(kps.unpx, unpx),
        bv=scat(kps.bv, bv), lmid=scat(kps.lmid, new_lmids),
        valid=scat(kps.valid, torch.ones_like(new_ok)),
        is3d=scat(kps.is3d, torch.zeros_like(new_ok)),
        rpx=scat(kps.rpx, torch.zeros_like(new_px)),
        has_right=scat(kps.has_right, torch.zeros_like(new_ok)),
        kf_bv=scat(kps.kf_bv, bv), kf_px=scat(kps.kf_px, new_px))
