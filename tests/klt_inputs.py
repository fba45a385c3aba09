"""Seeded inputs of the port's ``fb_klt_tracking`` at the slice's shapes,
made with the port alone (no jax, no OpenCV), for the GPU checks of the KLT
kernel (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Rendered 752x480 frames of ``synthetic_np``, 3-level pyramids (float32, or
float16 as the front end stores them: built and differentiated in float32,
then cast), and
the corners a 45 px grid detector finds on the first frame: the best corner
of each of the 160 cells, then the second best, cut to N (the slice's
``kp_cap`` is 192). Other rigs' frames (the KITTI rig's 1241x376 of
``hard_synthetic_np``) take their preset's level count and grid cell.
"""

from __future__ import annotations

import numpy as np
import torch

from ov2slam_tpu_torch.ops import detect
from ov2slam_tpu_torch.ops import image as im

NLEVELS, CELL = 3, 45


def klt_case(frames, N: int, pair: str, jitter: float, device, seed: int = 0,
             nlevels: int = NLEVELS, cell: int = CELL, dtype=torch.float32):
    """frames = (left, right) image lists of synthetic_np.render_sequence
    (or of another rig: pyramids of nlevels + 1 levels, a `cell` px grid).

    pair "temporal" tracks left frame 0 -> 1 with gradient pyramids given
    (the front end's call); "keyframe" tracks left frame 0 -> the last left
    frame the same way (KF-to-frame tracking: the template is a keyframe
    some frames back); "stereo" tracks left -> right of frame 0 without
    them (the mapper's). Priors are the corners plus N(0, jitter) px noise.
    The planes are of `dtype` (corners found on the float32 image).
    Returns the arguments and keywords of fb_klt_tracking."""
    fl, fr = frames
    img0, img1 = {"temporal": (fl[0], fl[1]), "keyframe": (fl[0], fl[-1]),
                  "stereo": (fl[0], fr[0])}[pair]
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    p0 = im.build_pyramid(to(img0), nlevels)
    p1 = im.build_pyramid(to(img1), nlevels)
    det = detect.grid_select(detect.min_eig_response(p0[0]),
                             torch.zeros((1, 2)), torch.zeros(1, dtype=torch.bool),
                             cell, 1e-4)
    pts = torch.cat([det.points, det.points2])[:N]
    valid = torch.cat([det.valid, det.valid2])[:N]
    if pts.shape[0] < N:
        raise ValueError(f"only {pts.shape[0]} corners, {N} asked")
    rng = np.random.default_rng(seed)
    prior = pts + torch.from_numpy(
        rng.normal(0.0, jitter, tuple(pts.shape)).astype(np.float32))
    kw = dict(nlevels=nlevels, win=9)
    if pair != "stereo":
        kw["prev_grad_pyr"] = [tuple(g.to(device, dtype) for g in
                                     im.scharr_gradients(a)) for a in p0]
        kw["next_grad_pyr"] = [tuple(g.to(device, dtype) for g in
                                     im.scharr_gradients(a)) for a in p1]
    args = ([a.to(device, dtype) for a in p0], [a.to(device, dtype) for a in p1],
            pts.contiguous().to(device), prior.contiguous().to(device),
            valid.contiguous().to(device))
    return args, kw
