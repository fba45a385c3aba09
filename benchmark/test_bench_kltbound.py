"""The benchmark's copy of the KLT bound arithmetic gives the bytes and
operations that the repository's own (``chip_smoke.klt_bound``) gave on a
fixed case, computed once on the CPU and written here.

The case is of the tracking call's kind: two 752x480 views of the
benchmark's room one frame apart, 4-level pyramids (2x2 means) stored in
float16 with their gradients, 192 points on a grid, seeded priors.

    python -m pytest benchmark/test_bench_kltbound.py -q
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import kltbound  # noqa: E402
import world  # noqa: E402

# chip_smoke.klt_bound(*klt_case()) on this case (CPU, float16 planes)
SOURCE = {"nbytes": 522824, "ops": 19726740, "by": "operations"}


def _pyramid(img: torch.Tensor, levels: int):
    pyr = [img]
    for _ in range(levels):
        a = pyr[-1]
        h, w = a.shape[0] // 2 * 2, a.shape[1] // 2 * 2
        pyr.append(a[:h, :w].reshape(h // 2, 2, w // 2, 2).mean((1, 3)))
    return pyr


def klt_case(n: int = 192, levels: int = 3):
    """(args, kw) of a tracking call on the fixed case."""
    rig = world.Rig(752, 480, 458.0, 458.0, 376.0, 240.0, 0.11, -0.28, 0.07)
    room = world.RoomWorld(seed=7, tex_size=512)
    poses = world.loop_poses(2, 4.5, 0.02, first=40)
    left, _ = world.render_sequence(room, rig, poses, first=40)
    p0 = _pyramid(torch.from_numpy(left[0].astype(np.float32)), levels)
    p1 = _pyramid(torch.from_numpy(left[1].astype(np.float32)), levels)
    g0 = [kltbound.scharr(a) for a in p0]
    g1 = [kltbound.scharr(a) for a in p1]
    ys, xs = np.meshgrid(np.linspace(30, 450, 12), np.linspace(30, 720, 16),
                         indexing="ij")
    pts = torch.tensor(np.stack([xs.ravel(), ys.ravel()], -1)[:n], dtype=torch.float32)
    rng = np.random.default_rng(5)
    prior = pts + torch.tensor(rng.normal(0, 1.5, pts.shape), dtype=torch.float32)
    valid = torch.ones(n, dtype=torch.bool)
    h = torch.float16
    args = ([a.to(h) for a in p0], [a.to(h) for a in p1], pts, prior, valid)
    kw = dict(nlevels=levels, win=9,
              prev_grad_pyr=[(gx.to(h), gy.to(h)) for gx, gy in g0],
              next_grad_pyr=[(gx.to(h), gy.to(h)) for gx, gy in g1])
    return args, kw


def test_klt_bound_matches_the_source():
    torch.set_num_threads(2)
    ms, by, nbytes, ops = kltbound.klt_bound(*klt_case())
    assert (nbytes, ops, by) == (SOURCE["nbytes"], SOURCE["ops"], SOURCE["by"])
    assert ms == max(nbytes / kltbound.HBM_BPS, ops / kltbound.F32_FLOPS) * 1e3
