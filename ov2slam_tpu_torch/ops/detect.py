"""Keypoint detection: Shi-Tomasi min-eigenvalue response with per-grid-cell
selection (port of the singlescale path of ``ov2slam_tpu/ops/detect.py``;
FAST, Harris and cornerSubPix are not ported yet).

Replaces the reference's detectSingleScale (feature_extractor.cpp:288-440):
one response map over the whole image, the best (and a secondary) peak per
free grid cell, occupancy suppression around existing keypoints, and the
host-side adaptive quality update.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ov2slam_tpu_torch.ops import image as im


def min_eig_response(img: torch.Tensor, gauss_blur: bool = True) -> torch.Tensor:
    """Shi-Tomasi min-eigenvalue response (cv::cornerMinEigenVal,
    blockSize=3, Sobel ksize=3), after a 3x3 Gaussian blur like the reference
    (feature_extractor.cpp:355-356)."""
    if gauss_blur:
        k = np.array([0.25, 0.5, 0.25], np.float32)
        img = im._sep_conv2d(img, k, k)
    ix, iy = im.sobel_gradients(img)
    ix = ix * 0.125
    iy = iy * 0.125
    box = np.ones(3, np.float32) / np.float32(9.0)
    one = np.ones(3, np.float32)
    sxx = im._sep_conv2d(ix * ix, box, one)
    syy = im._sep_conv2d(iy * iy, box, one)
    sxy = im._sep_conv2d(ix * iy, box, one)
    d = (sxx - syy) * 0.5
    return (sxx + syy) * 0.5 - torch.sqrt(d * d + sxy * sxy)


def occupancy_mask(shape: Tuple[int, int], kps: torch.Tensor,
                   kp_valid: torch.Tensor, radius: int) -> torch.Tensor:
    """(H, W) float mask: 0 within `radius` (square, Chebyshev) of a valid
    keypoint, 1 elsewhere (the reference's cv::circle mask,
    feature_extractor.cpp:317-320; the square differs only at corners)."""
    H, W = shape
    r = int(radius)
    ctr = torch.round(kps).to(torch.int64)
    inb = ((ctr[:, 0] >= 0) & (ctr[:, 0] < W) & (ctr[:, 1] >= 0)
           & (ctr[:, 1] < H) & kp_valid)
    # out-of-image seeds land in a spare last slot that is cut away
    lin = torch.where(inb, ctr[:, 1] * W + ctr[:, 0],
                      torch.full_like(ctr[:, 0], H * W))
    seed = torch.zeros(H * W + 1, dtype=torch.float32, device=kps.device)
    seed[lin] = 1.0
    seed = seed[:H * W].reshape(1, 1, H, W)
    if r > 0:
        hit = F.max_pool2d(seed, kernel_size=2 * r + 1, stride=1, padding=r)
    else:
        hit = seed
    return torch.where(hit[0, 0] > 0, 0.0, 1.0)


class GridDetection(NamedTuple):
    points: torch.Tensor      # (C, 2) float px of best response per cell
    scores: torch.Tensor      # (C,)
    valid: torch.Tensor       # (C,) bool — above quality & cell free
    points2: torch.Tensor     # (C, 2) second-best (secondary pool)
    scores2: torch.Tensor     # (C,)
    valid2: torch.Tensor      # (C,) bool


def grid_select(response: torch.Tensor, kps: torch.Tensor,
                kp_valid: torch.Tensor, cellsize: int, quality_th
                ) -> GridDetection:
    """Top-1 + top-2 response per free grid cell (detectSingleScale
    semantics: occupied cells skipped; the second peak lies outside a
    quarter-cell disc of the first)."""
    H, W = response.shape
    cs = int(cellsize)
    nh, nw = H // cs, W // cs
    C = nh * nw
    dev = response.device

    resp = response * occupancy_mask((H, W), kps, kp_valid, cs // 4)

    ci = torch.floor(kps[:, 0] / cs).to(torch.int64)
    ri = torch.floor(kps[:, 1] / cs).to(torch.int64)
    inb = (ci >= 0) & (ci < nw) & (ri >= 0) & (ri < nh) & kp_valid
    cell_lin = torch.where(inb, ri * nw + ci, torch.full_like(ci, C))
    occ = torch.zeros(C + 1, dtype=torch.bool, device=dev)
    occ[cell_lin] = True
    occ = occ[:C]

    cells = resp[:nh * cs, :nw * cs].reshape(nh, cs, nw, cs).permute(0, 2, 1, 3)
    cells = cells.reshape(C, cs * cs)
    idx1 = torch.argmax(cells, dim=1)
    s1 = torch.gather(cells, 1, idx1[:, None])[:, 0]

    y1 = idx1 // cs
    x1 = idx1 % cs
    yy = torch.arange(cs, device=dev)[:, None]
    xx = torch.arange(cs, device=dev)[None, :]
    d2 = (yy[None] - y1[:, None, None]) ** 2 + (xx[None] - x1[:, None, None]) ** 2
    r = cs // 4
    killed = (d2 <= r * r).reshape(C, cs * cs)
    cells2 = torch.where(killed, torch.full_like(cells, -float("inf")), cells)
    idx2 = torch.argmax(cells2, dim=1)
    s2 = torch.gather(cells2, 1, idx2[:, None])[:, 0]

    lin = torch.arange(C, device=dev)
    rows, cols = lin // nw, lin % nw

    def to_px(idx):
        return torch.stack([(cols * cs + idx % cs).to(resp.dtype),
                            (rows * cs + idx // cs).to(resp.dtype)], dim=-1)

    v1 = (~occ) & (s1 >= quality_th)
    v2 = (~occ) & (s2 >= quality_th) & torch.isfinite(s2)
    return GridDetection(to_px(idx1), s1, v1, to_px(idx2), s2, v2)


def adaptive_quality_update(quality: float, nb_detected: int,
                            nb_free_cells: int) -> float:
    """Host-side detector state update (feature_extractor.cpp:421-426):
    <33% of free cells filled => halve quality; >90% => raise by 1.5x."""
    if nb_free_cells <= 0:
        return quality
    if nb_detected < 0.33 * nb_free_cells:
        return quality / 2.0
    if nb_detected > 0.9 * nb_free_cells:
        return quality * 1.5
    return quality
