"""Keypoint detection: Shi-Tomasi min-eigenvalue and FAST-9 response maps
with per-grid-cell selection and batched sub-pixel refinement (port of
``ov2slam_tpu/ops/detect.py`` without the unused Harris response).

Replaces the reference's FeatureExtractor (feature_extractor.cpp:288-440
detectSingleScale, :443-570 detectGridFAST, :104-221 detectGFTT): one
response map over the whole image, the best (and a secondary) peak per free
grid cell, occupancy suppression around existing keypoints, cornerSubPix,
and the host-side adaptive quality update. All of it is plain PyTorch, as
in the JAX package, where it runs outside any kernel.
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


# the Bresenham circle of radius 3, (dx, dy), clockwise from the top
_FAST_OFFS = ((0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2),
              (1, 3), (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1),
              (-2, -2), (-1, -3))


def fast_score(img: torch.Tensor, threshold: float, arc: int = 9
               ) -> torch.Tensor:
    """FAST-N corner score map (cv::FAST semantics, N = 9 contiguous of
    16): per pixel, the best arc's smallest |ring - centre| minus the
    threshold, 0 for non-corners and the 3-pixel border."""
    H, W = img.shape
    pad = 3
    p = F.pad(img[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]
    ring = torch.stack([p[pad + dy:pad + dy + H, pad + dx:pad + dx + W]
                        for dx, dy in _FAST_OFFS])            # (16, H, W)
    c = img[None]
    db = ring - c

    def contiguous(mask):
        acc = mask
        for s in range(1, arc):
            acc = acc & torch.roll(mask, -s, dims=0)
        return torch.any(acc, dim=0)

    def arc_min(vals):
        acc = vals
        for s in range(1, arc):
            acc = torch.minimum(acc, torch.roll(vals, -s, dims=0))
        return torch.amax(acc, dim=0)

    zero = torch.zeros_like(img)
    is_bright = contiguous(ring > c + threshold)
    is_dark = contiguous(ring < c - threshold)
    score = torch.maximum(
        torch.where(is_bright, arc_min(db) - threshold, zero),
        torch.where(is_dark, arc_min(-db) - threshold, zero))
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    inb = (ys >= pad) & (ys < H - pad) & (xs >= pad) & (xs < W - pad)
    return torch.where(inb, score, zero)


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


def corner_subpix(img: torch.Tensor, pts: torch.Tensor, valid: torch.Tensor,
                  half_win: int = 3, iters: int = 30) -> torch.Tensor:
    """Batched cv::cornerSubPix: `iters` steps of q <- q + G^-1 sum(g g^T
    (p - q)) over a (2 half_win + 1)^2 window of bilinear-sampled Sobel
    gradients, steps clamped to 2 px, invalid points left in place."""
    ix_img, iy_img = im.sobel_gradients(img)
    offs = im.patch_grid(2 * half_win + 1, pts.dtype, pts.device)   # (P, 2)
    ox, oy = offs[None, :, 0], offs[None, :, 1]
    q = pts
    for _ in range(iters):
        coords = q[:, None, :] + offs[None, :, :]
        gx = im.sample_bilinear(ix_img, coords)
        gy = im.sample_bilinear(iy_img, coords)
        gxx = torch.sum(gx * gx, dim=1)
        gxy = torch.sum(gx * gy, dim=1)
        gyy = torch.sum(gy * gy, dim=1)
        bx = torch.sum(gx * gx * ox + gx * gy * oy, dim=1)
        by = torch.sum(gx * gy * ox + gy * gy * oy, dim=1)
        det = gxx * gyy - gxy * gxy
        inv = torch.where(torch.abs(det) > 1e-12, 1.0 / det,
                          torch.zeros_like(det))
        step = torch.stack([(gyy * bx - gxy * by) * inv,
                            (-gxy * bx + gxx * by) * inv], dim=-1)
        step = torch.clamp(step, -2.0, 2.0)
        q = q + torch.where(valid[:, None], step, torch.zeros_like(step))
    return q
