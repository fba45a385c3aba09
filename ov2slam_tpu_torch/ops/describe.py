"""BRIEF-256 binary descriptors + Hamming distances (port of
``ov2slam_tpu/ops/describe.py``).

Replaces the reference's BriefDescriptorExtractor usage
(feature_extractor.cpp:224-285) and its Hamming matching. The sampling
pattern is the JAX package's numpy draw from the same seed, so both packages
test the same pixel pairs and produce the same bits.

torch has almost no arithmetic on uint32, so the public layout — (N, 8)
words of 32 bits — is carried in int64 (each word's value in [0, 2^32)).
Hamming distances use a SWAR popcount on those words.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ov2slam_tpu_torch.ops import image as im

N_BITS = 256
N_WORDS = N_BITS // 32
PATCH = 31          # sampling window (BRIEF-31)
_SIGMA = PATCH / 5.0
_PSIDE = 34          # extracted patch side: offsets [-16, +17) around the kp
_SSIDE = _PSIDE - 1  # after the fractional shift blend
_CTR = 16            # patch index of the keypoint's integer pixel


@functools.lru_cache()
def brief_pattern(seed: int = 42) -> np.ndarray:
    """(256, 4) float32 [x1, y1, x2, y2] sample-pair offsets, clipped to the
    31x31 window, drawn from the BRIEF paper's G(0, patch^2/25) model."""
    rng = np.random.default_rng(seed)
    lim = PATCH // 2
    pts = rng.normal(0.0, _SIGMA, size=(N_BITS, 4))
    return np.clip(pts, -lim, lim).astype(np.float32)


@functools.lru_cache()
def _brief_select_matrix(seed: int = 42) -> np.ndarray:
    """(33*33, 512) bilinear-sampling matrix: column k (resp. 256+k) pulls
    the first (second) sample of bit k out of a flattened shifted patch."""
    pat = brief_pattern(seed)
    S = np.zeros((_SSIDE * _SSIDE, 2 * N_BITS), np.float32)
    for k in range(N_BITS):
        for c in range(2):
            ox, oy = float(pat[k, 2 * c]), float(pat[k, 2 * c + 1])
            jx, jy = ox + _CTR, oy + _CTR
            x0, y0 = int(np.floor(jx)), int(np.floor(jy))
            fx, fy = jx - x0, jy - y0
            col = c * N_BITS + k
            for dy, wy in ((0, 1.0 - fy), (1, fy)):
                for dx, wx in ((0, 1.0 - fx), (1, fx)):
                    S[(y0 + dy) * _SSIDE + (x0 + dx), col] += wy * wx
    return S


def describe_brief(img: torch.Tensor, kps: torch.Tensor, valid: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed BRIEF descriptors: (desc (N, 8) int64 words, ok (N,) bool).
    ok is False for keypoints without a full window or invalid inputs."""
    H, W = img.shape
    dev = img.device
    smooth = im.gaussian_blur(img, 2.0, radius=4)
    kpi = torch.floor(kps).to(torch.int64)
    kpf = (kps - kpi.to(kps.dtype)).to(smooth.dtype)
    y0 = torch.clamp(kpi[:, 1] - _CTR, 0, H - _PSIDE)
    x0 = torch.clamp(kpi[:, 0] - _CTR, 0, W - _PSIDE)
    ar = torch.arange(_PSIDE, device=dev)
    rows = (y0[:, None] + ar[None, :])[:, :, None]
    cols = (x0[:, None] + ar[None, :])[:, None, :]
    patches = smooth[rows, cols]                     # (N, 34, 34)
    fx = kpf[:, 0][:, None, None]
    fy = kpf[:, 1][:, None, None]
    P = (patches[:, :-1, :-1] * (1 - fy) * (1 - fx)
         + patches[:, :-1, 1:] * (1 - fy) * fx
         + patches[:, 1:, :-1] * fy * (1 - fx)
         + patches[:, 1:, 1:] * fy * fx)             # (N, 33, 33)
    S = torch.from_numpy(_brief_select_matrix()).to(dev)
    samples = P.reshape(P.shape[0], -1) @ S          # (N, 512)
    bits = (samples[:, :N_BITS] < samples[:, N_BITS:]).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    desc = torch.sum(bits.reshape(-1, N_WORDS, 32) << shifts, dim=-1)

    inb = ((kps[:, 0] >= _CTR) & (kps[:, 0] < W - _CTR - 1)
           & (kps[:, 1] >= _CTR) & (kps[:, 1] < H - _CTR - 1))
    return desc, valid & inb


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 holding a 32-bit word (SWAR popcount)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact Hamming distance between packed descriptors (..., 8) (int64
    words, broadcastable) -> (...,) int32."""
    return torch.sum(popcount32(torch.bitwise_xor(a, b)), dim=-1).to(torch.int32)


def hamming_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming: a (N, 8), b (M, 8) -> (N, M) int32."""
    return hamming_dist(a[:, None, :], b[None, :, :])


def knn2_match(desc_a: torch.Tensor, valid_a: torch.Tensor,
               desc_b: torch.Tensor, valid_b: torch.Tensor):
    """Two-best matching a -> b (the knnMatch(k=2) + ratio-test building
    block, loop_closer.cpp:378-459): (best_idx (N,), best_dist (N,),
    second_dist (N,)), int64 indices and int32 distances. Invalid columns
    and rows get the distance N_BITS + 1. Ties go to the first column
    (``torch.argmin`` returns the first minimum, as ``jnp.argmin`` does);
    the second-best distance masks only the best column, so a tie gives
    second == best."""
    BIG = N_BITS + 1
    d = hamming_matrix(desc_a, desc_b)
    d = torch.where(valid_b[None, :], d, torch.full_like(d, BIG))
    best = torch.argmin(d, dim=1)
    bestd = torch.gather(d, 1, best[:, None])[:, 0]
    d2 = d.scatter(1, best[:, None], BIG)
    secondd = torch.amin(d2, dim=1)
    bestd = torch.where(valid_a, bestd, torch.full_like(bestd, BIG))
    return best, bestd, secondd
