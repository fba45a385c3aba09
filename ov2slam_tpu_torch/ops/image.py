"""Whole-image ops: pyramids, blur, gradients (port of the parts of
``ov2slam_tpu/ops/image.py`` the slice uses; CLAHE and the remaps are not
ported yet).

Images are float32 (H, W) in [0, 255]. The separable filters keep the JAX
package's shifted-add formulation and its reflect-101 border (OpenCV's
default; ``F.pad(mode="reflect")`` is reflect-101), so both packages sum the
same terms in the same order.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _sep_conv2d(img: torch.Tensor, kx: Sequence[float], ky: Sequence[float]
                ) -> torch.Tensor:
    """Separable 2D cross-correlation (cv::filter2D semantics) with a
    reflect-101 border. img (H, W); kx, ky 1D taps along x (cols), y (rows)."""
    ry, rx = len(ky) // 2, len(kx) // 2
    H, W = img.shape
    p = F.pad(img[None, None], (rx, rx, ry, ry), mode="reflect")[0, 0]
    acc = None
    for i, k in enumerate(ky):
        term = float(k) * p[i:i + H, :]
        acc = term if acc is None else acc + term
    out = None
    for j, k in enumerate(kx):
        term = float(k) * acc[:, j:j + W]
        out = term if out is None else out + term
    return out


GAUSS5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """5-tap Gaussian blur then 2x decimation (cv::pyrDown: out size
    ceil(n/2), samples at even indices)."""
    return _sep_conv2d(img, GAUSS5, GAUSS5)[::2, ::2].contiguous()


def build_pyramid(img: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """[level0=img, level1, ...] with `levels`+1 entries."""
    pyr = [img]
    for _ in range(levels):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def gaussian_kernel(sigma: float, radius: int = None) -> np.ndarray:
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    xs = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, sigma: float, radius: int = None
                  ) -> torch.Tensor:
    k = gaussian_kernel(sigma, radius)
    return _sep_conv2d(img, k, k)


# Scharr 3x3 derivative (the kernel cv::calcOpticalFlowPyrLK uses), 1/32 scaled
_SCHARR_D = np.array([-1.0, 0.0, 1.0], np.float32)
_SCHARR_S = np.array([3.0, 10.0, 3.0], np.float32) / 32.0


def scharr_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Ix, Iy) via the Scharr-smoothed central difference."""
    return (_sep_conv2d(img, _SCHARR_D, _SCHARR_S),
            _sep_conv2d(img, _SCHARR_S, _SCHARR_D))


def sobel_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    d = np.array([-1.0, 0.0, 1.0], np.float32)
    s = np.array([1.0, 2.0, 1.0], np.float32)
    return _sep_conv2d(img, d, s), _sep_conv2d(img, s, d)
