"""Whole-image ops: pyramids, blur, gradients, bilinear and bicubic
sampling, the rectification remaps, CLAHE (port of the parts of
``ov2slam_tpu/ops/image.py`` the port uses).

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


def sample_bilinear(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample img (H, W) at float coords xy (..., 2) -> (...,). Coordinates
    are clamped to the image (callers mask separately)."""
    H, W = img.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.000001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.000001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    fx = x - x0.to(x.dtype)
    fy = y - y0.to(y.dtype)
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x1] * fx * (1 - fy)
            + img[y1, x0] * (1 - fx) * fy + img[y1, x1] * fx * fy)


def patch_grid(win: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(win*win, 2) (x, y) offsets of a win x win window centred on 0,
    x fastest."""
    r = (win - 1) / 2.0
    xs = torch.arange(win, dtype=dtype, device=device) - r
    yy, xx = torch.meshgrid(xs, xs, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)


def remap_bilinear(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Full-image remap out[i, j] = img(grid[i, j]) (cv::remap, bilinear);
    grid (H', W', 2) float source pixels."""
    return sample_bilinear(img, grid)


def _cubic_weights(f: torch.Tensor, a: float = -0.75):
    """Keys bicubic weights (cv::INTER_CUBIC, a = -0.75) of the taps at
    offsets -1, 0, 1, 2 from floor(coord); f in [0, 1)."""
    d0, d1, d2, d3 = 1.0 + f, f, 1.0 - f, 2.0 - f
    w0 = a * d0 * d0 * d0 - 5.0 * a * d0 * d0 + 8.0 * a * d0 - 4.0 * a
    w1 = (a + 2.0) * d1 * d1 * d1 - (a + 3.0) * d1 * d1 + 1.0
    w2 = (a + 2.0) * d2 * d2 * d2 - (a + 3.0) * d2 * d2 + 1.0
    w3 = a * d3 * d3 * d3 - 5.0 * a * d3 * d3 + 8.0 * a * d3 - 4.0 * a
    return w0, w1, w2, w3


def sample_bicubic(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bicubic sampling (a = -0.75) at float coords: separable 4x4 taps,
    clamped borders, summed in the JAX package's order."""
    H, W = img.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.000001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.000001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    wx = _cubic_weights(x - x0.to(x.dtype))
    wy = _cubic_weights(y - y0.to(y.dtype))
    out = torch.zeros(x.shape, dtype=img.dtype, device=img.device)
    for i in range(4):
        yi = torch.clamp(y0 + (i - 1), 0, H - 1)
        row = torch.zeros(x.shape, dtype=img.dtype, device=img.device)
        for j in range(4):
            row = row + wx[j] * img[yi, torch.clamp(x0 + (j - 1), 0, W - 1)]
        out = out + wy[i] * row
    return out


def remap_bicubic(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """cv::remap(..., INTER_CUBIC): the rectification and undistortion
    remap of every incoming frame."""
    return sample_bicubic(img, grid)


_CLAHE_TILES = 8      # tiles per side, as cv::createCLAHE's default grid
_CLAHE_BINS = 256


def clahe(img: torch.Tensor, clip_limit: float = 3.0) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization (cv::CLAHE
    semantics: 8 x 8 tiles, clip limit scaled by tile size / 256 bins,
    excess redistributed uniformly, bilinear LUT interpolation between tile
    centres). img (H, W) float32 in [0, 255]; returns the same shape and
    range.

    The image is padded reflect-101 to a whole number of tiles, as OpenCV
    does. The JAX package counts each tile's histogram as a one-hot sum
    (92 M booleans at 752x480); here one ``scatter_add_`` over (tile, bin)
    counts the same integers (``bincount`` would read its input's maximum
    back to the host)."""
    n_t, nbins = _CLAHE_TILES, _CLAHE_BINS
    H, W = img.shape
    th, tw = -(-H // n_t), -(-W // n_t)
    Hp, Wp = th * n_t, tw * n_t
    padded = img
    if Hp > H or Wp > W:
        padded = F.pad(img[None, None], (0, Wp - W, 0, Hp - H),
                       mode="reflect")[0, 0]
    q = torch.clamp(torch.round(padded), 0, nbins - 1).to(torch.int64)
    dev = img.device
    ty_of = torch.arange(Hp, device=dev) // th
    tx_of = torch.arange(Wp, device=dev) // tw
    tile = ty_of[:, None] * n_t + tx_of[None, :]                  # (Hp, Wp)
    flat = (tile * nbins + q).reshape(-1)
    hist = torch.zeros(n_t * n_t * nbins, dtype=torch.int64, device=dev)
    hist = hist.scatter_add_(0, flat, torch.ones_like(flat))
    hist = hist.reshape(n_t * n_t, nbins).to(torch.float32)

    # clip + uniform redistribution (single pass, like OpenCV)
    tile_px = th * tw
    limit = max(clip_limit * tile_px / nbins, 1.0)
    clipped = torch.clamp(hist, max=limit)
    excess = torch.sum(hist - clipped, dim=1, keepdim=True)
    clipped = clipped + excess / nbins
    lut = torch.cumsum(clipped, dim=1) * ((nbins - 1.0) / tile_px)
    lut = lut.reshape(n_t, n_t, nbins)

    # interpolate between the 4 surrounding tile LUTs at every pixel of the
    # image (not of its padding: the result is a whole (H, W) tensor, which
    # the KLT kernel's planes must be)
    q = q[:H, :W]
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    ty = (ys - th / 2.0 + 0.5) / th
    tx = (xs - tw / 2.0 + 0.5) / tw
    ty0 = torch.clamp(torch.floor(ty), 0, n_t - 1).to(torch.int64)
    tx0 = torch.clamp(torch.floor(tx), 0, n_t - 1).to(torch.int64)
    ty1 = torch.clamp(ty0 + 1, 0, n_t - 1)
    tx1 = torch.clamp(tx0 + 1, 0, n_t - 1)
    fy = torch.clamp(ty - ty0.to(torch.float32), 0.0, 1.0)[:, None]
    fx = torch.clamp(tx - tx0.to(torch.float32), 0.0, 1.0)[None, :]

    def lut_at(tyi, txi):
        return lut[tyi[:, None], txi[None, :], q]

    out = (lut_at(ty0, tx0) * (1 - fy) * (1 - fx)
           + lut_at(ty0, tx1) * (1 - fy) * fx
           + lut_at(ty1, tx0) * fy * (1 - fx)
           + lut_at(ty1, tx1) * fy * fx)
    return out
