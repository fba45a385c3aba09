"""Dataset readers: EuRoC / KITTI odometry / TartanAir directory layouts
(port of ``ov2slam_tpu/io/datasets.py``).

Replaces the reference's ROS SensorsGrabber (reference: src/ov2slam_node.cpp
:85-149): instead of subscribing to image topics and syncing stereo pairs by
timestamp (+-15 ms), these readers walk the standard on-disk layouts and
yield synchronized (left, right, t) tuples, each image a float32 (H, W)
grey array as the JAX package's ``cv2.imread(..., IMREAD_GRAYSCALE)`` gives.

Images are decoded here, without OpenCV or PIL (the GPU machine has
neither): the chunks are read and checked, the IDAT stream is inflated with
``zlib``, and the per-row filters are undone by ``csrc/png_unfilter.cpp``
(built with ``g++`` at first use, ``ops/_build.build_cxx``; a failed build
raises). ``unfilter_plain`` is the same in numpy, for the tests. Supported:
bit depth 8, non-interlaced, grey (colour type 0), RGB (2) and RGBA (6);
anything else raises naming the file. Colour becomes grey as libpng's
``png_set_rgb_to_gray(png, 1, 0.299, 0.587)``, which OpenCV's PNG decoder
asks for: ``(9797 R + 19234 G + 3737 B) >> 15`` (truncated), a grey pixel
(R = G = B) unchanged, alpha dropped.
"""

from __future__ import annotations

import ctypes
import glob
import os
import struct
import zlib
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ov2slam_tpu_torch.ops import _build

STEREO_SYNC_TOL_S = 0.015   # reference: ov2slam_node.cpp:103-111 (15 ms)

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}     # colour type -> bytes per pixel at depth 8
_GRAY_COEFFS = (9797, 19234, 3737)  # libpng's 15-bit R, G, B weights
_UNFILTER = None


def _unfilter_fn():
    global _UNFILTER
    if _UNFILTER is None:
        lib = ctypes.CDLL(str(_build.build_cxx("png_unfilter")))
        u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.png_unfilter.argtypes = [u8, u8, ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int]
        lib.png_unfilter.restype = ctypes.c_int
        _UNFILTER = lib.png_unfilter
    return _UNFILTER


def unfilter(raw: np.ndarray, height: int, row_bytes: int, bpp: int
             ) -> np.ndarray:
    """The (height, row_bytes) uint8 rows of an inflated IDAT stream `raw`
    (height x (1 + row_bytes) bytes), by the C++ library. Raises ValueError
    on an unknown filter type."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != height * (row_bytes + 1):
        raise ValueError(f"IDAT holds {raw.size} bytes, expected "
                         f"{height * (row_bytes + 1)}")
    out = np.empty((height, row_bytes), np.uint8)
    rc = _unfilter_fn()(raw, out, height, row_bytes, bpp)
    if rc != 0:
        raise ValueError(f"unknown PNG filter type in row {-rc - 1}")
    return out


def unfilter_plain(raw: np.ndarray, height: int, row_bytes: int, bpp: int
                   ) -> np.ndarray:
    """``unfilter`` in numpy: Sub as a wrapped cumulative sum per channel,
    Up as a row add, Average and Paeth byte by byte."""
    raw = np.asarray(raw, np.uint8)
    if raw.size != height * (row_bytes + 1):
        raise ValueError(f"IDAT holds {raw.size} bytes, expected "
                         f"{height * (row_bytes + 1)}")
    rows = raw.reshape(height, row_bytes + 1)
    out = np.zeros((height, row_bytes), np.uint8)
    zero = np.zeros(row_bytes, np.uint8)
    for r in range(height):
        ftype, src = int(rows[r, 0]), rows[r, 1:]
        prev = out[r - 1] if r > 0 else zero
        if ftype == 0:
            out[r] = src
        elif ftype == 1:
            chans = src.reshape(-1, bpp).astype(np.int64)
            out[r] = (np.cumsum(chans, axis=0) % 256).reshape(-1)
        elif ftype == 2:
            out[r] = src + prev
        elif ftype in (3, 4):
            cur = out[r]
            for i in range(row_bytes):
                a = int(cur[i - bpp]) if i >= bpp else 0
                b = int(prev[i])
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = int(prev[i - bpp]) if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
                cur[i] = (int(src[i]) + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG filter type in row {r}")
    return out


def to_gray(pix: np.ndarray) -> np.ndarray:
    """(H, W, 3 or 4) uint8 RGB(A) -> (H, W) uint8 grey, as OpenCV's PNG
    decoder reads it (see the module docstring)."""
    r, g, b = (pix[..., k].astype(np.int64) for k in range(3))
    cr, cg, cb = _GRAY_COEFFS
    grey = (cr * r + cg * g + cb * b) >> 15
    return np.where((r == g) & (r == b), r, grey).astype(np.uint8)


def decode_png(data: bytes, name: str = "<bytes>", plain: bool = False
               ) -> np.ndarray:
    """A PNG file's pixels: (H, W) uint8 for grey, (H, W, 3 or 4) for RGB(A).
    `plain` unfilters with numpy instead of the C++ library. Raises IOError
    naming `name` for what this decoder does not read."""
    if data[:8] != PNG_SIGNATURE:
        raise IOError(f"{name}: not a PNG file")
    pos, ihdr, idat = 8, None, []
    while pos + 12 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise IOError(f"{name}: truncated {ctype!r} chunk")
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise IOError(f"{name}: CRC mismatch in {ctype!r} chunk")
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None or not idat:
        raise IOError(f"{name}: no IHDR or IDAT chunk")
    w, h, depth, color, _comp, _filt, interlace = ihdr
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise IOError(
            f"{name}: unsupported PNG (bit depth {depth}, colour type "
            f"{color}, interlace {interlace}); this decoder reads 8-bit "
            "non-interlaced grey, RGB or RGBA")
    bpp = _CHANNELS[color]
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise IOError(f"{name}: corrupt IDAT stream ({e})") from None
    try:
        rows = (unfilter_plain if plain else unfilter)(raw, h, w * bpp, bpp)
    except ValueError as e:
        raise IOError(f"{name}: {e}") from None
    return rows if bpp == 1 else rows.reshape(h, w, bpp)


def read_png_gray(path: str) -> np.ndarray:
    """A PNG file as a float32 (H, W) grey image."""
    with open(path, "rb") as f:
        pix = decode_png(f.read(), path)
    if pix.ndim == 3:
        pix = to_gray(pix)
    return pix.astype(np.float32)


class EurocReader:
    """ASL layout: <root>/mav0/cam{0,1}/data/<ns>.png + data.csv."""

    def __init__(self, root: str, stereo: bool = True):
        base = root
        if os.path.isdir(os.path.join(root, "mav0")):
            base = os.path.join(root, "mav0")
        self.cam0 = os.path.join(base, "cam0", "data")
        self.cam1 = os.path.join(base, "cam1", "data")
        self.stereo = stereo and os.path.isdir(self.cam1)
        self.left = self._index(self.cam0)
        self.right = self._index(self.cam1) if self.stereo else []

    @staticmethod
    def _index(d: str) -> List[Tuple[float, str]]:
        out = []
        for f in sorted(glob.glob(os.path.join(d, "*.png"))):
            ns = os.path.splitext(os.path.basename(f))[0]
            try:
                out.append((int(ns) * 1e-9, f))
            except ValueError:
                continue
        return out

    def __len__(self):
        return len(self.left)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray], float]]:
        if not self.stereo:
            for t, f in self.left:
                yield read_png_gray(f), None, t
            return
        rt = np.asarray([t for t, _ in self.right])
        for t, f in self.left:
            j = int(np.searchsorted(rt, t))
            best, bd = -1, STEREO_SYNC_TOL_S
            for k in (j - 1, j, j + 1):
                if 0 <= k < len(rt) and abs(rt[k] - t) <= bd:
                    best, bd = k, abs(rt[k] - t)
            if best < 0:
                continue   # drop unsynced frames, like the grabber
            yield read_png_gray(f), read_png_gray(self.right[best][1]), t


class KittiReader:
    """KITTI odometry layout: <root>/image_0, image_1, times.txt."""

    def __init__(self, root: str, stereo: bool = True):
        self.left_dir = os.path.join(root, "image_0")
        self.right_dir = os.path.join(root, "image_1")
        self.stereo = stereo and os.path.isdir(self.right_dir)
        with open(os.path.join(root, "times.txt")) as f:
            self.times = [float(x) for x in f.read().split()]
        self.files = sorted(glob.glob(os.path.join(self.left_dir, "*.png")))

    def __len__(self):
        return len(self.files)

    def __iter__(self):
        for i, f in enumerate(self.files):
            t = self.times[i] if i < len(self.times) else i * 0.1
            imr = None
            if self.stereo:
                rf = os.path.join(self.right_dir, os.path.basename(f))
                if os.path.exists(rf):
                    imr = read_png_gray(rf)
            yield read_png_gray(f), imr, t


class TartanAirReader:
    """TartanAir layout: <root>/image_left/*_left.png, image_right/..."""

    def __init__(self, root: str, stereo: bool = True, fps: float = 10.0):
        self.left = sorted(glob.glob(os.path.join(root, "image_left", "*.png")))
        self.right_dir = os.path.join(root, "image_right")
        self.stereo = stereo and os.path.isdir(self.right_dir)
        self.dt = 1.0 / fps

    def __len__(self):
        return len(self.left)

    def __iter__(self):
        for i, f in enumerate(self.left):
            imr = None
            if self.stereo:
                rf = os.path.join(
                    self.right_dir,
                    os.path.basename(f).replace("_left", "_right"))
                if os.path.exists(rf):
                    imr = read_png_gray(rf)
            yield read_png_gray(f), imr, i * self.dt


def make_reader(kind: str, root: str, stereo: bool = True):
    kind = kind.lower()
    if kind == "euroc":
        return EurocReader(root, stereo)
    if kind == "kitti":
        return KittiReader(root, stereo)
    if kind == "tartanair":
        return TartanAirReader(root, stereo)
    raise ValueError(f"unknown dataset kind: {kind}")
