"""The port's dataset readers and PNG decoder (``ov2slam_tpu_torch/io/
datasets.py``) against the JAX package's readers (OpenCV's decoder).

Every tree of ``tests/test_datasets_layout.py`` (EuRoC ASL, the unsynced
right frame it drops, the mono fallback without cam1, KITTI odometry,
TartanAir) is written twice: by OpenCV (its adaptive row filters) and by
``tests/dataset_np.py`` (row r filtered with type r % 5), TartanAir in
colour. Both packages' readers must yield the same number of frames with
equal arrays and equal timestamps (exactly: the same arithmetic). The C++
unfilter equals its numpy twin on random streams; each filter type decodes
to the written pixels; files this decoder does not read raise naming the
file; and the readers run with OpenCV and PIL unimportable.
"""

import os
import struct
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest

from ov2slam_tpu.io import datasets as jds
from ov2slam_tpu_torch.io import datasets as tds

import dataset_np as dnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# test_datasets_layout.py's EuRoC stamps (V1_01_easy) and KITTI times
EUROC_TS = [1403715273262142976, 1403715273312143104, 1403715273362142976,
            1403715273412143104, 1403715273462142976]
KITTI_TIMES = [0.0, 0.103745, 0.207488, 0.311231]


def _cv2_write(path, img):
    if img.ndim == 3:              # RGB(A) -> OpenCV's BGR(A)
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    assert cv2.imwrite(path, img)


def _images(n, seed, shape=(32, 48)):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        img[: shape[0] // 4] = img[: shape[0] // 4] // 16 * 16   # smooth rows
        if img.ndim == 3:          # some grey pixels (R = G = B)
            img[-2:, :, 1:3] = img[-2:, :, :1]
        out.append(img)
    return out


def _tree(kind, root, write):
    """(reader kind, reader root) of `kind`'s tree written under `root`."""
    if kind.startswith("euroc"):
        n = len(EUROC_TS)
        right_ts = list(EUROC_TS)
        if kind == "euroc_unsynced":
            # one right frame beyond the 15 ms sync tolerance
            right_ts[2] += int(2.5 * jds.STEREO_SYNC_TOL_S * 1e9)
        right = None if kind == "euroc_mono" else _images(n, 100)
        dnp.write_euroc(root, _images(n, 0), right, EUROC_TS, right_ts,
                        write=write)
        return "euroc", os.path.join(root, "mav0") if kind == "euroc_mav0" else root
    if kind == "kitti":
        dnp.write_kitti(root, _images(4, 0), _images(4, 100), KITTI_TIMES,
                        write=write)
        return "kitti", root
    dnp.write_tartanair(root, _images(3, 0, (32, 48, 3)),
                        _images(3, 50, (32, 48, 4)), write=write)
    return "tartanair", root


@pytest.mark.parametrize("writer", ["cv2", "np"])
@pytest.mark.parametrize("kind", ["euroc", "euroc_mav0", "euroc_unsynced",
                                  "euroc_mono", "kitti", "tartanair"])
def test_readers_equal_jax(tmp_path, kind, writer):
    write = _cv2_write if writer == "cv2" else dnp.write_png
    rkind, root = _tree(kind, str(tmp_path / "seq"), write)
    jr = jds.make_reader(rkind, root, stereo=True)
    tr = tds.make_reader(rkind, root, stereo=True)
    assert len(tr) == len(jr)
    jf, tf = list(jr), list(tr)
    assert len(tf) == len(jf) == {"euroc_unsynced": 4, "kitti": 4,
                                  "tartanair": 3}.get(kind, 5)
    for (jl, jrr, jt), (tl, trr, tt) in zip(jf, tf):
        assert tt == jt
        assert tl.dtype == np.float32 and np.array_equal(tl, jl)
        assert (trr is None) == (jrr is None) == (kind == "euroc_mono")
        if trr is not None:
            assert trr.dtype == np.float32 and np.array_equal(trr, jrr)


@pytest.mark.parametrize("bpp", [1, 3, 4])
def test_unfilter_matches_numpy_twin(bpp):
    rng = np.random.default_rng(bpp)
    h, w = 23, 17
    raw = rng.integers(0, 256, (h, 1 + w * bpp), dtype=np.uint8)
    raw[:, 0] = rng.integers(0, 5, h)
    raw[:5, 0] = np.arange(5)
    a = tds.unfilter(raw.reshape(-1), h, w * bpp, bpp)
    b = tds.unfilter_plain(raw.reshape(-1), h, w * bpp, bpp)
    assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)
    raw[7, 0] = 5
    with pytest.raises(ValueError, match="row 7"):
        tds.unfilter(raw.reshape(-1), h, w * bpp, bpp)
    with pytest.raises(ValueError, match="row 7"):
        tds.unfilter_plain(raw.reshape(-1), h, w * bpp, bpp)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_each_filter_type_decodes(tmp_path, ftype, channels):
    shape = (29, 41) if channels == 1 else (29, 41, channels)
    img = _images(1, ftype, shape)[0]
    path = str(tmp_path / "f.png")
    dnp.write_png(path, img, filters=ftype)
    with open(path, "rb") as f:
        data = f.read()
    for plain in (False, True):
        assert np.array_equal(tds.decode_png(data, path, plain), img)
    assert np.array_equal(tds.read_png_gray(path),
                          jds._imread_gray(path))


def _with_ihdr(data: bytes, **fields) -> bytes:
    """`data` with IHDR fields replaced (width, height, depth, color,
    interlace) and its CRC recomputed."""
    w, h, depth, color, comp, filt, inter = struct.unpack(">IIBBBBB", data[16:29])
    vals = dict(width=w, height=h, depth=depth, color=color, interlace=inter)
    vals.update(fields)
    body = struct.pack(">IIBBBBB", vals["width"], vals["height"], vals["depth"],
                       vals["color"], comp, filt, vals["interlace"])
    return (data[:16] + body + struct.pack(">I", zlib.crc32(b"IHDR" + body))
            + data[33:])


@pytest.mark.parametrize("fields,what", [
    (dict(interlace=1), "interlace 1"), (dict(color=3), "colour type 3"),
    (dict(depth=16), "bit depth 16"), (dict(color=4), "colour type 4")])
def test_unsupported_files_raise_naming_the_file(tmp_path, fields, what):
    data = _with_ihdr(dnp.encode_png(_images(1, 0)[0]), **fields)
    path = str(tmp_path / "odd.png")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(IOError, match=f"{path}.*{what}"):
        tds.read_png_gray(path)


def test_corrupt_files_raise(tmp_path):
    good = dnp.encode_png(_images(1, 0)[0])
    bad_crc = good[:40] + bytes([good[40] ^ 1]) + good[41:]
    for name, data in (("sig", b"GIF89a" + good[6:]), ("crc", bad_crc),
                       ("short", good[:60])):
        path = str(tmp_path / f"{name}.png")
        with open(path, "wb") as f:
            f.write(data)
        with pytest.raises(IOError, match=path):
            tds.read_png_gray(path)


def test_readers_need_no_opencv_or_pil(tmp_path):
    _tree("tartanair", str(tmp_path / "seq"), dnp.write_png)
    code = (
        "import sys\n"
        "sys.modules['cv2'] = None; sys.modules['PIL'] = None\n"
        "from ov2slam_tpu_torch.io.datasets import make_reader\n"
        f"frames = list(make_reader('tartanair', {str(tmp_path / 'seq')!r}))\n"
        "assert len(frames) == 3 and frames[0][1].shape == (32, 48)\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=REPO),
                         timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]
