"""Dataset fixtures written with numpy and the standard library alone (no
OpenCV, no PyYAML), for the readers' and the CLI's tests and for
``chip_smoke.py`` on the GPU machine.

* ``encode_png`` / ``write_png``: 8-bit grey, RGB or RGBA PNG files whose
  rows use the filter types given (by default row r uses type r % 5:
  None, Sub, Up, Average, Paeth), so every unfilter path of a decoder runs.
* ``write_euroc`` / ``write_kitti`` / ``write_tartanair``: the public
  directory layouts exactly as they ship (``tests/test_datasets_layout.py``
  fixes them): EuRoC ASL ``mav0/cam{0,1}/data/<ns>.png`` with ``data.csv``
  and ``sensor.yaml``; KITTI odometry ``image_{0,1}/%06d.png`` with
  ``times.txt`` (``%e`` seconds) and ``calib.txt``; TartanAir
  ``image_{left,right}/%06d_{left,right}.png``.
* ``write_euroc_groundtruth``: EuRoC's
  ``mav0/state_groundtruth_estimate0/data.csv`` (ns stamps, positions,
  unit quaternions), the file ``scripts/euroc_bench.py`` scores against.
* ``write_opencv_yaml``: a flat SlamParams dict as an OpenCV-dialect YAML
  preset (``%YAML:1.0``, ``!!opencv-matrix`` for arrays) that both the JAX
  package's PyYAML loader and the port's own parser read to the same dict.
"""

import os
import struct
import zlib

import numpy as np

# EuRoC MAV V1_01_easy's first cam0 stamp (ns) and its 20 Hz period
EUROC_T0_NS = 1403715273262142976
EUROC_DT_NS = 50_000_000


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def encode_png(img: np.ndarray, filters=None) -> bytes:
    """`img` (H, W) grey or (H, W, 3 / 4) RGB(A) uint8 as PNG bytes; row r
    filtered with type ``filters[r]`` (default r % 5; an int: every row)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    color = {1: 0, 3: 2, 4: 6}[bpp]
    if filters is None:
        filters = np.arange(h) % 5
    ftype = np.broadcast_to(np.asarray(filters, np.int64), (h,))
    x = img.reshape(h, w * bpp).astype(np.int16)
    zrow = np.zeros((1, w * bpp), np.int16)
    zcol = np.zeros((h, bpp), np.int16)
    prev = np.vstack([zrow, x[:-1]])
    left = np.hstack([zcol, x[:, :-bpp]])
    upleft = np.hstack([zcol, prev[:, :-bpp]])
    p = left + prev - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
    preds = np.stack([np.zeros_like(x), left, prev, (left + prev) >> 1, paeth])
    pred = np.take_along_axis(preds, ftype[None, :, None], 0)[0]
    rows = np.empty((h, 1 + w * bpp), np.uint8)
    rows[:, 0] = ftype
    rows[:, 1:] = (x - pred) & 0xFF
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, filters=None):
    with open(path, "wb") as f:
        f.write(encode_png(img, filters))


def euroc_stamps(n: int, t0_ns: int = EUROC_T0_NS, dt_ns: int = EUROC_DT_NS):
    """n cam0 stamps (ns) from t0_ns at dt_ns."""
    return [t0_ns + i * dt_ns for i in range(n)]


def write_euroc(root: str, left, right, stamps, right_stamps=None,
                write=write_png):
    """An EuRoC ASL sequence under `root`: left image i at stamps[i] (ns),
    right image i at right_stamps[i] (default: the same stamps; None for
    `right` writes no cam1)."""
    cams = [("cam0", left, stamps)]
    if right is not None:
        cams.append(("cam1", right, right_stamps or stamps))
    for cam, imgs, ts in cams:
        d = os.path.join(root, "mav0", cam, "data")
        os.makedirs(d)
        with open(os.path.join(root, "mav0", cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for t in ts:
                f.write(f"{t},{t}.png\n")
        with open(os.path.join(root, "mav0", cam, "sensor.yaml"), "w") as f:
            f.write("sensor_type: camera\n")
        for img, t in zip(imgs, ts):
            write(os.path.join(d, f"{t}.png"), img)


def write_euroc_groundtruth(root: str, stamps, positions):
    """EuRoC's ground-truth CSV under `root`: position i (m) at stamps[i]
    (ns), identity orientation, zero velocity and biases."""
    d = os.path.join(root, "mav0", "state_groundtruth_estimate0")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "data.csv"), "w") as f:
        f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], "
                "q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z [], v_RS_R_x [m s^-1], "
                "v_RS_R_y [m s^-1], v_RS_R_z [m s^-1], b_w_RS_S_x [rad s^-1], "
                "b_w_RS_S_y [rad s^-1], b_w_RS_S_z [rad s^-1], "
                "b_a_RS_S_x [m s^-2], b_a_RS_S_y [m s^-2], b_a_RS_S_z [m s^-2]\n")
        for t, (x, y, z) in zip(stamps, positions):
            f.write(f"{t},{x:.9f},{y:.9f},{z:.9f},1,0,0,0" + ",0" * 9 + "\n")


def write_kitti(root: str, left, right, times, write=write_png):
    """A KITTI odometry sequence under `root` (times in seconds)."""
    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(root, sub))
    with open(os.path.join(root, "times.txt"), "w") as f:
        for t in times:
            f.write(f"{t:e}\n")
    with open(os.path.join(root, "calib.txt"), "w") as f:
        f.write("P0: 7.070912e+02 0.000000e+00 6.018873e+02 0.000000e+00 "
                "0.000000e+00 7.070912e+02 1.831104e+02 0.000000e+00 "
                "0.000000e+00 0.000000e+00 1.000000e+00 0.000000e+00\n")
    for i, (il, ir) in enumerate(zip(left, right)):
        write(os.path.join(root, "image_0", f"{i:06d}.png"), il)
        write(os.path.join(root, "image_1", f"{i:06d}.png"), ir)


def write_tartanair(root: str, left, right, write=write_png):
    """A TartanAir trajectory under `root` (``<env>/Easy/P001`` in the
    release)."""
    for sub in ("image_left", "image_right"):
        os.makedirs(os.path.join(root, sub))
    for i, (il, ir) in enumerate(zip(left, right)):
        write(os.path.join(root, "image_left", f"{i:06d}_left.png"), il)
        write(os.path.join(root, "image_right", f"{i:06d}_right.png"), ir)


def _yaml_scalar(v) -> str:
    if isinstance(v, (bool, np.bool_)):
        return str(int(v))
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        s = repr(float(v))
        if s in ("inf", "-inf", "nan"):
            return s.replace("inf", ".inf").replace("nan", ".nan")
        if "." not in s:                 # YAML 1.1 floats need a dot
            mant, _, exp = s.partition("e")
            s = f"{mant}.0" + (f"e{exp}" if exp else "")
        return s
    s = str(v)
    if not s or s.strip() != s or any(c in s for c in ":#'\"[]{},&*!|>%@`"):
        raise ValueError(f"string {s!r} needs quoting")
    return s


def write_opencv_yaml(path: str, d: dict):
    """`d` (flat keys; scalars, strings and 2-D arrays) as an OpenCV
    FileStorage-style YAML preset."""
    lines = ["%YAML:1.0", "---"]
    for k, v in d.items():
        if isinstance(v, (np.ndarray, list, tuple)):
            a = np.asarray(v, np.float64)
            a = a.reshape(1, -1) if a.ndim == 1 else a
            data = ", ".join(_yaml_scalar(x) for x in a.reshape(-1))
            lines += [f"{k}: !!opencv-matrix", f"  rows: {a.shape[0]}",
                      f"  cols: {a.shape[1]}", "  dt: d", f"  data: [{data}]"]
        elif v is None:
            continue
        else:
            lines.append(f"{k}: {_yaml_scalar(v)}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
