"""Where the fused KLT kernel's device time goes, on the card.

Times ``csrc/klt_track.cu`` by CUDA-graph replay (``chip_smoke.graph_ms``)
on the slice's calls (two rendered 752x480 frames, detected corners):
the tracking call (prior jitter 1.5 px) and the stereo call at N = 192 on
float16 and float32 planes, and the KITTI rig's tracking call at N = 448
(1241x376). Each is first held to ``fb_klt_tracking_plain`` as the smoke
holds it. Then the N = 1 chain: the tracking call's slowest point alone,
one warp on the card, over ``max_iters`` 1 / 3 / 10 / 30 at ``nlevels`` 0
and 3, beside the GN steps the plain version counts for it; a line of time
over steps gives the per-step slope and the intercept (window round trips,
template set-up, the launch). The kernel's time is that of its slowest
warp, so the chain is what a call waits for. Last, the time over N and
``max_iters`` at ``nlevels`` 3, and the per-chunk ``lk_iterate`` kernel
over ``n_iters``. The build's ``ptxas`` lines (registers, stack frame,
spill bytes) come first.

``--against DIR`` also builds ``DIR/klt_track.cu`` (another checkout's
``csrc``, e.g. the parent commit's, unpacked by ``git archive``), says for
every case whether the two kernels' points, status and errors are equal
bit for bit, and times both through the same wrapper in turns, this one
first (this, other, this, other), on every case and chain above.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/torch_klt_latency.py [--against DIR] [--out FILE]

It prints one line per measurement and, with ``--out``, appends one JSON
object with every number to FILE.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests"), str(ROOT / "scripts")]

import chip_smoke as cs  # noqa: E402
import klt_inputs  # noqa: E402
import synthetic_np as syn  # noqa: E402
import torch_preset_tiers as tiers  # noqa: E402
from ov2slam_tpu_torch import device  # noqa: E402
from ov2slam_tpu_torch.ops import _build, klt, lk  # noqa: E402

CHAIN_ITERS = (1, 3, 10, 30)


def other_kernel(csrc: Path):
    """(launch function, ptxas log) of DIR/klt_track.cu, built with the
    package's nvcc flags into the build directory."""
    src = csrc / "klt_track.cu"
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for f in sorted(csrc.glob("*.cu*")):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    lib = _build.BUILD_DIR / f"libklt_track_other_{h.hexdigest()[:16]}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                          str(lib), str(src)], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{out.stdout}{out.stderr}")
    so = ctypes.CDLL(str(lib))
    if so.klt_track_table_bytes() != ctypes.sizeof(klt.LevelTable):
        raise RuntimeError(f"{src}: its LevelTable differs from this one")
    fn = so.klt_track_launch
    fn.argtypes = klt._kernel_fn().argtypes
    fn.restype = ctypes.c_int
    return fn, (out.stdout + out.stderr).strip()


def ptxas_rows(log: str) -> dict:
    return cs.klt_ptxas(_build.ptxas_summary(log))


def in_turns(kernels: dict, fn) -> dict:
    """{label: [value, value]}: fn() with each kernel swapped into the
    wrapper, the kernels in turns (a, b, a, b)."""
    out = {k: [] for k in kernels}
    for _ in range(2):
        for label, kfn in kernels.items():
            klt._FN = kfn
            out[label].append(fn())
    klt._FN = kernels["this"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path,
                    help="another checkout's csrc directory, timed in turns")
    ap.add_argument("--out", type=Path, help="append the JSON object here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_klt_latency: needs a CUDA device", file=sys.stderr)
        return 2
    smi = cs.smi_line()
    print(smi, flush=True)
    device.set_precision_policy()
    dev = torch.device("cuda", 0)
    _build.build(["klt_track", "lk_iterate"])
    kernels = {"this": klt._kernel_fn()}
    rec = dict(tool="torch_klt_latency", smi=smi,
               ptxas={"this": ptxas_rows(_build.BUILD_LOG.get("klt_track", ""))})
    if args.against:
        kernels["other"], log = other_kernel(args.against.resolve())
        rec["ptxas"]["other"] = ptxas_rows(log)
        rec["against"] = str(args.against)
    for label, rows in rec["ptxas"].items():
        print(f"ptxas {label}: {json.dumps(rows)}", flush=True)

    fl, fr, _ = syn.render_sequence(n_frames=2, step=0.05)
    kl, kr, _ = tiers.hard_frames(2, workers=1, n_seq=tiers.HARD_N,
                                  dataset="kitti", traj="loop")
    cases = {}
    for dt in cs.KLT_DTYPES:
        name = cs.dtype_name(dt)
        cases[f"temporal N=192 {name}"] = klt_inputs.klt_case(
            (fl, fr), 192, "temporal", 1.5, dev, dtype=dt)
        cases[f"stereo N=192 {name}"] = klt_inputs.klt_case(
            (fl, fr), 192, "stereo", 0.0, dev, dtype=dt)
        cases[f"kitti N={cs.KITTI_KLT_N} {name}"] = klt_inputs.klt_case(
            (kl, kr), cs.KITTI_KLT_N, "temporal", 1.5, dev,
            nlevels=cs.KITTI_LEVELS, cell=cs.KITTI_CELL, dtype=dt)
    rec["cases"] = {}
    for tag, (a, kw) in cases.items():
        dp, out = {}, {}
        for label, kfn in kernels.items():
            klt._FN = kfn
            dp[label] = cs.klt_check(f"[{label}] {tag}", a, kw)
            out[label] = klt.fb_klt_tracking(*a, **kw)
        klt._FN = kernels["this"]
        if args.against:
            same = all(torch.equal(x, y) for x, y in zip(out["this"],
                                                         out["other"]))
            print(f"{tag}: points, status and error bit-equal to the other "
                  f"kernel's: {same}", flush=True)
        k = cs.kernel_only_kw(a, kw)
        us = in_turns(kernels, lambda: 1000 * cs.graph_ms(
            lambda: klt.fb_klt_tracking(*a, **k)))
        b_ms, b_by, *_ = cs.klt_bound(a, k)
        rec["cases"][tag] = dict(us=us, max_abs_dp=dp, bound_us=1000 * b_ms,
                                 bound_by=b_by)
        if args.against:
            rec["cases"][tag]["bit_equal"] = same
        print(f"{tag}: " + "; ".join(
            f"{label} {' / '.join(f'{v:.2f}' for v in vals)} us"
            for label, vals in us.items())
            + f" (graph replay, in turns); bound {1000 * b_ms:.3f} us by "
            f"{b_by}", flush=True)

    a16, kw16 = cases["temporal N=192 float16"]
    k16 = cs.kernel_only_kw(a16, kw16)
    rec["chains"] = {}
    for nlevels in (0, 3):
        k = dict(k16, nlevels=nlevels)
        chains = in_turns(kernels, lambda: cs.klt_chain(a16, k, CHAIN_ITERS))
        rec["chains"][f"nlevels={nlevels}"] = chains
        for label, cc in chains.items():
            for c in cc:
                print(f"N=1 chain nlevels={nlevels} float16 [{label}] point "
                      f"{c['point']}: {cs.chain_text(c)}", flush=True)

    rec["sweep"] = []
    for N in (192, 32, 1):
        a = list(a16[:2]) + [x[:N].contiguous() for x in a16[2:]]
        for max_iters in CHAIN_ITERS:
            k = dict(k16, max_iters=max_iters)
            us = 1000 * cs.graph_ms(lambda: klt.fb_klt_tracking(*a, **k))
            steps = cs.point_steps(a, k)
            rec["sweep"].append(dict(N=N, max_iters=max_iters, us=us,
                                     steps=int(steps.sum()),
                                     max_steps=int(steps.max())))
            print(f"klt_track N={N} nlevels=3 max_iters={max_iters}: "
                  f"{us:.2f} us; GN steps {int(steps.sum())}, at most "
                  f"{int(steps.max())} for one point", flush=True)
    largs = cs.lk_case(192, seed=192, dev=dev)
    for N in (192, 1):
        a = [x[:N].contiguous() for x in largs]
        for n_iters in (1, 2, 5):
            k = dict(win=cs.WIN, n_iters=n_iters, eps=cs.EPS, margin=cs.MARGIN)
            us = 1000 * cs.graph_ms(lambda: lk.lk_iterate(*a, **k))
            print(f"lk_iterate N={N} n_iters={n_iters}: {us:.2f} us",
                  flush=True)
    print(smi, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
