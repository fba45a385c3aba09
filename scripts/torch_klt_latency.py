"""Where the LK kernels' device time goes, on the card.

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
warp, so the chain is what a call waits for. Then the time over N and
``max_iters`` at ``nlevels`` 3.

The per-chunk ``csrc/lk_iterate.cu`` next, on the smoke's cases
(``chip_smoke.lk_case`` at N = 192 and 320, ``n_iters`` 1 / 10 / 30), each
held to ``lk_iterate_plain`` as the smoke holds it, and its N = 1 chain
(``chip_smoke.lk_chain``: the slowest point of the N = 192 case alone over
``n_iters`` 1 / 3 / 10 / 30), and that point and the N = 192 case at
``n_iters`` 0 (the launch and the loads alone). Last, the launch floor: the
empty kernel of ``csrc/launch_floor.cu`` by graph replay at 1 block of 32
threads and at ``lk_iterate``'s N = 192 grid. The build's ``ptxas`` lines (registers,
stack frame, spill bytes) come first.

``--against DIR`` (repeatable) also builds ``DIR/klt_track.cu`` and
``DIR/lk_iterate.cu`` (another checkout's ``csrc``, e.g. the parent
commit's, unpacked by ``git archive``), says for every ``klt_track`` case
whether the two kernels' points, status and errors are equal bit for bit,
and times the kernels through the same wrappers in turns, this one first
(this, other, this, other), on every case and chain above. ``--lk-only``
leaves ``klt_track`` out.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/torch_klt_latency.py [--against DIR ...] [--lk-only]
        [--out FILE]

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
LK_CASES = tuple((N, n) for N in (192, 320) for n in (1, 10, 30))


def other_lib(csrc: Path, name: str):
    """(library, ptxas log) of DIR/<name>.cu, built with the package's nvcc
    flags into the build directory."""
    src = csrc / f"{name}.cu"
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for f in sorted(csrc.glob("*.cu*")):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    lib = _build.BUILD_DIR / f"lib{name}_other_{h.hexdigest()[:16]}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                          str(lib), str(src)], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{out.stdout}{out.stderr}")
    return ctypes.CDLL(str(lib)), (out.stdout + out.stderr).strip()


def other_klt(csrc: Path):
    so, log = other_lib(csrc, "klt_track")
    if so.klt_track_table_bytes() != ctypes.sizeof(klt.LevelTable):
        raise RuntimeError(f"{csrc}/klt_track.cu: its LevelTable differs "
                           "from this one")
    fn = so.klt_track_launch
    fn.argtypes = klt._kernel_fn().argtypes
    fn.restype = ctypes.c_int
    return fn, log


def other_lk(csrc: Path):
    so, log = other_lib(csrc, "lk_iterate")
    fn = so.lk_iterate_launch
    fn.argtypes = lk._kernel_fn().argtypes
    fn.restype = ctypes.c_int
    return fn, log


def in_turns(mod, kernels: dict, fn) -> dict:
    """{label: [value, value]}: fn() with each kernel swapped into the
    wrapper module `mod` (its ``_FN``), the kernels in turns (a, b, a,
    b)."""
    out = {k: [] for k in kernels}
    for _ in range(2):
        for label, kfn in kernels.items():
            mod._FN = kfn
            out[label].append(fn())
    mod._FN = kernels["this"]
    return out


def turns_text(vals: dict) -> str:
    return "; ".join(f"{label} {' / '.join(f'{v:.2f}' for v in vs)} us"
                     for label, vs in vals.items())


def klt_part(kernels: dict, rec: dict, dev):
    """klt_track's cases, chains and sweep (module docstring)."""
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
        row = rec["cases"][tag] = dict(max_abs_dp=dp)
        for label in kernels:
            if label != "this":
                same = all(torch.equal(x, y) for x, y in zip(out["this"],
                                                             out[label]))
                row.setdefault("bit_equal", {})[label] = same
                print(f"{tag}: points, status and error bit-equal to "
                      f"{label}'s kernel: {same}", flush=True)
        k = cs.kernel_only_kw(a, kw)
        us = in_turns(klt, kernels, lambda: 1000 * cs.graph_ms(
            lambda: klt.fb_klt_tracking(*a, **k)))
        b_ms, b_by, *_ = cs.klt_bound(a, k)
        row.update(us=us, bound_us=1000 * b_ms, bound_by=b_by)
        print(f"{tag}: {turns_text(us)} (graph replay, in turns); bound "
              f"{1000 * b_ms:.3f} us by {b_by}", flush=True)

    a16, kw16 = cases["temporal N=192 float16"]
    k16 = cs.kernel_only_kw(a16, kw16)
    rec["chains"] = {}
    for nlevels in (0, 3):
        k = dict(k16, nlevels=nlevels)
        chains = in_turns(klt, kernels,
                          lambda: cs.klt_chain(a16, k, CHAIN_ITERS))
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


def lk_part(kernels: dict, rec: dict, dev):
    """lk_iterate's cases and chain, and the launch floor (module
    docstring)."""
    rec["lk_cases"] = {}
    case_args = {N: cs.lk_case(N, seed=N, dev=dev) for N in (192, 320)}
    for N, n_iters in LK_CASES:
        a = case_args[N]
        kw = dict(win=cs.WIN, n_iters=n_iters, eps=cs.EPS, margin=cs.MARGIN)
        tag = f"lk_iterate N={N} n_iters={n_iters}"
        dp = {}
        for label, kfn in kernels.items():
            lk._FN = kfn
            dp[label] = cs.lk_check(f"[{label}] {tag}", a, kw)
        us = in_turns(lk, kernels, lambda: 1000 * cs.graph_ms(
            lambda: lk.lk_iterate(*a, **kw)))
        b_ms, b_by, *_ = cs.lk_bound(a, kw)
        rec["lk_cases"][tag] = dict(us=us, max_abs_dp=dp,
                                    bound_us=1000 * b_ms, bound_by=b_by)
        print(f"{tag}: {turns_text(us)} (graph replay, in turns); bound "
              f"{1000 * b_ms:.3f} us by {b_by}", flush=True)
    chains = in_turns(lk, kernels,
                      lambda: cs.lk_chain(case_args[192], CHAIN_ITERS))
    rec["lk_chain"] = chains
    for label, cc in chains.items():
        for c in cc:
            print(f"lk_iterate N=1 chain [{label}] point {c['point']}: "
                  f"{cs.chain_text(c, 'n_iters')}", flush=True)
    # n_iters 0: the launch and the loads alone, no GN step
    i = chains["this"][0]["point"]
    kw = dict(win=cs.WIN, n_iters=0, eps=cs.EPS, margin=cs.MARGIN)
    rec["lk_no_steps"] = {}
    for N, a in ((1, [x[i:i + 1].contiguous() for x in case_args[192]]),
                 (192, case_args[192])):
        us = in_turns(lk, kernels, lambda: 1000 * cs.graph_ms(
            lambda: lk.lk_iterate(*a, **kw)))
        rec["lk_no_steps"][f"N={N}"] = us
        print(f"lk_iterate N={N} n_iters=0 (the launch and the loads, no GN "
              f"step): {turns_text(us)} (graph replay, in turns)", flush=True)
    floor = {f"{b}x{t}": [cs.launch_floor_us(b, t) for _ in range(2)]
             for b, t in ((1, 32), (48, 128))}
    rec["launch_floor_us"] = floor
    print("launch floor (an empty kernel by graph replay): " + "; ".join(
        f"{g} {' / '.join(f'{v:.2f}' for v in vs)} us"
        for g, vs in floor.items()), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, action="append", default=[],
                    help="another checkout's csrc directory, timed in turns "
                         "(repeatable)")
    ap.add_argument("--lk-only", action="store_true",
                    help="time only lk_iterate and the launch floor")
    ap.add_argument("--out", type=Path, help="append the JSON object here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_klt_latency: needs a CUDA device", file=sys.stderr)
        return 2
    smi = cs.smi_line()
    print(smi, flush=True)
    device.set_precision_policy()
    dev = torch.device("cuda", 0)
    _build.build(["klt_track", "lk_iterate", "launch_floor"])
    klts = {"this": klt._kernel_fn()}
    lks = {"this": lk._kernel_fn()}
    rows = dict(lk_iterate=cs.lk_ptxas(_build.ptxas_summary(
        _build.BUILD_LOG.get("lk_iterate", ""))))
    if not args.lk_only:
        rows["klt_track"] = cs.klt_ptxas(_build.ptxas_summary(
            _build.BUILD_LOG.get("klt_track", "")))
    rec = dict(tool="torch_klt_latency", smi=smi,
               against=[str(d) for d in args.against], ptxas={"this": rows})
    for d in args.against:
        label = str(d)
        lks[label], log = other_lk(d.resolve())
        rows = dict(lk_iterate=cs.lk_ptxas(_build.ptxas_summary(log)))
        if not args.lk_only:
            klts[label], log = other_klt(d.resolve())
            rows["klt_track"] = cs.klt_ptxas(_build.ptxas_summary(log))
        rec["ptxas"][label] = rows
    for label, rows in rec["ptxas"].items():
        print(f"ptxas {label}: {json.dumps(rows)}", flush=True)
    if not args.lk_only:
        klt_part(klts, rec, dev)
    lk_part(lks, rec, dev)
    print(smi, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
