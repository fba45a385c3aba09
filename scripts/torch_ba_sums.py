"""Time the BA solvers' sums three ways on the card, in turns, on the BA
problems of a real run: ``index_add_`` with atomics (the sums before
``ops/segment.py``), ``index_add_`` under PyTorch's deterministic
algorithms (``device.deterministic``), and the ordered segment sums.

    python3 scripts/torch_ba_sums.py

The loop tier of ``scripts/torch_preset_tiers.py`` (``accurate_stereo``
over 1000 frames, whose loop closure runs the loose span BA) runs once on
the card under deterministic algorithms, as
``chip_smoke.py`` runs it, recording the problem of every local BA solve
(``Estimator._solve``) and of every budgeted span BA solve
(``Estimator._solve_global_budgeted``). Then the last three local BA
problems and every span problem are solved again as the run solved them
(the span BA without its wall-clock budget, so that every iteration and
the L2 re-solve run), ``REPS`` times in each mode, in the turns atomics,
deterministic, ordered, ordered, deterministic, atomics: host ms per
solve, the card synchronised before and after. "atomics" and
"deterministic" sum with ``index_add_`` (each ``SegmentIndex`` built
without its gather tree, the CPU's form); "ordered" as the port does.
One JSON line per problem and mode (ms per solve, their median, whether
the mode repeated its result bit for bit), after the card's
``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests"), str(ROOT / "scripts")]

TIER, REPS = "accurate_stereo", 2


@contextlib.contextmanager
def summing(mode: str):
    """The BA sums of `mode` for the block."""
    from ov2slam_tpu_torch import device
    from ov2slam_tpu_torch.ops import segment
    real = segment.segment_index
    if mode != "ordered":
        segment.segment_index = lambda index, n: segment.SegmentIndex(n, index)
    try:
        with (device.deterministic() if mode == "deterministic"
              else contextlib.nullcontext()):
            yield
    finally:
        segment.segment_index = real


@contextlib.contextmanager
def recording(est_cls, rec: dict):
    """Record the problems of the local and the budgeted span BA solves."""
    real_local, real_span = est_cls._solve, est_cls._solve_global_budgeted

    def local(self, prob, max_iters):
        rec["local"].append((self, prob, max_iters))
        return real_local(self, prob, max_iters)

    def span(self, prob, max_iters, cg_iters, time_budget_s):
        rec["span"].append((self, prob, max_iters, cg_iters))
        return real_span(self, prob, max_iters, cg_iters, time_budget_s)

    est_cls._solve, est_cls._solve_global_budgeted = local, span
    try:
        yield
    finally:
        est_cls._solve, est_cls._solve_global_budgeted = real_local, real_span


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    import torch_preset_tiers as tiers
    from ov2slam_tpu_torch import device
    from ov2slam_tpu_torch.slam.estimator import Estimator
    if not torch.cuda.is_available():
        print("torch_ba_sums: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    device.set_precision_policy()
    dev = torch.device("cuda", 0)
    frames = tiers.hard_frames(tiers.HARD_N)
    slam = tiers.make_system("torch", tiers.tier_dict(TIER), dev,
                             tiers.LC_DETECTOR)
    rec = {"local": [], "span": []}
    t0 = time.perf_counter()
    with device.deterministic(), recording(Estimator, rec):
        row = tiers.run_tier(slam, frames, False, sync=torch.cuda.synchronize)
    print(json.dumps(dict(tier=TIER, ate=row["ate"],
                          local_solves=len(rec["local"]),
                          span_solves=len(rec["span"]),
                          run_seconds=time.perf_counter() - t0)), flush=True)

    def solve(kind, item):
        if kind == "local":
            est, prob, iters = item
            out = est._solve(prob, iters)
        else:
            est, prob, iters, cg = item
            out = est._solve_global_budgeted(prob, iters, cg, float("inf"))
        return torch.cat([out.R.flatten(), out.t.flatten(), out.lam.flatten()])

    problems = ([("local", it) for it in rec["local"][-3:]]
                + [("span", it) for it in rec["span"]])
    turns = ("atomics", "deterministic", "ordered", "ordered",
             "deterministic", "atomics")
    for kind, item in problems:
        prob = item[1]
        size = dict(kfs=int(prob.R.shape[0]), lms=int(prob.lam.shape[0]),
                    obs=int(prob.obs_kf.shape[0]))
        ms = {m: [] for m in turns}
        outs = {m: [] for m in turns}
        for mode in turns:
            with summing(mode):
                for _ in range(REPS):
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    outs[mode].append(solve(kind, item))
                    torch.cuda.synchronize()
                    ms[mode].append(1000 * (time.perf_counter() - t1))
        for mode in ("atomics", "deterministic", "ordered"):
            same = all(torch.equal(o, outs[mode][0]) for o in outs[mode][1:])
            print(json.dumps(dict(kind=kind, mode=mode, **size,
                                  ms=[round(x, 3) for x in ms[mode]],
                                  median_ms=float(np.median(ms[mode])),
                                  repeats_bit_for_bit=same)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
