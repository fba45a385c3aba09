"""Where the fused KLT kernel's device time goes, on the card.

Times ``csrc/klt_track.cu`` by CUDA-graph replay (``chip_smoke.graph_ms``)
on the slice's tracking call (two rendered 752x480 frames, detected
corners, prior jitter 1.5 px) while varying what its latency is made of:
the iteration budget (``max_iters``), the pyramid depth (``nlevels`` 0 or
3) and the number of keypoints (N = 1 is one warp alone on the card). Each
line also gives the GN steps the plain version counts on the same inputs,
in all and for the longest point. The kernel's time is that of its slowest
warp, so the N = 1 lines give the latency of one warp's chain: window round
trips and GN steps. The per-chunk ``lk_iterate`` kernel is timed the same
way over ``n_iters``.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/torch_klt_latency.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import chip_smoke as cs  # noqa: E402
import klt_inputs  # noqa: E402
import synthetic_np as syn  # noqa: E402
from ov2slam_tpu_torch import device  # noqa: E402
from ov2slam_tpu_torch.ops import klt, lk  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_klt_latency: needs a CUDA device", file=sys.stderr)
        return 2
    print(cs.smi_line(), flush=True)
    device.set_precision_policy()
    dev = torch.device("cuda", 0)
    fl, fr, _ = syn.render_sequence(n_frames=2, step=0.05)
    args, kw = klt_inputs.klt_case((fl, fr), 192, "temporal", 1.5, dev)
    for N in (192, 32, 1):
        a = list(args[:2]) + [x[:N].contiguous() for x in args[2:]]
        for nlevels in (0, 3):
            for max_iters in (1, 3, 10, 30):
                k = dict(kw, nlevels=nlevels, max_iters=max_iters)
                ms = cs.graph_ms(lambda: klt.fb_klt_tracking(*a, **k))
                calls = []
                klt.fb_klt_tracking_plain(*a, **k, lk_fn=cs.recording_lk(calls))
                per_point = cs.steps_per_point(calls)
                print(f"klt_track N={N} nlevels={nlevels} max_iters="
                      f"{max_iters}: {1000 * ms:.2f} us; GN steps "
                      f"{int(per_point.sum())}, at most "
                      f"{int(per_point.max())} for one point", flush=True)
    largs = cs.lk_case(192, seed=192, dev=dev)
    for N in (192, 1):
        a = [x[:N].contiguous() for x in largs]
        for n_iters in (1, 2, 5):
            k = dict(win=cs.WIN, n_iters=n_iters, eps=cs.EPS, margin=cs.MARGIN)
            ms = cs.graph_ms(lambda: lk.lk_iterate(*a, **k))
            print(f"lk_iterate N={N} n_iters={n_iters}: {1000 * ms:.2f} us",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
