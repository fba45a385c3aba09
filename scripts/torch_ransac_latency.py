"""Host latency and host syncs of the port's RANSACs and CLAHE, on the card.

Times ``mvg.essential_ransac`` (5-point, K = 512), ``mvg.p3p_ransac``
(K = 256) and ``image.clahe`` (752x480) per call, each call synchronised
(host clock, after one warm-up call), and counts the host syncs inside one
call with PyTorch's sync debug mode (``chip_smoke.count_syncs``). The
inputs are a seeded two-view scene of N = 192 correspondences, 40 of them
outliers, at the slice's focal length, with the sample indices drawn once
on the card.

``--root DIR`` imports ``ov2slam_tpu_torch`` from another checkout (for
example the parent commit unpacked by ``git archive``), so two versions can
be compared inside one call, in turns:

    python3 scripts/torch_ransac_latency.py [--root DIR] [--reps 5]

The last line is one JSON object with the numbers.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def scene(seed: int = 23, N: int = 192, n_out: int = 40):
    """Unit bearings of a general scene in two views and its points in the
    first view's frame; n_out second-view bearings replaced by outliers."""
    rng = np.random.default_rng(seed)
    X = np.c_[rng.uniform(-3, 3, (N, 2)), 6.0 + rng.uniform(0, 3, N)]
    w = rng.normal(size=3) * 0.1
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    a = np.linalg.norm(w)
    R = np.eye(3) + np.sin(a) / a * K + (1 - np.cos(a)) / a ** 2 * K @ K
    t = np.array([0.3, 0.05, 0.1])
    Xb = (X - t) @ R                                  # R^T (X - t)
    bv_a = X / np.linalg.norm(X, axis=1, keepdims=True)
    bv_b = Xb / np.linalg.norm(Xb, axis=1, keepdims=True)
    out = rng.choice(N, n_out, replace=False)
    Y = np.c_[rng.uniform(-3, 3, (n_out, 2)), 6.0 + rng.uniform(0, 3, n_out)]
    bv_b[out] = Y / np.linalg.norm(Y, axis=1, keepdims=True)
    f32 = lambda v: v.astype(np.float32)              # noqa: E731
    return f32(bv_a), f32(bv_b), f32(Xb)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout to import ov2slam_tpu_torch from")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ransac_latency: needs a CUDA device", file=sys.stderr)
        return 2
    # the package under test is imported first, so that the helpers of this
    # checkout (chip_smoke, loaded from its file) find it already loaded
    sys.path[:0] = [str(args.root.resolve()), str(ROOT / "tests")]
    from ov2slam_tpu_torch import device
    from ov2slam_tpu_torch.ops import image as im
    from ov2slam_tpu_torch.ops import mvg
    import synthetic_np as syn
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert Path(mvg.__file__).resolve().is_relative_to(args.root.resolve())

    print(cs.smi_line(), flush=True)
    device.set_precision_policy()
    dev = torch.device("cuda", 0)
    bv_a, bv_b, Xb = (torch.from_numpy(a).to(dev) for a in scene())
    valid = torch.ones(bv_a.shape[0], dtype=torch.bool, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    idx5 = mvg.draw_samples(valid, 512, 5, gen)
    idx3 = mvg.draw_samples(valid, 256, 3, gen)
    th = 3.0 / 458.0
    frame = syn.render_sequence(n_frames=1)[0][0]
    img = torch.from_numpy(np.ascontiguousarray(frame, np.float32)).to(dev)
    calls = {
        "essential_ransac": lambda: mvg.essential_ransac(bv_a, bv_b, valid, th, idx=idx5),
        "p3p_ransac": lambda: mvg.p3p_ransac(Xb, bv_b, valid, th, idx=idx3),
        "clahe": lambda: im.clahe(img, clip_limit=3.0),
    }
    row = {"root": str(args.root)}
    for name, fn in calls.items():
        ms = cs.host_ms(fn, args.reps)
        syncs = collections.Counter()
        cs.count_syncs(fn, syncs)
        torch.cuda.synchronize()
        row[name] = {"host_ms": ms, "syncs": sum(syncs.values())}
        print(f"[{name}] {ms:.2f} ms per synchronised call (host clock, "
              f"{args.reps} calls), {sum(syncs.values())} host syncs per call: "
              f"{dict(syncs.most_common(4))}", flush=True)
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
