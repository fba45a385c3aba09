"""CLI entry point: run SLAM over a dataset directory (port of
``ov2slam_tpu/run.py``).

Replaces the reference's ROS node (reference: src/ov2slam_node.cpp:159-223,
`rosrun ov2slam ov2slam_node params.yaml`):

    python -m ov2slam_tpu_torch.run <params.yaml> <dataset_dir> \
        [--dataset euroc|kitti|tartanair] [--out DIR] [--max-frames N] \
        [--viz-every N] [--device cuda|cpu]

Runs on the first CUDA card unless ``--device`` names another device; with
no card and no ``--device`` it raises. Writes reference-compatible
trajectory files into --out and prints the profiler summary when
log_timings is set. The run uses PyTorch's deterministic algorithms
(``device.deterministic``), so two runs over the same frames write the same
files, unless ``force_realtime`` drops frames by the wall clock.
"""

from __future__ import annotations

import argparse
import os
import sys
import time as _time
from typing import Callable, Iterable, Iterator, List

import numpy as np


def _stream(frames: Iterable, realtime: bool, clock: Callable[[], float],
            dropped: List[float]) -> Iterator:
    """The frames to process, in order. With `realtime`, force_realtime's
    frame dropping (reference: getNewImage with bforce_realtime_,
    ov2slam.cpp:291-298 — keep only the newest queued frame), replayed:
    frames "arrive" at their timestamps on a clock anchored at the first
    frame, and a frame is dropped (its time appended to `dropped`) when a
    newer one has already arrived by the time processing gets to it."""
    anchor = None
    prev = None
    for cur in frames:
        if anchor is None:
            anchor = (clock(), cur[2])
        if prev is not None:
            if realtime and anchor[1] + (clock() - anchor[0]) >= cur[2]:
                dropped.append(prev[2])
                prev = cur
                continue
            yield prev
        prev = cur
    if prev is not None:
        yield prev


def main(argv=None) -> dict:
    """Run the CLI; returns the run's counts (frames processed, dropped,
    seconds, keyframes)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("params", help="parameter YAML (parameters_files/...)")
    ap.add_argument("dataset_dir", help="dataset root directory")
    ap.add_argument("--dataset", default="euroc",
                    choices=["euroc", "kitti", "tartanair"])
    ap.add_argument("--out", default=".", help="output directory")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--viz-every", type=int, default=0, metavar="N",
                    help="every N frames dump the tracked-keypoint overlay "
                         "(viz/track_FFFFFF.png, needs OpenCV) and refresh "
                         "the map + KF trajectory PLYs under --out (the "
                         "reference's frame-rate/KF-rate rviz hooks, "
                         "ov2slam.cpp:461-480 + ros_visualizer.hpp:61-311, "
                         "as files)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)

    from ov2slam_tpu_torch import device as device_mod
    from ov2slam_tpu_torch import viz
    from ov2slam_tpu_torch.config import SlamParams
    from ov2slam_tpu_torch.io.datasets import make_reader
    from ov2slam_tpu_torch.slam.manager import SlamSystem

    dev = device_mod.resolve_device(args.device)
    params = SlamParams.from_yaml(args.params)
    reader = make_reader(args.dataset, args.dataset_dir, stereo=params.stereo)
    device_mod.set_precision_policy()
    with device_mod.deterministic():
        slam = SlamSystem(params, device=dev)
        n = 0
        dropped: List[float] = []
        t0 = _time.perf_counter()
        for iml, imr, t in _stream(reader, params.force_realtime,
                                   _time.perf_counter, dropped):
            if params.stereo and imr is not None:
                slam.process_stereo(iml, imr, t)
            else:
                slam.process_mono(iml, t)
            n += 1
            if args.viz_every and n % args.viz_every == 0:
                viz_dir = os.path.join(args.out, "viz")
                os.makedirs(viz_dir, exist_ok=True)
                try:
                    import cv2
                    # overlay on the image the tracker actually sees
                    # (rectified + CLAHE'd pyramid level 0)
                    base = (slam.fe_state.pyr[0].cpu().numpy()
                            if slam.fe_state is not None else iml)
                    img = viz.draw_track_image(np.asarray(base, np.float32), slam)
                    cv2.imwrite(os.path.join(viz_dir, f"track_{n:06d}.png"), img)
                except ImportError:
                    pass            # overlay needs cv2; PLYs below do not
                viz.export_map_ply(slam, viz_dir)
            if args.max_frames and n >= args.max_frames:
                break
            if n % 200 == 0:
                fps = n / (_time.perf_counter() - t0)
                print(f"[{n}/{len(reader)}] {fps:.1f} fps, "
                      f"{len(slam.map.keyframes)} KFs, {slam.map.n_3d()} "
                      "landmarks", file=sys.stderr)

        dt = _time.perf_counter() - t0
        os.makedirs(args.out, exist_ok=True)
        slam.write_results(args.out)
    if args.dataset == "tartanair":
        # timestamp-free variants for the TartanAir eval tooling
        # (logger.hpp:162-185, :242-271)
        slam.logger.write_tartanair(
            os.path.join(args.out, "ov2slam_traj_tartanair.txt"))
        slam.logger.write_tartanair(
            os.path.join(args.out, "ov2slam_kfs_traj_tartanair.txt"),
            kf_only=True)
    print(f"processed {n} frames in {dt:.1f}s ({n / max(dt, 1e-9):.2f} fps); "
          f"dropped {len(dropped)}; "
          f"{len(slam.map.keyframes)} keyframes, {slam.map.n_3d()} landmarks; "
          f"results in {args.out}")
    if params.log_timings:
        print(slam.prof.summary())
    return dict(frames=n, dropped=len(dropped), seconds=dt,
                keyframes=len(slam.map.keyframes))


if __name__ == "__main__":
    main()
