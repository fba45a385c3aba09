"""Visualization / export: point-cloud + trajectory PLY, track images (port
of ``ov2slam_tpu/viz.py``).

Replaces the reference's rviz publishing stack (reference:
include/ros_visualizer.hpp:61-311, src/camera_visualizer.cpp): instead of
live ROS topics, the same artifacts are exported as files — the landmark
point cloud (MapManager's PCL cloud, map_manager.cpp:36-38), keyframe
trajectory, and the tracked-keypoint overlay image with the reference's
color coding (ov2slam.cpp:493-509: green = tracked 3D, yellow = tracked 2D).
The PLYs are numpy on the host map; the overlay needs OpenCV, which it
imports when called (``run.py`` skips it where OpenCV is missing).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def write_ply_points(path: str, points: np.ndarray,
                     colors: Optional[np.ndarray] = None):
    """points (N, 3) float; colors (N, 3) uint8 optional."""
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i, 0]:.4f} {points[i, 1]:.4f} {points[i, 2]:.4f}"
            if colors is not None:
                row += f" {colors[i, 0]} {colors[i, 1]} {colors[i, 2]}"
            f.write(row + "\n")


def export_map_ply(slam, out_dir: str = "."):
    """Landmark cloud + KF trajectory as PLY files."""
    m = slam.map
    mask = m.lm_valid & m.lm_is3d
    pts = m.lm_pos[mask]
    write_ply_points(os.path.join(out_dir, "ov2slam_map_points.ply"), pts)
    kf_pos = np.stack([
        np.linalg.inv(rec.T_cw.astype(np.float64))[:3, 3]
        for _, rec in sorted(m.keyframes.items())]) if m.keyframes else np.zeros((0, 3))
    colors = np.tile(np.array([[255, 64, 64]], np.uint8), (len(kf_pos), 1))
    write_ply_points(os.path.join(out_dir, "ov2slam_kf_traj.ply"), kf_pos, colors)


def draw_track_image(img: np.ndarray, slam) -> np.ndarray:
    """Keypoint overlay (pubTrackImage semantics): green circles for tracked
    3D keypoints, yellow for 2D ones. Returns a BGR uint8 image."""
    import cv2
    out = cv2.cvtColor(np.clip(img, 0, 255).astype(np.uint8),
                       cv2.COLOR_GRAY2BGR)
    px = slam.kps.px.cpu().numpy()
    valid = slam.kps.valid.cpu().numpy()
    is3d = slam.kps.is3d.cpu().numpy()
    for i in np.nonzero(valid)[0]:
        c = (0, 255, 0) if is3d[i] else (0, 255, 255)
        cv2.circle(out, (int(px[i, 0]), int(px[i, 1])), 3, c, 1)
    return out
