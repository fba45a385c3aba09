"""Trajectory logging + writers: TUM / KITTI formats (port of
``ov2slam_tpu/io/trajectories.py``; host numpy, carried over as is).

Replaces the reference's Logger (reference: include/logger.hpp:100-297):
in-memory per-frame pose log (camera-to-world), TUM-format and KITTI-format
writers, keyframe-trajectory writer, and the keyframe-anchored relative store
used to rebuild the full trajectory after loop closure. Output file names and
formats match the reference so ATE tooling is directly comparable
(ov2slam_traj.txt, ov2slam_traj_kitti.txt, ov2slam_kfs_traj.txt,
ov2slam_full_traj_wlc_opt.txt).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np


def _quat_from_R(R: np.ndarray) -> np.ndarray:
    """(x, y, z, w), w >= 0 (float64 host math)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w])
    if q[3] < 0:
        q = -q
    return q / np.linalg.norm(q)


@dataclass
class TrajectoryLogger:
    """Per-frame pose store (camera-to-world T_wc), keyframe flags, and
    per-frame relative poses vs the last keyframe (logger.hpp:104-129)."""

    times: List[float] = field(default_factory=list)
    poses_wc: List[np.ndarray] = field(default_factory=list)    # (4, 4)
    is_kf: List[bool] = field(default_factory=list)
    kf_ids: List[int] = field(default_factory=list)             # -1 if not KF
    # frame anchored to last KF: (kfid, T_kf_cam relative)
    rel_to_kf: List[Tuple[int, np.ndarray]] = field(default_factory=list)

    def add(self, time: float, T_wc: np.ndarray, is_kf: bool, kfid: int,
            T_wkf: np.ndarray = None):
        self.times.append(float(time))
        self.poses_wc.append(np.asarray(T_wc, np.float64).copy())
        self.is_kf.append(bool(is_kf))
        self.kf_ids.append(int(kfid))
        if T_wkf is not None:
            rel = np.linalg.inv(np.asarray(T_wkf, np.float64)) @ np.asarray(T_wc, np.float64)
        else:
            rel = np.eye(4)
        self.rel_to_kf.append((int(kfid), rel))

    def reset(self):
        self.times.clear()
        self.poses_wc.clear()
        self.is_kf.clear()
        self.kf_ids.clear()
        self.rel_to_kf.clear()

    # ------------------------------------------------------------------
    def write_tum(self, path: str, kf_only: bool = False):
        """TUM format: time x y z qx qy qz qw (logger.hpp:135-168)."""
        with open(path, "w") as f:
            for i, T in enumerate(self.poses_wc):
                if kf_only and not self.is_kf[i]:
                    continue
                q = _quat_from_R(T[:3, :3])
                t = T[:3, 3]
                f.write(
                    f"{self.times[i]:.9f} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                    f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n")

    def write_kitti(self, path: str):
        """KITTI format: row-major 3x4 per line (logger.hpp:171-205)."""
        with open(path, "w") as f:
            for T in self.poses_wc:
                row = T[:3, :4].reshape(-1)
                f.write(" ".join(f"{v:.9e}" for v in row) + "\n")

    def write_tartanair(self, path: str, kf_only: bool = False):
        """TartanAir format: x y z qx qy qz qw per line, no timestamp
        (logger.hpp:162-185 writeTrajectoryTartanAir /
        :242-271 writeKfsTrajectoryTartanAir)."""
        with open(path, "w") as f:
            for i, T in enumerate(self.poses_wc):
                if kf_only and not self.is_kf[i]:
                    continue
                q = _quat_from_R(T[:3, :3])
                t = T[:3, 3]
                f.write(
                    f"{t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                    f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n")

    def write_poses_tum(self, path: str, poses_wc: np.ndarray):
        """Write an externally supplied (F, 4, 4) pose array with this log's
        timestamps (used for the full-pose-graph output,
        optimizer.cpp:2838-2860)."""
        with open(path, "w") as f:
            for i in range(len(self.times)):
                T = poses_wc[i]
                q = _quat_from_R(T[:3, :3])
                t = T[:3, 3]
                f.write(
                    f"{self.times[i]:.9f} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                    f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n")

    def write_kf_poses_tum(self, path: str, kf_poses_wc: Dict[int, np.ndarray]):
        """Keyframe trajectory from externally supplied (refined) KF poses
        (ov2slam_fullba_kfs_traj.txt, ov2slam.cpp:606-614)."""
        with open(path, "w") as f:
            for i in range(len(self.times)):
                if not self.is_kf[i]:
                    continue
                T = kf_poses_wc.get(self.kf_ids[i])
                if T is None:
                    continue
                q = _quat_from_R(T[:3, :3])
                t = T[:3, 3]
                f.write(
                    f"{self.times[i]:.9f} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                    f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n")

    def write_full_with_kf_poses(self, path: str, kf_poses_wc: Dict[int, np.ndarray]):
        """Rebuild every frame pose from (possibly LC-corrected) keyframe
        poses via the stored relative transforms, then write TUM
        (ov2slam.cpp:624-701 writeFullTrajectoryLC)."""
        with open(path, "w") as f:
            for i in range(len(self.times)):
                kfid, rel = self.rel_to_kf[i]
                base = kf_poses_wc.get(kfid)
                T = base @ rel if base is not None else self.poses_wc[i]
                q = _quat_from_R(T[:3, :3])
                t = T[:3, 3]
                f.write(
                    f"{self.times[i]:.9f} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                    f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n")


def ate_rmse(traj_est: np.ndarray, traj_gt: np.ndarray, align: bool = True,
             with_scale: bool = False) -> float:
    """Absolute trajectory error (RMSE) after optional Umeyama alignment —
    the evaluation metric of the reference's benchmark protocol
    (benchmark_scripts/euroc_bench.sh). with_scale=True uses the Sim(3)
    (scale-corrected) variant, the standard for monocular trajectories."""
    est = np.asarray(traj_est, np.float64)
    gt = np.asarray(traj_gt, np.float64)
    assert est.shape == gt.shape
    if align:
        mu_e = est.mean(0)
        mu_g = gt.mean(0)
        E = est - mu_e
        G = gt - mu_g
        H = E.T @ G
        U, D, Vt = np.linalg.svd(H)
        d = np.sign(np.linalg.det(Vt.T @ U.T))
        S = np.diag([1.0, 1.0, d])
        R = Vt.T @ S @ U.T
        c = 1.0
        if with_scale:
            # Umeyama: c = tr(DS) / (n * var_e); H above is unnormalized
            var_e = (E ** 2).sum() / len(E)
            c = float(np.trace(np.diag(D) @ S)
                      / max(len(E) * var_e, 1e-12))
        est = c * (R @ E.T).T + mu_g
        gt = G + mu_g
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=-1))))
