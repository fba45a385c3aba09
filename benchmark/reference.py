"""The plain reference that decides ``correct``: the room's geometry and the
generator's ground-truth poses, in NumPy float64.

The program under test returns, per frame, a camera pose; per chunk of
frames, the keypoints it tracked (pixel positions under landmark ids, the
lost ones marked invalid); per keyframe, a pose refined by the local
bundle adjustment and the keypoints it observed; per landmark, a 3D
position, triangulated and refined by the bundle adjustment. None of these
can be recomputed step for step without running the program's own state,
so the reference judges each against what the generator knows exactly
(where every pixel's ray meets the room, and where every camera was) or,
for the bundle adjustment, against the observations it was given. Each
judge reads the program's outputs only to judge them; the camera model,
the ray casting and the poses are this module's own.

Compared, each against the limit its configuration file states:

* ``pose_step_far_mm`` (front end, PnP): for every frame of the measured
  window, the gap between the program's frame-to-frame translation and the
  ground truth's, its component in the world's horizontal plane, in mm;
  the median over the half of the window's frames that lie farthest from
  the map's origin (the first camera). A loss of precision in the pose's
  arithmetic rounds the pose's translation, whose size is the camera's
  distance from that origin (metres, in the horizontal plane where the
  camera travels), so its error grows with that distance and lies in that
  plane; the sound error neither grows so nor keeps to the plane.
* ``pose_step_p85_mm`` (front end, PnP): the same horizontal gaps over all
  the window's frames but those that step into a keyframe (where the local
  BA's correction moves the pose by design), their 85th percentile: a
  fault on a few frames in ten moves it.
* ``track_p90_px`` (``klt_track``): for keypoints that kept their landmark
  id and stayed valid over a chunk, the pixel gap between where they were
  tracked and where the room point seen before the chunk projects after
  it, 90th percentile.
* ``landmark_p50_pct`` (keyframe path: triangulation and local BA): each
  3D landmark's depth from its anchor keyframe, by the program's pose of
  that keyframe, against the depth at which its bearing meets the room,
  the median of the relative gaps, in percent.
* ``map_reproj_over2_pct`` (local BA): of the map's observations (a
  keyframe's keypoint under a 3D landmark's id), the share farther than
  2 px from the landmark's projection through the keyframe's pose, in
  percent. The local BA fits poses and landmarks to these observations
  and drops those its chi-square gate rejects, so after it few lie so far.

Imports nothing of the program under test.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

UNDIST_ITERS = 50


# ---------------------------------------------------------------- camera
def pixel_rays(px: np.ndarray, cam: dict) -> np.ndarray:
    """(N, 2) pixels -> (N, 3) camera rays (z = 1), Brown radial
    distortion (k1, k2) inverted by fixed-point steps."""
    nx = (px[:, 0] - cam["cx"]) / cam["fx"]
    ny = (px[:, 1] - cam["cy"]) / cam["fy"]
    k1, k2 = cam.get("k1", 0.0), cam.get("k2", 0.0)
    ux, uy = nx.copy(), ny.copy()
    if k1 or k2:
        for _ in range(UNDIST_ITERS):
            r2 = ux * ux + uy * uy
            f = 1.0 + r2 * (k1 + k2 * r2)
            ux, uy = nx / f, ny / f
    return np.stack([ux, uy, np.ones_like(ux)], -1)


def project(Xc: np.ndarray, cam: dict) -> np.ndarray:
    """(N, 3) camera-frame points -> (N, 2) distorted pixels."""
    x = Xc[:, 0] / Xc[:, 2]
    y = Xc[:, 1] / Xc[:, 2]
    r2 = x * x + y * y
    f = 1.0 + r2 * (cam.get("k1", 0.0) + cam.get("k2", 0.0) * r2)
    return np.stack([cam["fx"] * x * f + cam["cx"],
                     cam["fy"] * y * f + cam["cy"]], -1)


# ---------------------------------------------------------------- room
def room_hit(o: np.ndarray, d: np.ndarray, half: float, height: float
             ) -> np.ndarray:
    """(N,) distance along unit-or-not directions d (N, 3) from points o
    (N, 3) inside the room to its surface (in units of |d|)."""
    lim = np.array([half, half, height])
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(d > 0, (lim - o) / d, np.where(d < 0, (-lim - o) / d, np.inf))
    return t.min(axis=1)


# ---------------------------------------------------------------- judges
def pose_steps_horizontal(est: np.ndarray, gt: np.ndarray,
                          frames: np.ndarray) -> np.ndarray:
    """Per frame f in `frames`, the world-horizontal component of the gap
    between the frame-to-frame translations f -> f + 1, mm (a frame with
    no pose gives an infinite gap)."""
    a, b = frames, frames + 1
    rel_e = np.linalg.inv(est[a]) @ est[b]
    rel_g = np.linalg.inv(gt[a]) @ gt[b]
    g = np.einsum("nij,nj->ni", gt[a][:, :3, :3], rel_e[:, :3, 3] - rel_g[:, :3, 3])
    h = 1e3 * np.linalg.norm(g[:, :2], axis=1)
    return np.where(np.isfinite(h), h, np.inf)


def track_gaps(pairs: List[dict], gt_world: np.ndarray, cam: dict,
               half: float, height: float) -> np.ndarray:
    """Per tracked keypoint of each pair (its position before a chunk and
    after it, under the same landmark id), the pixel gap to where the
    room point seen before lands after."""
    out = []
    for p in pairs:
        a, b = p["frame_before"], p["frame_after"]
        ids_a = {int(l): i for i, (l, v) in enumerate(zip(p["lmid_before"],
                                                          p["valid_before"]))
                 if v and l >= 0}
        ia, ib = [], []
        for j, (l, v) in enumerate(zip(p["lmid_after"], p["valid_after"])):
            if v and int(l) in ids_a:
                ia.append(ids_a[int(l)])
                ib.append(j)
        if not ia:
            continue
        Ta, Tb = gt_world[a], gt_world[b]
        rays = pixel_rays(np.asarray(p["px_before"], np.float64)[ia], cam)
        d = rays @ Ta[:3, :3].T
        o = np.broadcast_to(Ta[:3, 3], d.shape)
        X = o + d * room_hit(o, d, half, height)[:, None]
        Xb = (X - Tb[:3, 3]) @ Tb[:3, :3]
        ref = project(Xb, cam)
        out.append(np.linalg.norm(np.asarray(p["px_after"], np.float64)[ib] - ref,
                                  axis=1))
    return np.concatenate(out) if out else np.zeros(0)


def landmark_gaps(lm_pos: np.ndarray, lm_kf: np.ndarray,
                  kf_T_cw: Dict[int, np.ndarray], kf_frame: Dict[int, int],
                  gt_world: np.ndarray, half: float, height: float
                  ) -> np.ndarray:
    """Per landmark, |depth - true depth| / true depth along its bearing
    from its anchor keyframe."""
    keep = np.array([k in kf_T_cw for k in lm_kf], bool)
    if not keep.any():
        return np.zeros(0)
    P, K = lm_pos[keep].astype(np.float64), lm_kf[keep]
    T_cw = np.stack([kf_T_cw[k] for k in K])
    Pc = np.einsum("nij,nj->ni", T_cw[:, :3, :3], P) + T_cw[:, :3, 3]
    depth = np.linalg.norm(Pc, axis=1)
    bear = Pc / depth[:, None]
    G = np.stack([gt_world[kf_frame[k]] for k in K])
    d = np.einsum("nij,nj->ni", G[:, :3, :3], bear)
    o = G[:, :3, 3]
    true = room_hit(o, d, half, height)
    ok = (Pc[:, 2] > 0) & np.isfinite(true)
    return np.abs(depth[ok] - true[ok]) / true[ok]


def map_reprojection(kf_obs: Dict[int, tuple], kf_T_cw: Dict[int, np.ndarray],
                     lm_ids: np.ndarray, lm_pos: np.ndarray, cam: dict
                     ) -> np.ndarray:
    """Per observation of a 3D landmark in a keyframe (its keypoint's
    pixel, under the landmark's id), the pixel gap between the keypoint and
    the landmark's projection through the keyframe's pose."""
    order = np.argsort(lm_ids)
    ids = np.asarray(lm_ids)[order]
    out = []
    for kid, (px, lmid) in kf_obs.items():
        if kid not in kf_T_cw or not len(lmid) or not len(ids):
            continue
        k = np.clip(np.searchsorted(ids, lmid), 0, len(ids) - 1)
        hit = ids[k] == lmid
        if not hit.any():
            continue
        X = np.asarray(lm_pos, np.float64)[order[k[hit]]]
        T = kf_T_cw[kid]
        Xc = X @ T[:3, :3].T + T[:3, 3]
        front = Xc[:, 2] > 1e-6
        out.append(np.linalg.norm(project(Xc[front], cam) - px[hit][front], axis=1))
    return np.concatenate(out) if out else np.zeros(0)


# ---------------------------------------------------------------- verdict
def numbers(rec: dict) -> Dict[str, float]:
    """Every compared number of a run's record (see ``run.py``)."""
    gt = rec["gt_T_wc"]
    est = rec["est_T_wc"]
    n = est.shape[0]
    room = rec["room"]
    cam = rec["rig"]
    w0, w1 = rec["window"]
    frames = np.arange(max(w0 - 1, 0), min(w1, n) - 1)
    kf_frames = {f for f in rec["kf_frame"].values() if w0 <= f < w1}
    into_kf = np.array([f + 1 in kf_frames for f in frames], bool)
    tg = track_gaps(rec["track_pairs"], gt, cam, room["half"], room["height"])
    lg = 100 * landmark_gaps(rec["lm_pos"], rec["lm_kf"], rec["kf_T_cw"],
                             rec["kf_frame"], gt, room["half"], room["height"])
    rp = map_reprojection(rec["kf_obs"], rec["kf_T_cw"], rec["lm_ids"],
                          rec["lm_pos"], cam)

    def pct(a, q):
        return float(np.percentile(a, q)) if a.size else float("inf")
    steps = pose_steps_horizontal(est, gt, frames)
    dist = np.linalg.norm(gt[frames, :3, 3] - gt[0, :3, 3], axis=1)
    far = dist >= np.median(dist)
    return {"pose_step_far_mm": pct(steps[far], 50),
            "pose_step_p85_mm": pct(steps[~into_kf], 85),
            "track_p90_px": pct(tg, 90),
            "landmark_p50_pct": pct(lg, 50),
            "map_reproj_over2_pct": (100 * float((rp > 2).mean()) if rp.size
                                     else float("inf"))}


def verdict(nums: Dict[str, float], limits: Dict[str, float]
            ) -> Optional[List[str]]:
    """The names of the numbers over their limits (empty: correct). A
    number without a limit, or a limit without its number, fails."""
    bad = [k for k, lim in limits.items()
           if not (k in nums and np.isfinite(nums[k]) and nums[k] <= lim)]
    return bad
