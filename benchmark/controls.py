"""Controls and planted faults of the correctness check. The benchmark's own
runs never use them; ``run.py --control NAME`` and
``test_bench_faults.py`` do, to show that the check fails each of them.

The control (``CONTROLS``) runs the program one precision below what its
configuration states. The configurations state float32 arithmetic with
TF32 off (the program's precision policy) and pyramid planes stored in
float16. ``lower_precision`` takes each one step down, where the program
computes it:

* float32 matrix products on TF32 tensor cores, switched on after the
  system has set its policy;
* the stored pyramid and gradient planes rounded to float8 (e4m3) where
  the front end and the keyframe path cast them (``frontend.cast_pyr``),
  then held in float16, the type the KLT kernel reads.

The faults (``FAULTS``) break one output of the timed path where it is
produced:

* ``state_unchanged``: the chunk step returns its input state, and the
  input pose for every frame;
* ``half_frames``: half of each chunk's frames left out, each left-out
  frame given the result of the frame after it;
* ``pose_altered``: every frame's pose moved by 5 mm, to one side on even
  frames and to the other on odd ones;
* ``pose_altered_minority``: one frame in eight (each chunk's fourth)
  moved by 5 mm;
* ``track_shifted``: every point the KLT tracker returns moved by 1 px
  along the image rows (tracking and the keyframes' stereo matches);
* ``landmarks_scaled``: every landmark position the local bundle
  adjustment writes back, 5% farther from its anchor keyframe's camera;
* ``ba_unchanged``: the local bundle adjustment returns its input poses
  and landmarks, and marks no observation an outlier.

Each entry installs itself on a built system, before its first frame.
"""

from __future__ import annotations


def lower_precision(slam) -> None:
    import torch
    from ov2slam_tpu_torch.slam import frontend as fe_mod
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    cast = fe_mod.cast_pyr

    def cast_fp8(pyr):
        return tuple(a.to(torch.float8_e4m3fn).to(torch.float16)
                     for a in cast(pyr))
    fe_mod.cast_pyr = cast_fp8


def _wrap_chunk_step(fn):
    """A fault that replaces the front end's chunk step by fn(orig, ...)."""
    def install(slam):
        from ov2slam_tpu_torch.slam import frontend as fe_mod
        orig = fe_mod.frame_chunk_step
        fe_mod.frame_chunk_step = lambda *a, **kw: fn(orig, *a, **kw)
    return install


def _state_unchanged(orig, state, imgs, *a, **kw):
    from ov2slam_tpu_torch.core import lie
    _, stats = orig(state, imgs, *a, **kw)
    stats = stats.clone()
    stats[:, 5:8] = state.t_cw
    stats[:, 8:12] = lie.quat_from_mat(state.R_cw)
    return state, stats


def _half_frames(orig, state, imgs, *a, **kw):
    new, stats = orig(state, imgs[1::2], *a, **kw)
    return new, stats.repeat_interleave(2, dim=0)


def _pose_altered(orig, state, imgs, *a, **kw):
    new, stats = orig(state, imgs, *a, **kw)
    stats = stats.clone()
    stats[0::2, 5] += 0.005
    stats[1::2, 5] -= 0.005
    return new, stats


def _pose_altered_minority(orig, state, imgs, *a, **kw):
    new, stats = orig(state, imgs, *a, **kw)
    stats = stats.clone()
    stats[3::8, 5] += 0.005
    return new, stats


def track_shifted(slam) -> None:
    from ov2slam_tpu_torch.ops import klt as klt_mod
    orig = klt_mod.fb_klt_tracking

    def shifted(*a, **kw):
        res = orig(*a, **kw)
        pts = res.points.clone()
        pts[:, 0] += 1.0
        return res._replace(points=pts)
    klt_mod.fb_klt_tracking = shifted


def landmarks_scaled(slam) -> None:
    import numpy as np
    m = slam.map
    orig = m.update_positions_from_ba

    def scaled(lmids, pos, lams):
        C = np.stack([-(k.T_cw[:3, :3].T @ k.T_cw[:3, 3]) if k is not None
                      else np.zeros(3) for k in
                      (m.keyframes.get(int(a)) for a in m.lm_anchor[lmids])])
        orig(lmids, (C + 1.05 * (pos - C)).astype(pos.dtype), lams / 1.05)
    m.update_positions_from_ba = scaled


def ba_unchanged(slam) -> None:
    import torch
    est = slam.estimator
    orig = est._solve

    def solve(prob, max_iters):
        r = orig(prob, max_iters)
        return r._replace(R=prob.R, t=prob.t, Xw=prob.Xw, lam=prob.lam,
                          obs_inlier=torch.ones_like(r.obs_inlier))
    est._solve = solve


CONTROLS = {"lower_precision": lower_precision}
FAULTS = {"state_unchanged": _wrap_chunk_step(_state_unchanged),
          "half_frames": _wrap_chunk_step(_half_frames),
          "pose_altered": _wrap_chunk_step(_pose_altered),
          "pose_altered_minority": _wrap_chunk_step(_pose_altered_minority),
          "track_shifted": track_shifted,
          "landmarks_scaled": landmarks_scaled,
          "ba_unchanged": ba_unchanged}
