"""SLAM configuration (port of ``ov2slam_tpu/config.py``).

Mirrors the reference's parameter schema (reference: src/slam_params.cpp:28-173,
include/slam_params.hpp:44-163) so the same YAML preset files drive both
packages, as an immutable dataclass. The field set and the ``from_dict``
parsing are the JAX package's, unchanged, so one dict configures both.

The YAML files use OpenCV FileStorage syntax (``%YAML 1.0`` directive and
``!!opencv-matrix`` tags); :func:`load_opencv_yaml` parses that dialect with
PyYAML, imported only when a file is loaded: the GPU machine may not have it,
and the port must import without it.
"""

from __future__ import annotations

import dataclasses
import math
import re
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np


# ---------------------------------------------------------------------------
# OpenCV-dialect YAML parsing
# ---------------------------------------------------------------------------

def _opencv_matrix_constructor(loader, node):
    mapping = loader.construct_mapping(node, deep=True)
    rows = int(mapping["rows"])
    cols = int(mapping["cols"])
    data = np.asarray(mapping["data"], dtype=np.float64)
    return data.reshape(rows, cols)


def load_opencv_yaml(path: str) -> Dict[str, Any]:
    """Load an OpenCV FileStorage-style YAML file into a flat dict."""
    import yaml

    class _OpenCVLoader(yaml.SafeLoader):
        pass

    _OpenCVLoader.add_constructor("tag:yaml.org,2002:opencv-matrix",
                                  _opencv_matrix_constructor)
    # cv::FileStorage writes "!!opencv-matrix" which PyYAML resolves to the
    # secondary tag handle; register the local form too for hand-written files.
    _OpenCVLoader.add_constructor("!opencv-matrix", _opencv_matrix_constructor)
    with open(path, "r") as f:
        text = f.read()
    # PyYAML only speaks YAML 1.1; drop the "%YAML 1.0"/"%YAML:1.0" directive
    # line that cv::FileStorage emits (and the following "---" is fine).
    text = re.sub(r"^%YAML[: ][0-9.]+\s*$", "", text, flags=re.M)
    data = yaml.load(text, Loader=_OpenCVLoader)
    return data or {}


def _get(d: Dict[str, Any], key: str, default=None):
    v = d.get(key, default)
    return default if v is None else v


# ---------------------------------------------------------------------------
# SlamParams
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SlamParams:
    """Full parameter set; field names follow the reference's YAML keys."""

    # --- general -----------------------------------------------------------
    debug: bool = False
    log_timings: bool = False
    mono: bool = False
    stereo: bool = True
    force_realtime: bool = False
    slam_mode: bool = True
    buse_loop_closer: bool = True

    # --- camera ------------------------------------------------------------
    cam_left_topic: str = ""
    cam_right_topic: str = ""
    cam_left_model: str = "pinhole"     # "pinhole" | "fisheye"
    cam_right_model: str = "pinhole"
    img_left_w: int = 752
    img_left_h: int = 480
    img_right_w: int = 752
    img_right_h: int = 480
    fxl: float = 0.0
    fyl: float = 0.0
    cxl: float = 0.0
    cyl: float = 0.0
    k1l: float = 0.0
    k2l: float = 0.0
    p1l: float = 0.0
    p2l: float = 0.0
    fxr: float = 0.0
    fyr: float = 0.0
    cxr: float = 0.0
    cyr: float = 0.0
    k1r: float = 0.0
    k2r: float = 0.0
    p1r: float = 0.0
    p2r: float = 0.0
    # 4x4 SE(3) matrix, left-cam-from-right-cam (reference: T_left_right_)
    T_left_right: Optional[np.ndarray] = None

    # --- preprocessing -----------------------------------------------------
    finit_parallax: float = 20.0
    bdo_stereo_rect: bool = False
    alpha: float = 0.0
    bdo_undist: bool = False
    use_clahe: bool = True
    fclahe_val: float = 3.0

    # --- feature extraction ------------------------------------------------
    use_shi_tomasi: bool = False
    use_fast: bool = False
    use_brief: bool = True
    use_singlescale_detector: bool = True
    nfast_th: int = 10
    dmaxquality: float = 0.001
    nmaxdist: int = 35

    # --- KLT ---------------------------------------------------------------
    do_klt: bool = True
    klt_use_prior: bool = True
    btrack_keyframetoframe: bool = False
    nklt_win_size: int = 9
    nklt_pyr_lvl: int = 3
    nmax_iter: int = 30
    fmax_px_precision: float = 0.01
    fmax_fbklt_dist: float = 0.5
    nklt_err: float = 30.0

    # --- matching ----------------------------------------------------------
    bdo_track_localmap: bool = True
    fmax_desc_dist: float = 0.2
    fmax_proj_pxdist: float = 2.0

    # --- geometric filtering ----------------------------------------------
    doepipolar: bool = True
    dop3p: bool = False
    bdo_random: bool = True
    fransac_err: float = 3.0
    nransac_iter: int = 100
    fmax_reproj_err: float = 3.0
    buse_inv_depth: bool = True

    # --- bundle adjustment -------------------------------------------------
    robust_mono_th: float = 5.9915
    robust_stereo_th: float = 7.8147
    use_sparse_schur: bool = True
    use_dogleg: bool = False
    use_subspace_dogleg: bool = False
    use_nonmonotic_step: bool = False
    apply_l2_after_robust: bool = True
    nmin_covscore: int = 25
    fkf_filtering_ratio: float = 0.95
    do_full_ba: bool = False

    # --- knobs without a reference equivalent (the JAX package's fields) ----
    # Fixed keypoint-table capacity per frame (padded; >= nbmaxkps).
    kp_capacity: int = 0          # 0 = derive from nbmaxkps, rounded up
    # Fixed landmark / keyframe arena capacities for the map store.
    lm_capacity: int = 1 << 14
    # Deferred BA writeback and the realtime pipeline depth (force_realtime);
    # not ported yet, SlamSystem refuses them.
    async_ba: bool = False
    pipeline_depth: int = 6
    kf_capacity: int = 1 << 11
    # Multi-device BA mesh in the JAX package (0/1 = single device); the port
    # runs on one GPU and refuses n_devices > 1.
    n_devices: int = 0
    # JAX-only: background ahead-of-time compiles (ignored by the port).
    prewarm: bool = True
    # Wall-clock budget (seconds) of the post-loop-closure loose BA (the
    # reference's max_solver_time_in_seconds, optimizer.cpp:460-468).
    lc_loose_ba_time_s: float = 2.0
    dtype: str = "float32"
    # JAX-only matmul precision pin; the port always runs full float32
    # (device.set_precision_policy).
    matmul_precision: str = "highest"

    # --- derived -----------------------------------------------------------
    @property
    def fepi_th(self) -> float:
        # reference: slam_params.cpp:144 (fepi_th_ = fransac_err_)
        return self.fransac_err

    @property
    def nbmaxkps(self) -> int:
        # reference: slam_params.cpp:108-111
        nbwcells = math.ceil(self.img_left_w / self.nmaxdist)
        nbhcells = math.ceil(self.img_left_h / self.nmaxdist)
        return int(nbwcells * nbhcells)

    @property
    def kp_cap(self) -> int:
        """Static keypoint-table size (padded to a multiple of 64)."""
        if self.kp_capacity:
            return self.kp_capacity
        return ((self.nbmaxkps + 63) // 64) * 64

    @property
    def klt_half_win(self) -> int:
        return self.nklt_win_size // 2

    def replace(self, **kw) -> "SlamParams":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    @staticmethod
    def from_yaml(path: str) -> "SlamParams":
        d = load_opencv_yaml(path)
        return SlamParams.from_dict(d)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "SlamParams":
        def b(key, default=False):
            return bool(int(_get(d, key, int(default))))

        T_lr = None
        if "body_T_cam0" in d and "body_T_cam1" in d:
            Tb0 = np.asarray(d["body_T_cam0"], dtype=np.float64)
            Tb1 = np.asarray(d["body_T_cam1"], dtype=np.float64)
            # reference: slam_params.cpp:86 — T_left_right = Tbc0^-1 * Tbc1
            T_lr = np.linalg.inv(Tb0) @ Tb1
        elif "T_left_right" in d:
            T_lr = np.asarray(d["T_left_right"], dtype=np.float64)

        return SlamParams(
            debug=b("debug"),
            log_timings=b("log_timings"),
            mono=b("mono"),
            stereo=b("stereo", True),
            force_realtime=b("force_realtime"),
            slam_mode=b("slam_mode", True),
            buse_loop_closer=b("buse_loop_closer"),
            cam_left_topic=str(_get(d, "Camera.topic_left", "")),
            cam_right_topic=str(_get(d, "Camera.topic_right", "")),
            cam_left_model=str(_get(d, "Camera.model_left", "pinhole")),
            cam_right_model=str(_get(d, "Camera.model_right", "pinhole")),
            img_left_w=int(_get(d, "Camera.left_nwidth", 752)),
            img_left_h=int(_get(d, "Camera.left_nheight", 480)),
            img_right_w=int(_get(d, "Camera.right_nwidth", 752)),
            img_right_h=int(_get(d, "Camera.right_nheight", 480)),
            fxl=float(_get(d, "Camera.fxl", 0.0)),
            fyl=float(_get(d, "Camera.fyl", 0.0)),
            cxl=float(_get(d, "Camera.cxl", 0.0)),
            cyl=float(_get(d, "Camera.cyl", 0.0)),
            k1l=float(_get(d, "Camera.k1l", 0.0)),
            k2l=float(_get(d, "Camera.k2l", 0.0)),
            p1l=float(_get(d, "Camera.p1l", 0.0)),
            p2l=float(_get(d, "Camera.p2l", 0.0)),
            fxr=float(_get(d, "Camera.fxr", 0.0)),
            fyr=float(_get(d, "Camera.fyr", 0.0)),
            cxr=float(_get(d, "Camera.cxr", 0.0)),
            cyr=float(_get(d, "Camera.cyr", 0.0)),
            k1r=float(_get(d, "Camera.k1r", 0.0)),
            k2r=float(_get(d, "Camera.k2r", 0.0)),
            p1r=float(_get(d, "Camera.p1r", 0.0)),
            p2r=float(_get(d, "Camera.p2r", 0.0)),
            T_left_right=T_lr,
            finit_parallax=float(_get(d, "finit_parallax", 20.0)),
            bdo_stereo_rect=b("bdo_stereo_rect"),
            alpha=float(_get(d, "alpha", 0.0)),
            bdo_undist=b("bdo_undist"),
            use_clahe=b("use_clahe", True),
            fclahe_val=float(_get(d, "fclahe_val", 3.0)),
            use_shi_tomasi=b("use_shi_tomasi"),
            use_fast=b("use_fast"),
            use_brief=b("use_brief", True),
            use_singlescale_detector=b("use_singlescale_detector", True),
            nfast_th=int(_get(d, "nfast_th", 10)),
            dmaxquality=float(_get(d, "dmaxquality", 0.001)),
            nmaxdist=int(_get(d, "nmaxdist", 35)),
            do_klt=b("do_klt", True),
            klt_use_prior=b("klt_use_prior", True),
            btrack_keyframetoframe=b("btrack_keyframetoframe"),
            nklt_win_size=int(_get(d, "nklt_win_size", 9)),
            nklt_pyr_lvl=int(_get(d, "nklt_pyr_lvl", 3)),
            nmax_iter=int(_get(d, "nmax_iter", 30)),
            fmax_px_precision=float(_get(d, "fmax_px_precision", 0.01)),
            fmax_fbklt_dist=float(_get(d, "fmax_fbklt_dist", 0.5)),
            nklt_err=float(_get(d, "nklt_err", 30.0)),
            bdo_track_localmap=b("bdo_track_localmap", True),
            fmax_desc_dist=float(_get(d, "fmax_desc_dist", 0.2)),
            fmax_proj_pxdist=float(_get(d, "fmax_proj_pxdist", 2.0)),
            doepipolar=b("doepipolar", True),
            dop3p=b("dop3p"),
            bdo_random=b("bdo_random", True),
            fransac_err=float(_get(d, "fransac_err", 3.0)),
            nransac_iter=int(_get(d, "nransac_iter", 100)),
            fmax_reproj_err=float(_get(d, "fmax_reproj_err", 3.0)),
            buse_inv_depth=b("buse_inv_depth", True),
            robust_mono_th=float(_get(d, "robust_mono_th", 5.9915)),
            robust_stereo_th=float(_get(d, "robust_stereo_th", 7.8147)),
            use_sparse_schur=b("use_sparse_schur", True),
            use_dogleg=b("use_dogleg"),
            use_subspace_dogleg=b("use_subspace_dogleg"),
            use_nonmonotic_step=b("use_nonmonotic_step"),
            apply_l2_after_robust=b("apply_l2_after_robust", True),
            nmin_covscore=int(_get(d, "nmin_covscore", 25)),
            fkf_filtering_ratio=float(_get(d, "fkf_filtering_ratio", 0.95)),
            do_full_ba=b("do_full_ba"),
            kp_capacity=int(_get(d, "kp_capacity", 0)),
            lm_capacity=int(_get(d, "lm_capacity", 1 << 14)),
            kf_capacity=int(_get(d, "kf_capacity", 1 << 11)),
            async_ba=b("async_ba", bool(int(_get(d, "force_realtime", 0)))),
            pipeline_depth=int(_get(d, "pipeline_depth", 6)),
            n_devices=int(_get(d, "n_devices", 0)),
            prewarm=b("prewarm", True),
            lc_loose_ba_time_s=float(_get(d, "lc_loose_ba_time_s", 2.0)),
            matmul_precision=str(_get(d, "matmul_precision", "highest")),
        )
