"""ov2slam_tpu_torch — the PyTorch/CUDA port of ov2slam_tpu.

A second package beside ``ov2slam_tpu`` (the JAX reference). It runs the
stereo SLAM main path — tracking, keyframe mapping and local bundle
adjustment — on one NVIDIA GPU, with the Lucas-Kanade Gauss-Newton loop as a
hand-written CUDA kernel (``csrc/lk_iterate.cu``). The layout mirrors the
JAX package (``core/``, ``ops/``, ``opt/``, ``parallel/``, ``slam/``,
``io/``) so each module's counterpart is found at the same path.

The package imports torch, numpy and (where needed) scipy; never jax, the
JAX package, OpenCV, or (at import time) PyYAML.
"""

__version__ = "0.1.0"

from ov2slam_tpu_torch.config import SlamParams  # noqa: F401
