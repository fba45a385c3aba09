"""Precision and device policy.

Everything in the port runs in float32, in full precision. Two PyTorch
defaults would silently lower it on the GPU: TF32 matrix products and, set
by default, TF32 cuDNN convolutions. Both are switched off here — the
counterpart of the JAX package's ``jax_default_matmul_precision`` pin
(``ov2slam_tpu/slam/manager.py:102``, ``SlamParams.matmul_precision``).

One ``torch.device`` handle is resolved once by ``SlamSystem`` and threaded
through every module that allocates.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def set_precision_policy() -> None:
    """Full-f32 matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device a system runs on: the given one, else the first CUDA card
    when there is one, else the CPU."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")
