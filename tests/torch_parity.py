"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; results
come back as numpy for comparison. torch's CPU threads are capped so the
parallel test workers do not oversubscribe the host.
"""

import numpy as np
import torch

torch.set_num_threads(2)


def t(x, dtype=None) -> torch.Tensor:
    """numpy / JAX array -> CPU tensor (float arrays as float32, integers as
    int64, uint32 words as int64)."""
    from ov2slam_tpu_torch.interop import tensor
    return tensor(x, dtype=dtype)


def n(x) -> np.ndarray:
    """tensor / JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
