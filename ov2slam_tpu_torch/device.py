"""Precision and device policy.

Everything in the port runs in float32, in full precision. Two PyTorch
defaults would silently lower it on the GPU: TF32 matrix products and, set
by default, TF32 cuDNN convolutions. Both are switched off here — the
counterpart of the JAX package's ``jax_default_matmul_precision`` pin
(``ov2slam_tpu/slam/manager.py:102``, ``SlamParams.matmul_precision``).

One ``torch.device`` handle is resolved once by ``SlamSystem`` and threaded
through every module that allocates. An entry point given no device runs on
the first CUDA card and raises when there is none; nothing falls back to
the CPU unasked.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Tuple, Union

import numpy as np
import torch


def set_precision_policy() -> None:
    """Full-f32 matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms for the block: ``index_add_``,
    ``scatter_add_`` and indexed writes, which the BA, the pose graph and
    the PCG sum with, then sum in a fixed order on the card, so a run
    repeats. An operation without a deterministic version warns instead of
    raising. cuBLAS keeps one order only when ``CUBLAS_WORKSPACE_CONFIG``
    is set before it is first used in the process; this sets it unless the
    caller did. The flags the caller had are restored on the way out."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device a system runs on: the given one, else the first CUDA card.
    Without a card and without an explicit device this raises: the CPU runs
    only when the caller asks for it (``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ov2slam_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    return torch.device("cuda", 0)


def select(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x[k] for a 0-dim integer tensor k, read on k's device: indexing with
    the tensor itself reads k back to the host first, a sync on the card."""
    return x.index_select(0, k.reshape(1))[0]


class Fetch:
    """Device -> host copies started now and read later (the pipelined
    mode's deferred reads). On the card each tensor is copied with
    ``copy_(non_blocking=True)`` into a pinned host buffer and one CUDA
    event is recorded behind the copies; ``result`` waits on that event
    only. On the CPU the tensors are cloned: ``.to("cpu")`` of a CPU tensor
    is the tensor itself, which later in-place steps would change."""

    def __init__(self, *tensors: torch.Tensor):
        self.event = None
        self.bufs = []
        for a in tensors:
            if a.device.type == "cuda":
                buf = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                self.bufs.append(buf.copy_(a, non_blocking=True))
                self.event = self.event or torch.cuda.Event()
            else:
                self.bufs.append(a.detach().clone())
        if self.event is not None:
            self.event.record()

    def result(self) -> Tuple[np.ndarray, ...]:
        if self.event is not None:
            self.event.synchronize()
        return tuple(b.numpy() for b in self.bufs)
