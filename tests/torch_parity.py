"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; results
come back as numpy for comparison. torch's CPU threads are capped so the
parallel test workers do not oversubscribe the host.
"""

import contextlib

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


@contextlib.contextmanager
def r1_patched():
    """The JAX package with the name its structure-only solver misses
    (``smallalg``, used unimported at ``ov2slam_tpu/opt/ba.py:536``)
    supplied for the block. On the way out the name is removed again and
    the solver's compiled versions are dropped: a jitted function keeps
    what it traced, so without that a later test in the same process could
    run the solver patched, and the JAX package's own tests of it would
    pass or fail by the order the tests ran in. The solver is the only
    jitted function that traces the name (its callers, the estimator's
    ``local_ba_with_caps`` and the loop closer, are plain Python), so
    clearing JAX's other caches would only make later tests compile again.
    """
    import ov2slam_tpu.core.smallalg as jsmallalg
    import ov2slam_tpu.opt.ba as jba
    assert not hasattr(jba, "smallalg"), "the R1 patch is already applied"
    jba.smallalg = jsmallalg
    try:
        yield
    finally:
        del jba.smallalg
        jba.solve_structure_only.clear_cache()
