"""CPU tests of the byte count behind chip_smoke.py's kernel bounds.

``chip_smoke.mark_patches`` marks the pixels a win x win hat-weighted patch
reads inside its window; the bounds of ``klt_track`` and ``lk_iterate``
count those pixels once per plane. It must mark exactly the pixels whose
weight in ``lk.sample_in_windows`` is nonzero: the support of the patch's
gradient with respect to the window, on windows of nonzero values.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from ov2slam_tpu_torch.ops import lk  # noqa: E402

WIN, WS, N = 9, 20, 64


def _positions(kind: str, gen: torch.Generator) -> torch.Tensor:
    if kind == "inside":          # fractional, patch inside the window
        return 5.0 + 9.0 * torch.rand(N, 2, generator=gen)
    if kind == "integer":         # one column and row of zero weight fewer
        return torch.round(5.0 + 9.0 * torch.rand(N, 2, generator=gen))
    return -3.0 + 26.0 * torch.rand(N, 2, generator=gen)   # past the edges


@pytest.mark.parametrize("kind", ["inside", "integer", "edges"])
def test_mark_patches_is_the_hat_weights_support(kind):
    gen = torch.Generator().manual_seed(7)
    pos = _positions(kind, gen)
    origins = torch.randint(0, 40, (N, 2), generator=gen)
    vals = 1.0 + torch.rand(N, WS, WS, generator=gen)
    w = torch.ones(N, WS, WS, requires_grad=True)
    lk.sample_in_windows(w * vals, pos, WIN).sum().backward()
    mask = torch.zeros(80, 80, dtype=torch.bool)
    sel = torch.ones(N, dtype=torch.bool)
    sel[::5] = False
    n = cs.mark_patches(mask, pos + origins, origins, sel, WIN, WS)
    ref = torch.zeros(80, 80, dtype=torch.bool)
    for i in torch.nonzero(sel).flatten().tolist():
        ox, oy = origins[i].tolist()
        ref[oy:oy + WS, ox:ox + WS] |= w.grad[i] != 0
    assert n == int(sel.sum())
    assert torch.equal(mask, ref)
