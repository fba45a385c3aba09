"""The ordered segment sum (``ops/segment.py``) against ``index_add_``.

On ragged random indices (one long segment, many short ones, empty ones),
float32 and int64 values, with and without trailing dimensions: the gather
tree that the card uses, run here on the CPU, equals ``index_add_`` in
float64 to float32 rounding (rtol 1e-5 of the segment's sum of magnitudes:
the two add the same terms in another order) and bit for bit on integers;
the CPU's index (``index_add_`` in index order) equals ``index_add_``;
empty segments are 0 and an empty index gives zeros.
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (caps torch threads)
from ov2slam_tpu_torch.ops import segment

CASES = [(5, 0, ()), (1, 1, ()), (7, 100, (3,)), (300, 5, (2,)),
         (3, 500, ()), (40, 3000, (6, 6)), (2000, 1500, (6, 1))]


def _index(n, m, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, m)
    if m > 10:
        idx[: m // 3] = 0               # one long segment
        idx[idx == n - 1] = 0           # and an empty one
    return torch.from_numpy(idx).long()


@pytest.mark.parametrize("n,m,trail", CASES)
def test_tree_sum_matches_index_add(n, m, trail):
    idx = _index(n, m, n + m)
    rng = np.random.default_rng(m)
    v = torch.from_numpy(rng.normal(size=(m,) + trail).astype(np.float32))
    seg = segment.tree_index(idx, n)
    out = segment.segment_sum(seg, v)
    ref = torch.zeros((n,) + trail, dtype=torch.float64).index_add_(
        0, idx, v.double())
    mag = torch.zeros_like(ref).index_add_(0, idx, v.double().abs())
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert ((out.double() - ref).abs() <= 1e-5 * mag + 1e-30).all()
    empty = torch.ones(n, dtype=torch.bool)
    empty[idx] = False
    assert (out[empty] == 0).all()
    ints = torch.from_numpy(rng.integers(-9, 9, (m,) + trail))
    assert torch.equal(segment.segment_sum(seg, ints),
                       torch.zeros((n,) + trail, dtype=torch.int64)
                       .index_add_(0, idx, ints))


@pytest.mark.parametrize("n,m,trail", CASES)
def test_cpu_index_is_index_add(n, m, trail):
    idx = _index(n, m, 7)
    v = torch.from_numpy(np.random.default_rng(1).normal(
        size=(m,) + trail).astype(np.float32))
    seg = segment.segment_index(idx, n)
    assert seg.levels is None
    assert torch.equal(segment.segment_sum(seg, v),
                       torch.zeros((n,) + trail).index_add_(0, idx, v))


def test_tree_is_static_and_bounded():
    """Every level's table has CHUNK lanes and at most ceil(m / CHUNK) +
    min(n, m) blocks; no segment is left with more than one block."""
    n, m = 50, 4000
    idx = _index(n, m, 3)
    seg = segment.tree_index(idx, n)
    size = m
    for tbl in seg.levels:
        assert tbl.shape[1] == segment.CHUNK
        assert tbl.shape[0] <= -(-size // segment.CHUNK) + min(n, size)
        assert int(tbl.max()) <= size
        size = tbl.shape[0]
    assert seg.last.shape == (n,)
    assert segment.segment_sum(segment.tree_index(idx[:0], n),
                               torch.ones(0, 3)).abs().sum() == 0
