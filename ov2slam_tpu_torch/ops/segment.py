"""Ordered segment sums: ``out[s] = sum of vals[i] where index[i] == s``,
summed in one fixed order in every run (no atomics, no global flag).

The BA solvers, the Schur-PCG and the pose graph sum their normal equations
this way where they used ``index_add_``, whose atomics on the card add in
an order that changes from run to run (ROADMAP C/P4). A problem keeps one
structure over a whole solve, so its ``SegmentIndex`` is built once, where
the solver starts, and every sum of the solve reuses it.

On the card the index is a short tree of padded gather tables with static
shapes (no host read, so a solver stays free of host syncs): the entries
are sorted by segment (a stable sort), each segment's run is cut into
blocks of ``CHUNK`` entries, padded with a zero row and summed over the
block; the block sums of a segment are again contiguous, and the same step
repeats until every segment has at most one block. Every sum is a
reduction over a tensor dimension, which runs in one order for a given
shape. The padding is bounded by shapes alone: a level of ``m`` entries
over ``n`` segments has at most ``ceil(m / CHUNK) + min(n, m)`` blocks.

On the CPU ``index_add_`` already adds the rows one after another in index
order, with no threads and no atomics: the order of the JAX package's CPU
scatter, which the parity tests hold the port to, so the CPU keeps it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

CHUNK = 16


class SegmentIndex(NamedTuple):
    n: int                            # number of segments
    index: torch.Tensor               # (m,) segment of each row
    # the gather tree (None: sum by index_add_ in index order, the CPU's):
    # per level a (B_k, CHUNK) table of rows of the level's input, whose
    # row count stands for the zero pad row, and the (n,) rows of the last
    # level's sums
    levels: Optional[Tuple[torch.Tensor, ...]] = None
    last: Optional[torch.Tensor] = None


def segment_index(index: torch.Tensor, n: int) -> SegmentIndex:
    """The index of the sums by `index` ((m,) int64 in [0, n)) over n
    segments: the gather tree on the card, the index itself on the CPU."""
    if index.device.type == "cpu":
        return SegmentIndex(n, index)
    return tree_index(index, n)


def tree_index(index: torch.Tensor, n: int) -> SegmentIndex:
    """The gather tree of `index` over n segments, on index's device."""
    dev = index.device
    if n == 0:
        return SegmentIndex(0, index, (), torch.zeros(0, dtype=torch.int64,
                                                      device=dev))
    m = int(index.shape[0])
    order = torch.argsort(index, stable=True)
    seg = index[order]
    ar = torch.arange(n, device=dev)
    start = torch.searchsorted(seg, ar)
    count = torch.searchsorted(seg, ar, right=True) - start
    lane = torch.arange(CHUNK, device=dev)
    src, size, max_count = order, m, m
    levels = []
    while True:
        nb = (count + CHUNK - 1) // CHUNK           # blocks per segment
        end = torch.cumsum(nb, 0)
        boff = end - nb
        n_blocks = -(-size // CHUNK) + min(n, size)
        b = torch.arange(n_blocks, device=dev)
        s = torch.clamp(torch.searchsorted(end, b, right=True), max=n - 1)
        k = (b - boff[s])[:, None] * CHUNK + lane   # rank in the segment
        ok = (k < count[s][:, None]) & (b < end[-1])[:, None]
        pos = torch.clamp(start[s][:, None] + k, max=max(size - 1, 0))
        rows = src[pos]
        levels.append(torch.where(ok, rows, torch.full_like(rows, size)))
        src, size, start, count = b, n_blocks, boff, nb
        max_count = -(-max_count // CHUNK)
        if max_count <= 1:
            break
    last = torch.where(count > 0, start, torch.full_like(start, size))
    return SegmentIndex(n, index, tuple(levels), last)


def _pad_row(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])


def segment_sum(seg: SegmentIndex, vals: torch.Tensor) -> torch.Tensor:
    """(n, ...) sums of the rows of vals ((m, ...), float or integer) by
    the index `seg` was built from; empty segments are 0."""
    if seg.levels is None:
        out = vals.new_zeros((seg.n,) + tuple(vals.shape[1:]))
        return out.index_add_(0, seg.index, vals)
    x = vals
    for tbl in seg.levels:
        x = _pad_row(x)[tbl].sum(1)
    return _pad_row(x)[seg.last]
