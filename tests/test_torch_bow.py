"""The port's place index and loop-candidate detector (``slam/bow.py``, the
C++ index ``csrc/bow_index.cpp`` built with g++) and ``describe.knn2_match``
against the JAX package on the same descriptors.

Exact: the two native indexes return identical ids and scores (same source
algorithm, one compiled by the port, one the JAX package's), the numpy
indexes too, the detectors the same candidates, and ``knn2_match`` the same
indices and distances, ties included (both take the first minimum).
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from ov2slam_tpu.ops import describe as jdesc
from ov2slam_tpu.slam import bow as jbow
from ov2slam_tpu_torch.ops import describe as tdesc
from ov2slam_tpu_torch.slam import bow as tbow

from torch_parity import n, t


def _stream(seed, n_imgs=40, n_desc=120, revisit=25):
    """Per image (n_desc, 8) uint32 descriptors: fresh random ones, and from
    image `revisit` on, noisy copies (a few bits flipped) of the images
    `revisit` earlier, so the index has true revisits to find."""
    rng = np.random.default_rng(seed)
    imgs = []
    for i in range(n_imgs):
        d = rng.integers(0, 2 ** 32, (n_desc, 8), dtype=np.uint64).astype(np.uint32)
        if i >= revisit:
            src = imgs[i - revisit].copy()
            flips = rng.integers(0, 32, (n_desc, 3))
            words = rng.integers(0, 8, (n_desc, 3))
            for k in range(3):
                src[np.arange(n_desc), words[:, k]] ^= (
                    np.uint32(1) << flips[:, k].astype(np.uint32))
            d[: n_desc * 2 // 3] = src[: n_desc * 2 // 3]
        imgs.append(d)
    return imgs


def test_port_builds_its_own_index():
    idx = tbow.BinaryIndex()
    assert idx.native
    lib = tbow.library_path()
    assert os.path.exists(lib)
    assert os.path.basename(os.path.dirname(lib)) == "build"
    assert os.path.dirname(os.path.dirname(lib)).endswith("ov2slam_tpu_torch")


@pytest.mark.parametrize("force_python", [False, True], ids=["native", "numpy"])
def test_index_ids_and_scores_match_jax(force_python):
    imgs = _stream(0, n_imgs=30 if force_python else 40,
                   n_desc=40 if force_python else 120)
    ji = jbow.BinaryIndex(force_python=force_python)
    ti = tbow.BinaryIndex(force_python=force_python)
    assert ji.native == ti.native == (not force_python)
    n_hits = 0
    for i, d in enumerate(imgs):
        for max_id in (i - 1, i - 10):
            qj = ji.query(d, max_image_id=max_id, topk=10)
            qt = ti.query(d, max_image_id=max_id, topk=10)
            assert qt == qj, (i, max_id)
            n_hits += len(qt)
        ji.add_image(i, d)
        ti.add_image(i, d)
    assert n_hits > 0


def test_detector_candidates_match_jax():
    """The whole detector (query, island grouping, prior-island preference,
    temporal consistency) over one descriptor stream."""
    imgs = _stream(1, n_imgs=45, revisit=20)
    kw = dict(p_wait=8, island_size=4, min_consecutive=2, min_score=3.0)
    dj, dt = jbow.LCDetector(**kw), tbow.LCDetector(**kw)
    fired = 0
    for i, d in enumerate(imgs):
        cj, ct = dj.process(i, d), dt.process(i, d)
        assert (cj is None) == (ct is None), i
        if cj is not None:
            fired += 1
            assert (ct.query_kf, ct.match_kf, ct.island) == (
                cj.query_kf, cj.match_kf, cj.island)
            assert ct.score == cj.score
        assert (dt._consecutive, dt._last_island) == (dj._consecutive,
                                                       dj._last_island)
    assert fired >= 3


HITS = [
    # no hits; one hit; two islands; the prior island again (consistency);
    # a weaker island near the prior one, preferred over a stronger far one;
    # a far island alone (streak restarts); below the score floor
    [],
    [(3, 5.0)],
    [(3, 5.0), (5, 4.0), (30, 6.0), (40, 0.1)],
    [(4, 6.0), (6, 3.0), (31, 2.0)],
    [(5, 6.0), (7, 5.5), (50, 9.0), (51, 8.0), (60, 1.0)],
    [(60, 7.0), (61, 4.0)],
    [(62, 1.0), (70, 0.5)],
]


@pytest.mark.parametrize("min_consecutive", [1, 2])
def test_island_logic_matches_jax(min_consecutive):
    kw = dict(p_wait=0, island_size=5, min_score=3.0,
              min_consecutive=min_consecutive, force_python_index=True)
    dj, dt = jbow.LCDetector(**kw), tbow.LCDetector(**kw)
    outs = []
    for k, hits in enumerate(HITS):
        cj, ct = dj._detect(100 + k, list(hits)), dt._detect(100 + k, list(hits))
        assert (cj is None) == (ct is None), k
        if cj is not None:
            assert (ct.match_kf, ct.score, ct.island) == (cj.match_kf, cj.score,
                                                          cj.island)
        outs.append(None if ct is None else ct.match_kf)
    # the prior-island rule picked the weaker near island at step 4
    assert outs[4] in (None, 5)
    assert any(o is not None for o in outs)


def _descs(rng, n_rows):
    return rng.integers(0, 2 ** 32, (n_rows, 8), dtype=np.uint64).astype(np.uint32)


def test_knn2_match_matches_jax_with_ties():
    rng = np.random.default_rng(5)
    b = _descs(rng, 24)
    b[7] = b[3]                     # exact duplicate columns: tied best
    b[11] = b[3]
    a = _descs(rng, 16)
    a[0] = b[3]                     # best distance 0, tied three ways
    a[1] = b[20]
    a[1, 0] ^= np.uint32(0b111)     # distance 3 to column 20
    va = np.ones(16, bool)
    va[5] = False
    vb = np.ones(24, bool)
    vb[20] = False                  # the nearest column of row 1 is masked
    outj = jdesc.knn2_match(jnp.asarray(a), jnp.asarray(va), jnp.asarray(b),
                            jnp.asarray(vb))
    outt = tdesc.knn2_match(t(a), t(va), t(b), t(vb))
    for x, y in zip(outt, outj):
        np.testing.assert_array_equal(n(x), np.asarray(y))
    best, bd, sd = (n(x) for x in outt)
    assert best[0] == 3 and bd[0] == 0 and sd[0] == 0    # first of the tie
    assert best[1] != 20
    assert bd[5] == 257                                   # invalid row
