"""BRIEF descriptors, Hamming distances and grid detection: the port against
the JAX package on a rendered 752x480 frame.

The descriptors are compared bit for bit in the (N, 8) word layout (the
port carries the uint32 words in int64). Grid detection compares the
selected pixels and validity exactly: both run the same float32 response
arithmetic, and a cell's argmax would flip only on a tie within rounding.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ov2slam_tpu.ops import describe as jdesc
from ov2slam_tpu.ops import detect as jdet
from ov2slam_tpu_torch.ops import describe as tdesc
from ov2slam_tpu_torch.ops import detect as tdet

import synthetic as syn
from torch_parity import n, t


@pytest.fixture(scope="module")
def frame():
    fl, _, _ = syn.render_sequence(n_frames=1, step=0.05)
    return fl[0]


def test_brief_pattern_is_the_same_draw():
    np.testing.assert_array_equal(tdesc.brief_pattern(), jdesc.brief_pattern())
    np.testing.assert_array_equal(tdesc._brief_select_matrix(),
                                  jdesc._brief_select_matrix())


@pytest.mark.parametrize("kind", ["grid", "random"])
def test_describe_brief_bit_identical(frame, kind):
    rng = np.random.default_rng(0)
    if kind == "grid":
        det = jdet.grid_select(jdet.min_eig_response(jnp.asarray(frame)),
                               jnp.zeros((4, 2)), jnp.zeros(4, bool), 35,
                               jnp.asarray(1e-4, jnp.float32))
        pts = np.asarray(det.points) + rng.uniform(0, 1, (det.points.shape[0], 2))
    else:   # includes border keypoints (ok = False) and sub-pixel offsets
        pts = np.stack([rng.uniform(0, 752, 300), rng.uniform(0, 480, 300)], -1)
    pts = pts.astype(np.float32)
    valid = rng.uniform(size=len(pts)) > 0.1
    dj, okj = jdesc.describe_brief(jnp.asarray(frame), jnp.asarray(pts),
                                   jnp.asarray(valid))
    dt, okt = tdesc.describe_brief(t(frame), t(pts), t(valid))
    np.testing.assert_array_equal(n(okt), n(okj))
    ok = n(okj)
    assert ok.sum() > 100
    np.testing.assert_array_equal(n(dt)[ok], np.asarray(dj).astype(np.int64)[ok])


def test_hamming_matrix_and_popcount():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2 ** 32, (40, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, (30, 8), dtype=np.uint64).astype(np.uint32)
    a[0] = 0xFFFFFFFF
    b[0] = 0
    hm = n(tdesc.hamming_matrix(t(a), t(b)))
    np.testing.assert_array_equal(hm, n(jdesc.hamming_matrix(jnp.asarray(a),
                                                             jnp.asarray(b))))
    assert hm[0, 0] == 256
    np.testing.assert_array_equal(
        n(tdesc.hamming_dist(t(a[:30]), t(b))),
        n(jdesc.hamming_dist(jnp.asarray(a[:30]), jnp.asarray(b))))


@pytest.mark.parametrize("cellsize,quality", [(45, 1e-3), (35, 1e-4)])
def test_grid_select_matches_jax(frame, cellsize, quality):
    rng = np.random.default_rng(2)
    kps = np.stack([rng.uniform(0, 752, 60), rng.uniform(0, 480, 60)],
                   -1).astype(np.float32)
    kv = rng.uniform(size=60) > 0.3
    rj = jdet.min_eig_response(jnp.asarray(frame))
    gj = jdet.grid_select(rj, jnp.asarray(kps), jnp.asarray(kv), cellsize,
                          jnp.asarray(quality, jnp.float32))
    gt = tdet.grid_select(tdet.min_eig_response(t(frame)), t(kps), t(kv),
                          cellsize, quality)
    for name in ("points", "valid", "points2", "valid2"):
        np.testing.assert_array_equal(n(getattr(gt, name)), n(getattr(gj, name)))
    np.testing.assert_allclose(n(gt.scores), n(gj.scores), rtol=1e-4, atol=1e-6)
    assert n(gt.valid).sum() > 20


@pytest.mark.parametrize("args,expect", [((1.0, 10, 100), 0.5),
                                         ((1.0, 95, 100), 1.5),
                                         ((1.0, 50, 100), 1.0),
                                         ((1.0, 5, 0), 1.0)])
def test_adaptive_quality_update(args, expect):
    assert tdet.adaptive_quality_update(*args) == expect
    assert jdet.adaptive_quality_update(*args) == expect
