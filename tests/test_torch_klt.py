"""Forward-backward pyramidal KLT: the port against the JAX package on two
rendered 752x480 frames of the synthetic sequence, both fed the same float32
pyramids and gradient pyramids (the JAX package's own state stores float16;
that storage difference is not the port's to answer for here).

Tolerance: tracked points to 1e-3 px and the status mask equal on at least
99% of points. Both sides run the same float32 GN arithmetic in another
summation order; LK converges to |delta| < 0.01 px, so 1e-3 px is an order
below what the tracker itself resolves.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ov2slam_tpu.ops import detect as jdet
from ov2slam_tpu.ops import image as jim
from ov2slam_tpu.ops import klt as jklt
from ov2slam_tpu_torch.ops import klt as tklt

import synthetic as syn
from torch_parity import n, t


@pytest.fixture(scope="module")
def frames():
    fl, fr, _ = syn.render_sequence(n_frames=2, step=0.05)
    return fl, fr


def _case(img0, img1, jitter=0.0, seed=0):
    pj0 = tuple(jim.build_pyramid(jnp.asarray(img0), 3))
    pj1 = tuple(jim.build_pyramid(jnp.asarray(img1), 3))
    gj0 = tuple(jim.scharr_gradients(a) for a in pj0)
    gj1 = tuple(jim.scharr_gradients(a) for a in pj1)
    det = jdet.grid_select(jdet.min_eig_response(jnp.asarray(img0)),
                           jnp.zeros((4, 2)), jnp.zeros(4, bool), 45,
                           jnp.asarray(1e-4, jnp.float32))
    pts = np.asarray(det.points)
    valid = np.asarray(det.valid)
    rng = np.random.default_rng(seed)
    prior = (pts + rng.normal(0, jitter, pts.shape)).astype(np.float32)
    return pj0, pj1, gj0, gj1, pts, prior, valid


@pytest.mark.parametrize("pair,jitter", [("temporal", 0.0), ("temporal", 1.5),
                                         ("stereo", 0.0)])
def test_fb_klt_tracking_matches_jax(frames, pair, jitter):
    fl, fr = frames
    img0, img1 = (fl[0], fl[1]) if pair == "temporal" else (fl[0], fr[0])
    pj0, pj1, gj0, gj1, pts, prior, valid = _case(img0, img1, jitter)
    rj = jklt.fb_klt_tracking(pj0, pj1, jnp.asarray(pts), jnp.asarray(prior),
                              jnp.asarray(valid), nlevels=3, win=9,
                              prev_grad_pyr=gj0, next_grad_pyr=gj1)
    tp = lambda seq: tuple(t(a) for a in seq)               # noqa: E731
    tg = lambda seq: tuple((t(a), t(b)) for a, b in seq)    # noqa: E731
    rt = tklt.fb_klt_tracking(tp(pj0), tp(pj1), t(pts), t(prior), t(valid),
                              nlevels=3, win=9, prev_grad_pyr=tg(gj0),
                              next_grad_pyr=tg(gj1))
    st_j, st_t = n(rj.status), n(rt.status)
    assert st_j.sum() > 50                      # a real tracking problem
    assert (st_j == st_t).mean() >= 0.99
    both = st_j & st_t
    np.testing.assert_allclose(n(rt.points)[both], n(rj.points)[both], atol=1e-3)
    np.testing.assert_allclose(n(rt.error)[both], n(rj.error)[both], atol=1e-3)
