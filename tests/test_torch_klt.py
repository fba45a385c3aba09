"""Forward-backward pyramidal KLT: the port against the JAX package on two
rendered 752x480 frames of the synthetic sequence, both fed the same
pyramids and gradient pyramids, float32 or float16 (the dtype both
packages' front ends store them in: windows gathered in float16, all
arithmetic in float32), or both computing the gradients themselves (stereo
matching passes none: the gradients are taken in float32 and stored in the
planes' dtype).

On CPU tensors ``fb_klt_tracking`` runs ``fb_klt_tracking_plain`` and
launches nothing; it checks its arguments on every device, as its kernel
wrapper does on the card.

Tolerance: tracked points to 1e-3 px and the status mask equal on at least
99% of points. Both sides run the same float32 GN arithmetic in another
summation order; LK converges to |delta| < 0.01 px, so 1e-3 px is an order
below what the tracker itself resolves.
"""

import ctypes

import numpy as np
import jax.numpy as jnp
import pytest
import torch

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


@pytest.mark.parametrize("pair,jitter", [("temporal", 0.0), ("temporal", 1.5),
                                         ("stereo", 0.0)])
def test_fb_klt_tracking_matches_jax_on_float16_pyramids(frames, pair, jitter):
    """Both packages fed the same float16 pyramids (the stereo call: without
    gradient pyramids, so each takes Scharr in float32 and stores float16)."""
    fl, fr = frames
    img0, img1 = (fl[0], fl[1]) if pair == "temporal" else (fl[0], fr[0])
    pj0, pj1, gj0, gj1, pts, prior, valid = _case(img0, img1, jitter)
    h = lambda seq: tuple(a.astype(jnp.float16) for a in seq)  # noqa: E731
    pj0, pj1 = h(pj0), h(pj1)
    gj0, gj1 = (tuple(h(g) for g in gj0), tuple(h(g) for g in gj1))
    gkw = {} if pair == "stereo" else dict(prev_grad_pyr=gj0, next_grad_pyr=gj1)
    rj = jklt.fb_klt_tracking(pj0, pj1, jnp.asarray(pts), jnp.asarray(prior),
                              jnp.asarray(valid), nlevels=3, win=9, **gkw)
    tp = lambda seq: tuple(torch.from_numpy(np.array(a)) for a in seq)  # noqa: E731
    tkw = {} if pair == "stereo" else dict(
        prev_grad_pyr=tuple(tp(g) for g in gj0),
        next_grad_pyr=tuple(tp(g) for g in gj1))
    p0, p1 = tp(pj0), tp(pj1)
    assert p0[0].dtype == torch.float16
    rt = tklt.fb_klt_tracking(p0, p1, t(pts), t(prior), t(valid), nlevels=3,
                              win=9, **tkw)
    st_j, st_t = n(rj.status), n(rt.status)
    assert st_j.sum() > 50
    assert (st_j == st_t).mean() >= 0.99
    both = st_j & st_t
    np.testing.assert_allclose(n(rt.points)[both], n(rj.points)[both], atol=1e-3)
    np.testing.assert_allclose(n(rt.error)[both], n(rj.error)[both], atol=1e-3)


def _torch_case(pj0, pj1, gj0, gj1, pts, prior, valid):
    tp = lambda seq: tuple(t(a) for a in seq)               # noqa: E731
    tg = lambda seq: tuple((t(a), t(b)) for a, b in seq)    # noqa: E731
    return (tp(pj0), tp(pj1), tg(gj0), tg(gj1), t(pts), t(prior), t(valid))


@pytest.mark.parametrize("pair,jitter,nlevels,grads", [
    ("stereo", 0.0, 3, False), ("temporal", 1.5, 0, True),
    ("temporal", 0.0, 0, False)])
def test_fb_klt_plain_matches_jax_variants(frames, pair, jitter, nlevels,
                                           grads):
    """The stereo call without gradient pyramids (the mapper's), and the
    single-level track (nlevels=0: the top level is level 0, so level 0 runs
    all the chunks)."""
    fl, fr = frames
    img0, img1 = (fl[0], fl[1]) if pair == "temporal" else (fl[0], fr[0])
    pj0, pj1, gj0, gj1, pts, prior, valid = _case(img0, img1, jitter)
    gkw = dict(prev_grad_pyr=gj0, next_grad_pyr=gj1) if grads else {}
    rj = jklt.fb_klt_tracking(pj0, pj1, jnp.asarray(pts), jnp.asarray(prior),
                              jnp.asarray(valid), nlevels=nlevels, win=9,
                              **gkw)
    tp0, tp1, tg0, tg1, tpts, tprior, tvalid = _torch_case(
        pj0, pj1, gj0, gj1, pts, prior, valid)
    tkw = dict(prev_grad_pyr=tg0, next_grad_pyr=tg1) if grads else {}
    rt = tklt.fb_klt_tracking_plain(tp0, tp1, tpts, tprior, tvalid,
                                    nlevels=nlevels, win=9, **tkw)
    st_j, st_t = n(rj.status), n(rt.status)
    assert st_j.sum() > 50
    assert (st_j == st_t).mean() >= 0.99
    both = st_j & st_t
    np.testing.assert_allclose(n(rt.points)[both], n(rj.points)[both], atol=1e-3)
    np.testing.assert_allclose(n(rt.error)[both], n(rj.error)[both], atol=1e-3)


@pytest.mark.parametrize("pair,jitter,grads", [
    ("temporal", 0.0, True), ("temporal", 1.5, True), ("stereo", 0.0, False)])
def test_fb_klt_tracking_on_cpu_is_the_plain_version(frames, pair, jitter,
                                                     grads):
    fl, fr = frames
    img0, img1 = (fl[0], fl[1]) if pair == "temporal" else (fl[0], fr[0])
    p0, p1, g0, g1, pts, prior, valid = _torch_case(*_case(img0, img1, jitter))
    kw = dict(prev_grad_pyr=g0, next_grad_pyr=g1) if grads else {}
    before = tklt.LAUNCHES
    r = tklt.fb_klt_tracking(p0, p1, pts, prior, valid, nlevels=3, **kw)
    rp = tklt.fb_klt_tracking_plain(p0, p1, pts, prior, valid, nlevels=3, **kw)
    assert tklt.LAUNCHES == before
    assert n(r.status).sum() > 50
    for a, b in zip(r, rp):
        assert torch.equal(a, b)


def _small_case(H=96, W=128, nlevels=1, N=5):
    rng = np.random.default_rng(3)
    pyr = [torch.from_numpy(rng.uniform(0, 255, (H >> l, W >> l))
                            .astype(np.float32)) for l in range(nlevels + 1)]
    pts = torch.from_numpy(rng.uniform(20, 40, (N, 2)).astype(np.float32))
    return pyr, [a + 1.0 for a in pyr], pts, torch.ones(N, dtype=torch.bool)


def _noncontiguous(a):
    return a.t().contiguous().t()


@pytest.mark.parametrize("bad", ["noncontiguous", "float64", "mixed", "device",
                                 "grad_device", "shape", "win17"])
def test_fb_klt_tracking_rejects_what_the_kernel_does_not_take(bad):
    """The kernel takes float16 or float32 planes, one dtype per call."""
    p0, p1, pts, valid = _small_case()
    kw = dict(nlevels=1)
    if bad == "noncontiguous":
        p1[1] = _noncontiguous(p1[1])
    elif bad == "float64":
        p0, p1 = [a.double() for a in p0], [a.double() for a in p1]
    elif bad == "mixed":
        p1[1] = p1[1].half()
    elif bad == "device":
        p1[0] = p1[0].to("meta")
    elif bad == "grad_device":
        kw["prev_grad_pyr"] = [(a, a.to("meta")) for a in p0]
    elif bad == "shape":
        p1[0] = p1[0][:, :-1].contiguous()
    else:
        kw["win"] = 17
    with pytest.raises((TypeError, ValueError)):
        tklt.fb_klt_tracking(p0, p1, pts, pts, valid, **kw)


@pytest.mark.parametrize("short", ["prev_pyr", "next_pyr", "prev_grad_pyr"])
def test_level_table_rejects_a_short_pyramid(short):
    p0, p1, _, _ = _small_case(nlevels=2)
    grads = [(a, a) for a in p0]
    args = dict(prev_pyr=p0, next_pyr=p1, prev_grad_pyr=grads)
    args[short] = args[short][:2]
    with pytest.raises(ValueError, match="levels"):
        tklt.level_table(args["prev_pyr"], args["next_pyr"],
                         args["prev_grad_pyr"], grads[0], nlevels=2, win=9,
                         device=torch.device("cpu"))


def test_level_table_layout():
    """The ctypes table names every plane it is given with its pointer,
    shape and row stride, and leaves the rest null."""
    p0, p1, _, _ = _small_case(nlevels=2)
    grads = [(a + 2.0, a + 3.0) for a in p0]
    tbl = tklt.level_table(p0, p1, grads, grads[0], nlevels=2, win=9,
                           device=torch.device("cpu"))
    # the planes, then the element size (padded to the planes' alignment)
    assert ctypes.sizeof(tbl) == (4 * tklt.MAX_LEVELS + 2) * 24 + 8
    assert tbl.elem_bytes == 4
    half = [a.half() for a in p0]
    assert tklt.level_table(half, [a.half() for a in p1], None, None,
                            nlevels=2, win=9,
                            device=torch.device("cpu")).elem_bytes == 2
    for lvl in range(3):
        for plane, a in ((tbl.prev_img[lvl], p0[lvl]),
                         (tbl.next_img[lvl], p1[lvl]),
                         (tbl.prev_gx[lvl], grads[lvl][0]),
                         (tbl.prev_gy[lvl], grads[lvl][1])):
            assert (plane.data, plane.h, plane.w, plane.stride) == (
                a.data_ptr(), a.shape[0], a.shape[1], a.shape[1])
    assert tbl.next_gy0.data == grads[0][1].data_ptr()
    assert not tbl.prev_img[3].data and not tbl.next_img[tklt.MAX_LEVELS - 1].data
