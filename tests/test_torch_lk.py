"""The LK iteration loop: the port's plain version against the JAX Pallas
kernel (interpret mode) and its XLA loop, and the wrapper's dispatch and
checks. The CUDA kernel itself is tested in test_torch_cuda.py.

Tolerances: against the Pallas kernel, test_pallas_lk.py's own (2e-3 px,
95% mask agreement: the kernel accumulates the patch in another order),
refined where the GN iteration itself does not settle: a point whose
convergence decision flips takes one more (sub-eps) step in one version, and
a point still iterating when the budget runs out has not converged at all
(its iterate oscillates and amplifies rounding). Points that stopped the
same way in both are held to 2e-3 px; every point is held to eps. Against
the XLA loop, which samples with the same hat-weight einsums, 1e-4 px and
99% agreement.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ov2slam_tpu.ops import klt as jklt
from ov2slam_tpu.ops import pallas_lk
from ov2slam_tpu_torch.ops import lk

from torch_parity import n, t
from test_pallas_lk import _setup, _xla_reference

WIN, EPS, MARGIN = 9, 0.01, 4.0


def assert_lk_close(p, a, c, p_ref, a_ref, c_ref, atol=2e-3, agree=0.95):
    p, a, c, p_ref, a_ref, c_ref = map(n, (p, a, c, p_ref, a_ref, c_ref))
    same = (a == a_ref) & (c == c_ref) & ~(a & a_ref)
    err = np.abs(p - p_ref).max(-1)
    assert err[same].max(initial=0.0) <= atol, err[same].max()
    assert err.max() <= EPS, err.max()
    assert (a == a_ref).mean() >= agree and (c == c_ref).mean() >= agree


def _torch_args(d):
    args = [t(d[k]) for k in ("nwin", "tmpl", "gx", "gy", "gxx", "gxy", "gyy",
                              "inv_det")]
    args.append(t(d["origins"], torch.int32))
    args += [t(d["ctr"]), t(d["pts"]), t(d["active"])]
    return args


@pytest.mark.parametrize("n_iters", [1, 10, 30])
def test_plain_matches_pallas_interpret(n_iters):
    d = _setup()
    p_pl, a_pl, c_pl = pallas_lk.lk_iterate(
        d["nwin"], d["tmpl"], d["gx"], d["gy"], d["gxx"], d["gxy"], d["gyy"],
        d["inv_det"], d["origins"], d["ctr"], d["pts"], d["active"], win=WIN,
        n_iters=n_iters, eps=EPS, margin=MARGIN, interpret=True)
    p, a, c = lk.lk_iterate_plain(*_torch_args(d), win=WIN, n_iters=n_iters,
                                  eps=EPS, margin=MARGIN)
    assert_lk_close(p, a, c, p_pl, a_pl, c_pl)


@pytest.mark.parametrize("n_iters", [1, 10])
def test_plain_matches_xla_loop(n_iters):
    d = _setup(seed=3, N=96)
    p_ref, a_ref, c_ref = _xla_reference(d, WIN, n_iters, EPS, MARGIN)
    p, a, c = lk.lk_iterate_plain(*_torch_args(d), win=WIN, n_iters=n_iters,
                                  eps=EPS, margin=MARGIN)
    assert_lk_close(p, a, c, p_ref, a_ref, c_ref, atol=1e-4, agree=0.99)


def test_sample_in_windows_matches_jax():
    rng = np.random.default_rng(7)
    wins = rng.uniform(0, 255, (3, 40, 20, 20)).astype(np.float32)
    pos = rng.uniform(-1.0, 20.0, (40, 2)).astype(np.float32)   # some outside
    np.testing.assert_allclose(
        n(lk.sample_in_windows(t(wins), t(pos), WIN)),
        n(jklt._sample_in_windows(jnp.asarray(wins), jnp.asarray(pos), WIN)),
        atol=1e-3)


def test_wrapper_runs_plain_on_cpu_without_launching():
    args = _torch_args(_setup(seed=1, N=32))
    before = lk.LAUNCHES
    out = lk.lk_iterate(*args, win=WIN, n_iters=10, eps=EPS, margin=MARGIN)
    ref = lk.lk_iterate_plain(*args, win=WIN, n_iters=10, eps=EPS, margin=MARGIN)
    assert lk.LAUNCHES == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["dtype", "shape", "origins_dtype", "layout"])
def test_wrapper_rejects_bad_arguments(bad):
    args = _torch_args(_setup(seed=2, N=16))
    if bad == "dtype":
        args[0] = args[0].double()
        err = TypeError
    elif bad == "shape":
        args[1] = args[1][:, :-1]
        err = ValueError
    elif bad == "origins_dtype":
        args[8] = args[8].long()
        err = TypeError
    else:
        args[10] = args[10].t().contiguous().t()
        err = ValueError
    with pytest.raises(err):
        lk.lk_iterate(*args, win=WIN, n_iters=5, eps=EPS, margin=MARGIN)
