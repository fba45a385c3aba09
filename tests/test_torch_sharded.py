"""The multi-device path (``ov2slam_tpu_torch/parallel/sharded.py``) on
virtual CPU meshes, against the JAX package's on its virtual 8-device CPU
mesh (``tests/conftest.py``) and against the port's own single-device
solvers.

Tolerances: the sharded BA against either solver as
``tests/test_sharded.py`` holds the JAX package's (poses to 1e-4, landmarks
to 1e-3 m, >= 99% of inliers equal): the same algorithm with the normal
equations summed in another order. The sharded RANSAC scores the same
per-shard sample indices as the JAX package's, so its winner, count and
inliers are equal. The whole system at ``n_devices = 8`` is held to the
JAX package's at 8 within 1 mm per frame (the slice's parity bound,
``tests/test_torch_e2e.py``) and to the port's single-device run within
2 mm, the JAX package's own bound for that pair.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov2slam_tpu.config import SlamParams as JParams
from ov2slam_tpu.core import lie as jlie
from ov2slam_tpu.opt import ba as jba
from ov2slam_tpu.parallel import sharded as jsh
from ov2slam_tpu.slam.manager import SlamSystem as JSlam
from ov2slam_tpu_torch import interop
from ov2slam_tpu_torch.config import SlamParams
from ov2slam_tpu_torch.opt import ba as tba
from ov2slam_tpu_torch.parallel import sharded as tsh
from ov2slam_tpu_torch.slam.manager import SlamSystem

import synthetic as syn
from test_opt import make_ba_problem
from torch_parity import n, t

N_DEV = 8
CPU8 = tsh.make_mesh(N_DEV, device="cpu")


def test_make_mesh(monkeypatch):
    """Virtual CPU shards, an explicit list (a virtual mesh on one card),
    and the cards, where fewer than asked raise naming the count and
    nothing falls back to the CPU."""
    assert CPU8 == (torch.device("cpu"),) * N_DEV
    assert tsh.make_mesh(2, devices=["cuda:0"] * 4) == (torch.device("cuda", 0),) * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tsh.make_mesh(2) == (torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(ValueError, match=r"make_mesh\(4\) but only 2 CUDA"):
        tsh.make_mesh(4)
    d = syn.slam_params_dict()
    d["n_devices"] = 4
    with pytest.raises(ValueError, match=r"make_mesh\(4\) but only 2 CUDA"):
        SlamSystem(SlamParams.from_dict(d), device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="only 0 CUDA"):
        tsh.make_mesh()


@pytest.fixture(scope="module")
def padded_problem():
    """tests/test_opt.py's BA problem, its observations padded to a
    multiple of 8 with invalid ones (as tests/test_sharded.py pads it)."""
    prob, _, _, _, n_lm = make_ba_problem(np.random.default_rng(21))
    pad = -prob.obs_kf.shape[0] % N_DEV

    def padv(x, fill=0):
        return jnp.concatenate(
            [x, jnp.full((pad,) + x.shape[1:], fill, x.dtype)])

    return prob._replace(
        obs_kf=padv(prob.obs_kf), obs_lm=padv(prob.obs_lm),
        obs_px=padv(prob.obs_px), obs_right=padv(prob.obs_right, False),
        obs_valid=padv(prob.obs_valid, False)), n_lm


def _close(a, b, n_lm):
    np.testing.assert_allclose(n(a.R), n(b.R), atol=1e-4)
    np.testing.assert_allclose(n(a.t), n(b.t), atol=1e-4)
    np.testing.assert_allclose(n(a.Xw)[:n_lm], n(b.Xw)[:n_lm], atol=1e-3)
    assert (n(a.obs_inlier) == n(b.obs_inlier)).mean() >= 0.99


def _spy(monkeypatch, mod, calls):
    """Record the method of every ``_lm_run`` call of `mod` (LM when the
    caller passes none)."""
    real = mod._lm_run
    sig = inspect.signature(real)

    def spy(*a, **kw):
        calls.append(sig.bind(*a, **kw).arguments.get("method", "lm"))
        return real(*a, **kw)

    monkeypatch.setattr(mod, "_lm_run", spy)


@pytest.mark.parametrize("case", ["robust_lm", "l2_dogleg", "l2_lm"])
def test_sharded_ba_matches_jax_and_single(padded_problem, monkeypatch, case):
    """The robust LM solve, and the robust->L2 composition under dogleg
    and LM, on 8 CPU shards against the JAX package's 8-device solve. The
    L2 re-solve of both runs LM whatever the method (ROADMAP C/R5): the
    spies record (dogleg, lm) under dogleg in both packages, where the
    port's solve_ba runs dogleg twice."""
    prob, n_lm = padded_problem
    kw = (dict(max_iters=6) if case == "robust_lm" else dict(
        max_iters=5, l2_refine=True, l2_iters=3, method=case[3:]))
    jcalls, tcalls = [], []
    if case == "l2_dogleg":
        _spy(monkeypatch, jba, jcalls)
        _spy(monkeypatch, tba, tcalls)
        jsh._solve_ba_sharded_impl.clear_cache()
    oj = jsh.solve_ba_sharded(prob, jsh.make_mesh(N_DEV), invdepth=True, **kw)
    tp = interop.ba_problem(prob)
    ot = tsh.solve_ba_sharded(tp, CPU8, invdepth=True, **kw)
    if case == "l2_dogleg":
        jsh._solve_ba_sharded_impl.clear_cache()
        assert jcalls == ["dogleg", "lm"] and tcalls == ["dogleg", "lm"]
        tcalls.clear()
        tba.solve_ba(tp, invdepth=True, **kw)
        assert tcalls == ["dogleg", "dogleg"]
    assert float(ot.cost) < 0.2 * float(ot.cost0)
    _close(ot, oj, n_lm)
    if case == "robust_lm":
        _close(ot, tba.solve_ba(tp, invdepth=True, **kw), n_lm)


def test_sharded_essential_ransac_matches_jax():
    """The JAX package's scene of tests/test_sharded.py (160 bearings, 40
    outliers); each shard scores the indices the JAX package's shard draws
    from its key (``jax.random.split(key, 8)``, then ``mvg.py``'s
    ``jax.random.choice``). The same shard wins, with the same count and
    inliers, and the model equals it to float32 rounding."""
    rng = np.random.default_rng(22)
    N, K = 160, 64
    Xc = rng.uniform(-3, 3, size=(N, 3)).astype(np.float32)
    Xc[:, 2] = 6.0 + rng.uniform(0, 3, N)
    w = rng.normal(size=3).astype(np.float32) * 0.2
    tr = rng.normal(size=3).astype(np.float32)
    T_ab = jlie.SE3(jlie.so3_exp(jnp.asarray(w)), jnp.asarray(tr))
    Xb = np.asarray(jlie.se3_apply(jlie.se3_inverse(T_ab), jnp.asarray(Xc)))
    bv_a = (Xc / np.linalg.norm(Xc, axis=1, keepdims=True)).astype(np.float32)
    bv_b = (Xb / np.linalg.norm(Xb, axis=1, keepdims=True)).astype(np.float32)
    out_idx = rng.choice(N, 40, replace=False)
    bv_b[out_idx] = bv_b[rng.permutation(out_idx)]
    valid = np.ones(N, bool)
    key, err_th = jax.random.PRNGKey(3), 3.0 / 450.0
    rj = jsh.essential_ransac_sharded(
        jnp.asarray(bv_a), jnp.asarray(bv_b), jnp.asarray(valid), key,
        err_th=err_th, mesh=jsh.make_mesh(N_DEV), n_hyps_per_device=K)
    p = jnp.asarray(valid, jnp.float32) / N
    idx = [t(jax.random.choice(k, N, shape=(K, 5), p=p))
           for k in jax.random.split(key, N_DEV)]
    rt = tsh.essential_ransac_sharded(t(bv_a), t(bv_b), t(valid), err_th,
                                      CPU8, idx=idx)
    assert bool(rt.success) and bool(rj.success)
    assert int(rt.n_inliers) == int(rj.n_inliers)
    np.testing.assert_array_equal(n(rt.inliers), n(rj.inliers))
    np.testing.assert_allclose(n(rt.model), n(rj.model), atol=1e-4)
    # drawn from a generator instead (2 shards): test_sharded.py's inliers
    gen = torch.Generator().manual_seed(0)
    rg = tsh.essential_ransac_sharded(t(bv_a), t(bv_b), t(valid), err_th,
                                      CPU8[:2], gen=gen, n_hyps_per_device=K)
    inlier = np.ones(N, bool)
    inlier[out_idx] = False
    assert bool(rg.success) and n(rg.inliers)[inlier].mean() > 0.8


def test_slam_system_with_sharded_ba():
    """The whole SlamSystem at n_devices = 8 (every local BA on 8 CPU
    shards) over tests/test_sharded.py's 25 frames: within 1 mm of the JAX
    package's at 8, and within 2 mm of the port's single-device run."""
    fl, fr, _ = syn.render_sequence(n_frames=25, step=0.05)

    def run(slam):
        est = [slam.process_stereo(a, b, i * 0.05)[:3, 3].copy()
               for i, (a, b) in enumerate(zip(fl, fr))]
        assert slam.initialized
        return np.stack(est), slam.map.n_3d()

    def params(cls, n_devices):
        d = syn.slam_params_dict()
        d["n_devices"] = n_devices
        return cls.from_dict(d)

    ts = SlamSystem(params(SlamParams, N_DEV), device="cpu")
    assert ts.mesh == CPU8 and ts.estimator.mesh is ts.mesh
    t8, n3d = run(ts)
    j8, _ = run(JSlam(params(JParams, N_DEV)))
    t0, n3d0 = run(SlamSystem(params(SlamParams, 0), device="cpu"))
    assert np.abs(t8 - j8).max() < 1e-3, np.abs(t8 - j8).max()
    assert np.abs(t8 - t0).max() < 2e-3, np.abs(t8 - t0).max()
    assert abs(n3d - n3d0) < 0.1 * max(n3d0, 1)
