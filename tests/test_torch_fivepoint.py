"""Parity of the port's 5-point solver and essential-matrix RANSAC
(``ops/fivepoint.py``, ``ops/mvg.py::essential_ransac``) with the JAX
package, on the scenes of ``tests/test_fivepoint.py``.

The 5-point solver's valid outputs are compared as sets, not slot by slot:
the nullspace basis from the Jacobi eigh differs between the packages by
float32 rounding (~1e-4, see ``test_torch_smallalg.py``), and which real
roots of det B(z) the float32 grid scan and its fixed seeds land on, and
how many duplicates fill the 10 slots, follows from that basis. So on 20
minimal and 10 planar samples both packages must (a) return only genuine
solutions: in float64, singular values (s, s, 0) to 1e-3 and the 5
epipolar residuals below 1e-5; (b) recover the ground-truth E (to 0.02,
the bound of ``test_fivepoint.py``) on at least as many samples as that
test demands (14 of 20, 8 of 10), the port on at least as many as the
JAX package less one; (c) at least 75% of either package's valid models
are among the other's valid models of the same sample, to 1e-2 (measured:
85% / 87% on the minimal samples, 89% / 87% on the planar ones; every
other model is a genuine root the other package's scan missed).

The RANSACs get the sample indices JAX draws exactly as ``mvg.py:227`` /
``:236`` do (``jax.random.choice`` with p = valid / sum). Inlier masks
agree on at least 99% of points (97% for the 8-point solver, whose 8x8
nullspace is ill-conditioned on noisy data); the decomposed rotation
within 1e-3 rad and the translation direction within 1e-2 rad (8-point:
1e-2 and 2e-2).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ov2slam_tpu.ops import mvg as jmvg
from ov2slam_tpu.ops.fivepoint import five_point_essential as jfive
from ov2slam_tpu_torch.ops import mvg as tmvg
from ov2slam_tpu_torch.ops.fivepoint import five_point_essential as tfive

import test_fivepoint as tf
from torch_parity import n, t


def _samples(seed, trials, scene, npts, **pose_kw):
    RNG = np.random.default_rng(seed)
    xa, xb, Eg = [], [], []
    for _ in range(trials):
        X = scene(RNG, npts)
        T_ab = tf._pose(RNG, **pose_kw)
        bv_a, bv_b = tf._correspondences(RNG, X, T_ab)
        xa.append((bv_a / bv_a[:, 2:])[:5])
        xb.append((bv_b / bv_b[:, 2:])[:5])
        E = np.array(jmvg.essential_from_pose(T_ab))
        Eg.append(E / np.linalg.norm(E))
    return (np.stack(xa).astype(np.float32), np.stack(xb).astype(np.float32),
            np.stack(Eg))


def _dist(E, F):
    return min(np.abs(E - F).max(), np.abs(E + F).max())


def _check_models(Es, valid, xa, xb, Eg):
    """Genuineness of every valid model; per-sample ground-truth recovery."""
    recovered = []
    for i in range(len(Es)):
        best = np.inf
        for k in np.nonzero(valid[i])[0]:
            E = Es[i, k].astype(np.float64)
            sv = np.linalg.svd(E, compute_uv=False)
            assert sv[2] / sv[0] < 1e-3 and (sv[0] - sv[1]) / sv[0] < 1e-3, sv
            res = np.einsum("ni,ij,nj->n", xa[i].astype(np.float64), E,
                            xb[i].astype(np.float64))
            assert np.abs(res).max() < 1e-5, res
            best = min(best, _dist(Es[i, k] / np.linalg.norm(Es[i, k]), Eg[i]))
        recovered.append(best < 0.02)
    return np.asarray(recovered)


@pytest.fixture(scope="module")
def five_point_cases():
    """20 minimal samples of a general scene and 10 of a plane, solved by
    both packages (one JAX compile for both)."""
    cases = {"minimal": _samples(7, 20, tf._general_scene, 5) + (14,),
             "planar": _samples(3, 10, tf._planar_scene, 8, tscale=0.8,
                                wscale=0.15) + (8,)}
    xa = np.concatenate([c[0] for c in cases.values()])
    xb = np.concatenate([c[1] for c in cases.values()])
    Ej, vj = (n(a) for a in jax.vmap(jfive)(jnp.asarray(xa), jnp.asarray(xb)))
    out, i = {}, 0
    for name, (a, b, Eg, need) in cases.items():
        sl = slice(i, i + len(a))
        out[name] = (a, b, Eg, need, Ej[sl], vj[sl])
        i += len(a)
    return out


def _shared_share(Es, valid, Fs, fvalid):
    """Share of the valid models of Es found (to 1e-2) among the valid
    models of Fs, sample by sample."""
    hit = tot = 0
    for i in range(len(Es)):
        F = [Fs[i, m] for m in np.nonzero(fvalid[i])[0]]
        for k in np.nonzero(valid[i])[0]:
            tot += 1
            hit += min((_dist(Es[i, k], f) for f in F), default=np.inf) < 1e-2
    return hit / max(tot, 1)


@pytest.mark.parametrize("case", ["minimal", "planar"])
def test_five_point_model_sets_match_jax(five_point_cases, case):
    xa, xb, Eg, need, Ej, vj = five_point_cases[case]
    Et, vt = (n(a) for a in tfive(t(xa), t(xb)))
    assert Et.shape == (len(xa), 10, 3, 3) and vt.shape == (len(xa), 10)
    rec_j = _check_models(Ej, vj, xa, xb, Eg)
    rec_t = _check_models(Et, vt, xa, xb, Eg)
    assert rec_j.sum() >= need and rec_t.sum() >= need, (rec_j, rec_t)
    assert rec_t.sum() >= rec_j.sum() - 1, (rec_j, rec_t)
    assert _shared_share(Et, vt, Ej, vj) >= 0.75
    assert _shared_share(Ej, vj, Et, vt) >= 0.75


def _outlier_scene(seed, n_out, noise_px=0.3):
    RNG = np.random.default_rng(seed)
    N = 200
    X = tf._general_scene(RNG, N)
    T_ab = tf._pose(RNG, tscale=1.0, wscale=0.3)
    bv_a, bv_b = tf._correspondences(RNG, X, T_ab, noise_px=noise_px)
    bv_b = np.array(bv_b)
    out_idx = RNG.choice(N, n_out, replace=False)
    bv_b[out_idx] = tf.bearings_of(tf._general_scene(RNG, n_out))
    valid = np.ones(N, bool)
    valid[:6] = False                   # some invalid entries, never drawn
    return bv_a.astype(np.float32), bv_b.astype(np.float32), valid


def _angle(R):
    return float(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))


@pytest.mark.parametrize("solver,lmeds,K", [("nister", False, 48),
                                            ("8pt", False, 64),
                                            ("nister", True, 32)])
def test_essential_ransac_with_jax_indices(solver, lmeds, K):
    bv_a, bv_b, valid = _outlier_scene(23, 60 if not lmeds else 40)
    N = len(valid)
    key = jax.random.PRNGKey(5)
    p = valid.astype(np.float32)
    p = p / max(p.sum(), 1.0)
    s = 5 if solver == "nister" else 8
    idx = np.asarray(jax.random.choice(key, N, shape=(K, s), p=jnp.asarray(p)))
    rj = jmvg.essential_ransac(
        jnp.asarray(bv_a), jnp.asarray(bv_b), jnp.asarray(valid), key,
        err_th=3.0 / 450.0, n_hyps=K, solver=solver, lmeds=lmeds)
    rt = tmvg.essential_ransac(t(bv_a), t(bv_b), t(valid), 3.0 / 450.0,
                               idx=t(idx), solver=solver, lmeds=lmeds)
    agree = 0.97 if solver == "8pt" else 0.99
    assert bool(rt.success) and bool(rj.success)
    assert (n(rt.inliers) == n(rj.inliers)).mean() >= agree
    assert not n(rt.inliers)[~valid].any()
    Tj = jmvg.decompose_essential(rj.model, jnp.asarray(bv_a), jnp.asarray(bv_b),
                                  rj.inliers)
    Tt = tmvg.decompose_essential(rt.model, t(bv_a), t(bv_b), rt.inliers)
    rot_tol, dir_tol = (1e-2, 2e-2) if solver == "8pt" else (1e-3, 1e-2)
    assert _angle(n(Tt.R).T @ n(Tj.R)) < rot_tol
    cos = abs(float(n(Tt.t) @ n(Tj.t)))
    assert np.arccos(min(cos, 1.0)) < dir_tol


def test_draw_samples_distribution():
    """Production draws: only valid entries, with replacement, seeded."""
    import torch
    valid = np.zeros(50, bool)
    valid[[3, 7, 20, 41]] = True
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(0)
    g2.manual_seed(0)
    a = tmvg.draw_samples(t(valid), 64, 5, g1)
    b = tmvg.draw_samples(t(valid), 64, 5, g2)
    assert a.shape == (64, 5) and torch.equal(a, b)
    assert set(n(a).ravel()) == {3, 7, 20, 41}
    # no valid entry: uniform draws (the caller's result then fails)
    c = tmvg.draw_samples(t(np.zeros(50, bool)), 16, 3, g1)
    assert c.shape == (16, 3) and int(c.max()) < 50
