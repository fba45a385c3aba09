"""Multi-device solves: observation-sharded bundle adjustment and
hypothesis-sharded essential RANSAC (port of
``ov2slam_tpu/parallel/sharded.py``).

A mesh is an ordered tuple of ``torch.device``s; the first, the lead, holds
the solve. The JAX package runs both functions under ``shard_map`` with
XLA collectives; here each shard's work is issued on its own device and
the shards' results are combined on the lead:

* ``solve_ba_sharded``: each shard builds the normal equations of a
  contiguous slice of the observations, and they are summed on the lead in
  shard order (the ``psum``), so a run repeats bit for bit. The Schur solve
  and every accept/reject then run once, on the lead (JAX runs them
  replicated on every device, with the same result).
* ``essential_ransac_sharded``: each shard scores its own hypothesis batch;
  the model with the most inliers wins (the first, on a tie).

A mesh of distinct cards overlaps the shards' work. A virtual mesh (n CPU
shards, or n shards on one card) runs the same code and changes only the
order of the sums: the counterpart of the JAX package's virtual CPU mesh.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from ov2slam_tpu_torch.device import select
from ov2slam_tpu_torch.ops import mvg
from ov2slam_tpu_torch.opt import ba as ba_mod
from ov2slam_tpu_torch.opt.ba import BAProblem, BAResult

Mesh = Tuple[torch.device, ...]
OBS_FIELDS = ("obs_kf", "obs_lm", "obs_px", "obs_right", "obs_valid")


def make_mesh(n_devices: Optional[int] = None,
              device: Union[str, torch.device, None] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """The mesh of `n_devices` shards.

    By default the first n CUDA cards (all of them when n is None); fewer
    cards than n raise, as the JAX package's ``make_mesh`` does, and
    nothing falls back to the CPU. ``device="cpu"`` gives n virtual CPU
    shards; ``devices=`` an explicit list (``["cuda:0"] * n`` is a virtual
    mesh on one card), of which the first n are taken."""
    if devices is not None:
        mesh = tuple(torch.device(d) for d in devices)
        n = len(mesh) if n_devices is None else int(n_devices)
        if not 1 <= n <= len(mesh):
            raise ValueError(f"make_mesh({n}) from {len(mesh)} devices")
        return mesh[:n]
    kind = torch.device(device).type if device is not None else "cuda"
    if kind == "cpu":
        n = 1 if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"make_mesh({n}): a mesh needs a shard")
        return (torch.device("cpu"),) * n
    if kind != "cuda":
        raise ValueError(f"make_mesh: no mesh of {kind!r} devices")
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = avail if n_devices is None else int(n_devices)
    if n < 1 or avail < n:
        raise ValueError(
            f"make_mesh({n}) but only {avail} CUDA devices are available; "
            f"for a virtual mesh on one card pass devices=['cuda:0'] * {n}, "
            f"for virtual CPU shards device='cpu'")
    return tuple(torch.device("cuda", i) for i in range(n))


def _problem_to(p: BAProblem, dev: torch.device) -> BAProblem:
    return p._replace(**{k: getattr(p, k).to(dev) for k in (
        "R", "t", "pose_opt", "Xw", "anchor", "bearing", "lam", "lm_valid")
        + OBS_FIELDS}, T_rl=ba_mod.SE3(p.T_rl.R.to(dev), p.T_rl.t.to(dev)))


def pad_observations(p: BAProblem, n: int) -> BAProblem:
    """p with its observations padded to a multiple of n with invalid ones
    (index 0, obs_valid False), as the JAX package's estimator pads them."""
    k = -int(p.obs_kf.shape[0]) % n
    if not k:
        return p

    def pad(a):
        return torch.cat([a, a.new_zeros((k,) + a.shape[1:])])

    return p._replace(**{f: pad(getattr(p, f)) for f in OBS_FIELDS})


def shard_problem(p: BAProblem, mesh: Mesh):
    """Per-shard problems: the observations split into len(mesh) contiguous
    equal slices (JAX's ``P(axis)``), each with the rest of p, on its
    device. The observation count must divide the mesh size (pad with
    obs_valid False)."""
    n = len(mesh)
    O = int(p.obs_kf.shape[0])
    if O % n:
        raise ValueError(f"{O} observations do not split into {n} shards; "
                         "pad them with obs_valid False")
    k = O // n
    return [_problem_to(p._replace(**{f: getattr(p, f)[i * k:(i + 1) * k]
                                      for f in OBS_FIELDS}), d)
            for i, d in enumerate(mesh)]


def solve_ba_sharded(p: BAProblem, mesh: Mesh, invdepth: bool = True,
                     max_iters: int = 5, robust: bool = True,
                     th2_mono: float = 5.9915, th2_stereo: float = 7.8147,
                     l2_refine: bool = False, l2_iters: int = 5,
                     method: str = "lm") -> BAResult:
    """Observation-sharded Schur-LM (or dogleg) bundle adjustment over
    `mesh`: the algorithm of ``opt.ba.solve_ba`` (accept/reject, Huber
    IRLS, chi2/depth sweep, optional robust->L2 re-solve) with the normal
    equations built per shard and summed on the lead. The result is on the
    lead; obs_inlier in observation order.

    As in the JAX package, the L2 re-solve runs LM whatever `method` is
    (its ``_lm_run`` call passes no method), where ``solve_ba`` runs it
    with `method` (ROADMAP C/R5); kept for parity."""
    if method not in ("lm", "dogleg"):
        raise ValueError(f"solve_ba_sharded: unknown method {method!r}")
    lead = mesh[0]
    p = _problem_to(p, lead)
    shards = shard_problem(p, mesh)
    out = ba_mod._lm_run(p, p.R, p.t, p.Xw, p.lam, robust, invdepth,
                         max_iters, th2_mono, th2_stereo, 1e-4, method,
                         shards=shards)
    if l2_refine:
        k = int(p.obs_kf.shape[0]) // len(mesh)
        inl = out.obs_inlier
        shards2 = [s._replace(obs_valid=inl[i * k:(i + 1) * k].to(d))
                   for i, (s, d) in enumerate(zip(shards, mesh))]
        out2 = ba_mod._lm_run(p._replace(obs_valid=inl), out.R, out.t,
                              out.Xw, out.lam, False, invdepth, l2_iters,
                              th2_mono, th2_stereo, 1e-4, shards=shards2)
        out = BAResult(out2.R, out2.t, out2.Xw, out2.lam,
                       out2.obs_inlier & out.obs_inlier, out.cost0,
                       out2.cost, out.n_iters + out2.n_iters)
    return out


def essential_ransac_sharded(bv_a: torch.Tensor, bv_b: torch.Tensor,
                             valid: torch.Tensor, err_th: float, mesh: Mesh,
                             idx=None, gen: Optional[torch.Generator] = None,
                             n_hyps_per_device: int = 256
                             ) -> mvg.RansacResult:
    """Hypothesis-sharded essential RANSAC (5-point): shard i scores the
    sample indices ``idx[i]`` ((K, 5) each; drawn per shard from `gen` by
    ``mvg.draw_samples`` when idx is None) with ``mvg.essential_ransac``
    on its device; the model, inliers and count of the shard with the most
    inliers win (the first such shard, as ``jnp.argmax``), on the lead.
    success is count >= 8."""
    lead = mesh[0]
    if idx is None:
        idx = [mvg.draw_samples(valid, n_hyps_per_device, 5, gen)
               for _ in mesh]
    res = [mvg.essential_ransac(bv_a.to(d), bv_b.to(d), valid.to(d), err_th,
                                idx=i.to(d))
           for d, i in zip(mesh, idx)]
    counts = torch.stack([r.n_inliers.to(lead) for r in res])
    best = torch.argmax(counts)
    model = select(torch.stack([r.model.to(lead) for r in res]), best)
    inliers = select(torch.stack([r.inliers.to(lead) for r in res]), best)
    count = select(counts, best)
    return mvg.RansacResult(model, inliers, count, count >= 8)
