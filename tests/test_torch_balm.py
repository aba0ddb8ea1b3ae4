"""PyTorch port vs the JAX package: the bundle-adjustment factors.

`PlaneEVMFactor`, `EdgeEVMFactor` and `LsqBAFactor` on chip_smoke.py's
phase-30 problem cut to 3 keyframes (`ba_problem`: the ring scene's plane
and edge clouds, 4 plane and 2 edge features, each seen from at least 3
keyframes, the poses noised by sigma 0.03). Three keyframes keep JAX's
compile of the LM short; with the priors on keys 0 and 1, one pose is
free, which the plane-only LSQ problem holds firmly enough for both
packages to land together.

- `make_evm_factor` and `make_lsq_ba_factor` give both packages the same
  fields (interop's converters carry them across bit for bit);
- `multi_linearize` at the noised poses within 1e-4 x max|ref| of JAX's,
  its error within 1e-5 relative (EVM); `error` (the smallest eigenvalue,
  or the two smallest, of the scatter) on a batch of pose sets against
  `jax.vmap`, and the LSQ factor's `multi_linearize` error (a sum of
  vᵀ C_k v over its keyframes' covariances), within 1e-5 of the scatter's
  trace: float32 resolves a small eigenvalue only to the precision of the
  largest, and an edge's lambda_0 + lambda_1 is about 1/160 of its lambda_2
  here, so each package's float32 value lies up to 2.4e-5 of itself from
  the float64 one (both measured on this problem);
- demo_bundle_adjustment's protocol (priors 1e6 on key 0 and 1e2 on key 1,
  25 LM iterations) in EVM mode: every pose within 1e-3 m and 1e-3 rad of
  JAX's.

The features skip centres where the eigenvalue next to the kept ones
repeats (chip_smoke.BA_EIGEN_GAP): there the frozen eigenvectors, and so
the system, are arbitrary in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gtsam_points_tpu.factors import PriorFactor as JPrior
from gtsam_points_tpu.factors.balm import make_evm_factor as jevm
from gtsam_points_tpu.factors.balm import make_lsq_ba_factor as jlsq
from gtsam_points_tpu.optim import FactorGraph as JGraph
from gtsam_points_tpu.optim import optimize_lm as jlm
from gtsam_points_tpu.optim.lm import LMParams as JLMParams
from gtsam_points_tpu_torch import interop
from gtsam_points_tpu_torch.factors import (
    EdgeEVMFactor,
    LsqBAFactor,
    PlaneEVMFactor,
    PriorFactor,
    make_evm_factor,
    make_lsq_ba_factor,
)
from gtsam_points_tpu_torch.optim import FactorGraph, LMParams, optimize_lm
from gtsam_points_tpu_torch.utils import se3 as tse3

torch.set_num_threads(1)
SYSTEM_TOL = 1e-4
ERROR_TOL = 1e-5
EIGEN_TOL = 1e-5  # x trace of the scatter, for `error`
TOL_M = 1e-3
TOL_RAD = 1e-3
SMALL = dict(n_keys=3, planes=4, edges=2)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


@pytest.fixture(scope="module")
def problem():
    p = chip_smoke.ba_problem(**SMALL)
    assert len(p["plane_feats"]) == SMALL["planes"] and len(p["edge_feats"]) == SMALL["edges"]
    return p


def _factors(problem, mode: str):
    """(JAX factors, port factors) of one mode: EVM (plane and edge) or LSQ."""
    if mode == "lsq":
        moments = [chip_smoke.ba_moments(f) for f in problem["plane_feats"]]
        return [jlsq(m) for m in moments], [make_lsq_ba_factor(m, device="cpu") for m in moments]
    feats = [("plane", f) for f in problem["plane_feats"]] + [("edge", f) for f in problem["edge_feats"]]
    return [jevm(k, f) for k, f in feats], [make_evm_factor(k, f, device="cpu") for k, f in feats]


def test_make_factors_match_jax(problem):
    for j, t in zip(*_factors(problem, "evm")):
        arrays = interop.evm_factor_to_numpy(j)
        assert isinstance(t, PlaneEVMFactor if j.num_eigvecs == 1 else EdgeEVMFactor)
        back = interop.evm_factor_to_numpy(t)
        assert back["pose_keys"] == arrays["pose_keys"] and back["num_eigvecs"] == arrays["num_eigvecs"]
        for k in ("points", "point_keys", "mask"):
            assert np.array_equal(back[k], arrays[k]), k
        assert t.points.shape[0] % 64 == 0
        carried = interop.evm_factor_from_numpy(arrays, device="cpu")
        assert type(carried) is type(t) and torch.equal(carried.points, t.points)
    for j, t in zip(*_factors(problem, "lsq")):
        assert isinstance(t, LsqBAFactor)
        arrays = interop.lsq_ba_factor_to_numpy(j)
        back = interop.lsq_ba_factor_to_numpy(t)
        assert back["pose_keys"] == arrays["pose_keys"]
        for k in ("counts", "means", "covs"):
            assert np.array_equal(back[k], arrays[k]), k
        assert torch.equal(interop.lsq_ba_factor_from_numpy(arrays, device="cpu").covs, t.covs)


@pytest.mark.parametrize("mode", ["evm", "lsq"])
def test_multi_linearize_matches_jax(problem, mode):
    jfs, tfs = _factors(problem, mode)
    poses = problem["start"]
    nudge = tse3.se3_exp(_t(np.random.RandomState(2).uniform(-0.02, 0.02, (len(poses), 6)))).numpy()
    batch = np.stack([poses, problem["T_gt"], poses @ nudge]).astype(np.float32)

    def run(ps, b):
        return [(f.multi_linearize(ps), jax.vmap(f.error)(b)) for f in jfs]

    ref = jax.jit(run)(poses, batch)
    for tf, ((jH, jb, jerr), jerrs) in zip(tfs, ref):
        tH, tb, terr = tf.multi_linearize(_t(poses))
        K = len(tf.keys)
        assert tH.shape == (6 * K, 6 * K) and tb.shape == (6 * K,)
        assert _rel(tH, jH) < SYSTEM_TOL and _rel(tb, jb) < SYSTEM_TOL
        trace = _trace(tf, _t(batch))
        if mode == "evm":
            assert _rel(terr, jerr) < ERROR_TOL
        else:  # the LSQ residuals are vᵀ C v: float32 resolves them to the covariances' scale
            assert abs(float(terr) - float(jerr)) / float(trace[0]) < EIGEN_TOL
        assert float(torch.max(torch.abs(tf.error(_t(batch)) - _t(jerrs)) / trace)) < EIGEN_TOL
        assert float(torch.abs(tf.error(_t(poses)) - float(jerrs[0])) / trace[0]) < EIGEN_TOL


def _trace(factor, poses: torch.Tensor) -> torch.Tensor:
    """The trace of the factor's scatter at poses [..., P, 4, 4]."""
    if isinstance(factor, LsqBAFactor):
        S = factor._fused(torch.stack([poses[..., k, :, :] for k in factor.keys], dim=-3))[3]
    else:
        S = factor._scatter(poses)
    return torch.diagonal(S, dim1=-2, dim2=-1).sum(-1)


def _ba_lm(problem, factors, port: bool):
    T_gt = problem["T_gt"]
    if port:
        g = FactorGraph(num_poses=len(T_gt))
        g.add(PriorFactor(prior=_t(T_gt[0]), weights=torch.full((6,), 1e6), key=0))
        g.add(PriorFactor(prior=_t(T_gt[1]), weights=torch.full((6,), 1e2), key=1))
        for f in factors:
            g.add(f)
        return optimize_lm(g, _t(problem["start"]), LMParams(max_iterations=chip_smoke.BA_ITERATIONS)).poses.numpy()
    g = JGraph(num_poses=len(T_gt))
    g.add(JPrior(prior=jnp.asarray(T_gt[0]), weights=jnp.full((6,), 1e6), key=0))
    g.add(JPrior(prior=jnp.asarray(T_gt[1]), weights=jnp.full((6,), 1e2), key=1))
    for f in factors:
        g.add(f)
    res = jax.jit(lambda p: jlm(g, p, JLMParams(max_iterations=chip_smoke.BA_ITERATIONS)))(problem["start"])
    return np.asarray(res.poses)


def test_ba_protocol_matches_jax(problem):
    """The EVM mode, the demo's first; the LSQ mode's LM is held to JAX's on
    the card (chip_smoke.py phase 30): JAX's LM compile alone takes ~11 s a
    graph here, and the LSQ factor's system is held above."""
    jfs, tfs = _factors(problem, "evm")
    j = _ba_lm(problem, jfs, port=False)
    t = _ba_lm(problem, tfs, port=True)
    rot, trans = tse3.pose_error(_t(j), _t(t))
    assert float(trans.max()) < TOL_M and float(rot.max()) < TOL_RAD, (float(trans.max()), float(rot.max()))
    # the optimization moved the noised poses towards the truth
    before = tse3.pose_error(_t(problem["T_gt"]), _t(problem["start"]))[1].max()
    after = tse3.pose_error(_t(problem["T_gt"]), _t(t))[1].max()
    assert float(after) < float(before)
