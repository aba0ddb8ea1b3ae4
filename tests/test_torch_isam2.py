"""PyTorch port vs the JAX package: the incremental back end.

- `marginalize_system`, `make_marginal_prior` and the
  `MarginalPriorFactor`'s `multi_linearize` and `error` within 1e-4 x
  max|ref|; where the marginal system is not positive definite, the prior
  all NaN in both packages, and an ISAM2 update whose marginalization meets
  such a system keeps its estimates in both;
- the JAX tests' synthetic protocols through both packages: a BetweenFactor
  stream with drift and a late loop closure (window 3; its updates 4-9 are
  the steady state, where no structure is new), the steady-state stream of
  the JAX test (at window 3, where it meets the drift stream's structures),
  the same drift stream with
  `full_edge_info=False`, the re-anchor transport and `ISAM2ExtDummy`;
  every update's estimates within 1e-4 m and 1e-4 rad, `num_compiles`,
  `compiled`, the window, the frozen keys, the history and loop edges and
  the marginal priors equal or within tolerance;
- `FixedLagSmoother`: the JAX tests' chain and late loop closure;
- `cg_solve` against the JAX `cg_solve` and against Cholesky, its stop;
  `block_jacobi_preconditioner`; `schur_pose_landmark`.

tests/test_torch_isam2_vgicp.py holds the VGICP cases on the helpers here.

The JAX runs share their jitted programs between `ISAM2Ext` instances: the
JAX `_ProgramCache.get` is wrapped for each module that uses this fixture
so that a key already built by an earlier instance reuses its `jax.jit`
(the key fixes the program), while each instance still counts its own
builds. This only saves JAX's tracing time.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_points_tpu.factors import BetweenFactor as JBetween
from gtsam_points_tpu.factors import PriorFactor as JPrior
from gtsam_points_tpu.factors import make_vgicp_factor as jvgicp
from gtsam_points_tpu.optim import FactorGraph as JGraph
from gtsam_points_tpu.optim import isam2 as jisam2
from gtsam_points_tpu.optim.incremental import FixedLagSmoother as JFixedLag
from gtsam_points_tpu.optim.incremental import MarginalPriorFactor as JMarginal
from gtsam_points_tpu.optim.incremental import make_marginal_prior as jmake_prior
from gtsam_points_tpu.optim.incremental import marginalize_system as jmarginalize
from gtsam_points_tpu.optim.lm import LMParams as JLM
from gtsam_points_tpu.optim.solvers import block_jacobi_preconditioner as jjacobi
from gtsam_points_tpu.optim.solvers import cg_solve as jcg
from gtsam_points_tpu.optim.solvers import schur_pose_landmark as jschur
from gtsam_points_tpu.utils import se3 as jse3
from gtsam_points_tpu_torch import interop
from gtsam_points_tpu_torch.factors import BetweenFactor, PriorFactor, make_vgicp_factor
from gtsam_points_tpu_torch.optim import (
    FactorGraph,
    FixedLagSmoother,
    ISAM2Ext,
    ISAM2ExtDummy,
    LMParams,
    MarginalPriorFactor,
    block_jacobi_preconditioner,
    cg_solve,
    make_marginal_prior,
    marginalize_system,
    schur_pose_landmark,
)
from gtsam_points_tpu_torch.utils import se3 as tse3

torch.set_num_threads(1)
SYSTEM_TOL = 1e-4
POSE_TOL_M = 1e-4
POSE_TOL_RAD = 1e-4


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _exp(xi) -> np.ndarray:
    return np.asarray(jse3.se3_exp(jnp.asarray(np.asarray(xi, np.float32))))


@dataclasses.dataclass
class Pkg:
    """One package's names, so a protocol runs through either."""

    name: str
    Between: type
    Prior: type
    ISAM2: type
    Dummy: type
    FixedLag: type
    LM: type
    vgicp: object

    def arr(self, x):
        x = np.asarray(x, np.float32)
        return jnp.asarray(x) if self.name == "jax" else _t(x)

    @property
    def kw(self) -> dict:
        return {} if self.name == "jax" else {"device": "cpu"}


JAX = Pkg("jax", JBetween, JPrior, jisam2.ISAM2Ext, jisam2.ISAM2ExtDummy, JFixedLag, JLM, jvgicp)
PORT = Pkg("torch", BetweenFactor, PriorFactor, ISAM2Ext, ISAM2ExtDummy, FixedLagSmoother, LMParams,
           make_vgicp_factor)

_SHARED_JIT = {}


def _shared_get(self, key, builder):
    entry = self._cache.get(key)
    if entry is None:
        entry = _SHARED_JIT.get(key)
        if entry is None:
            entry = _SHARED_JIT[key] = jax.jit(builder())
        self._cache[key] = entry
        self.compiles += 1
        return entry, True
    return entry, False


@pytest.fixture(scope="module", autouse=True)
def shared_jax_programs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jisam2._ProgramCache, "get", _shared_get)
        yield


def _record(isam, res) -> dict:
    return {"estimates": isam.calculate_estimate().copy(), "compiled": bool(res.compiled),
            "num_compiles": int(isam.num_compiles), "window": list(isam.window), "frozen": sorted(isam.frozen),
            "loops": int(res.num_loop_closures)}


def _assert_poses(t, j, tol_m=POSE_TOL_M, tol_rad=POSE_TOL_RAD, what=""):
    rot, trans = tse3.pose_error(_t(j), _t(t))
    assert float(trans.max()) < tol_m and float(rot.max()) < tol_rad, (what, float(trans.max()), float(rot.max()))


def _assert_streams(jr, tr, tol_m=POSE_TOL_M, tol_rad=POSE_TOL_RAD):
    """Two packages' per-update records: estimates within the bounds, the
    compile sequence, windows, frozen keys and loop counts equal."""
    assert len(jr) == len(tr)
    for u, (j, t) in enumerate(zip(jr, tr)):
        _assert_poses(t["estimates"], j["estimates"], tol_m, tol_rad, f"update {u}")
        for k in ("compiled", "num_compiles", "window", "frozen", "loops"):
            assert t[k] == j[k], (u, k, t[k], j[k])


def _assert_snapshots(js, ts, tol=SYSTEM_TOL):
    """interop.isam2_to_numpy of both: keys equal, edges and priors within tol."""
    for k in ("window", "frozen", "num_values", "num_compiles"):
        assert ts[k] == js[k], k
    for k in ("history_edges", "loop_edges"):
        assert [e[:2] for e in ts[k]] == [e[:2] for e in js[k]], k
        for (_, _, tm, ti), (_, _, jm, ji) in zip(ts[k], js[k]):
            assert _rel(tm, jm) < tol and _rel(ti, ji) < tol, k
    assert [p[0] for p in ts["history_priors"]] == [p[0] for p in js["history_priors"]]
    assert len(ts["marginal_priors"]) == len(js["marginal_priors"])
    for tp, jp in zip(ts["marginal_priors"], js["marginal_priors"]):
        assert tp["pose_keys"] == jp["pose_keys"]
        for name in ("lin_poses", "sqrt_info_t", "delta_star"):
            assert np.abs(tp[name] - jp[name]).max() <= tol * max(np.abs(jp[name]).max(), 1.0), name


# -- marginalization --------------------------------------------------------------


@pytest.fixture(scope="module")
def chain_system():
    """The JAX test's 4-pose chain (a prior and Between edges), linearized
    by the JAX graph at perturbed poses -> A, b, poses (numpy)."""
    T = [np.eye(4, dtype=np.float32)]
    d = _exp([0.02, 0.0, 0.05, 1.0, 0.1, 0.0])
    for _ in range(3):
        T.append(T[-1] @ d)
    g = JGraph(num_poses=4)
    g.add(JPrior(prior=jnp.eye(4), weights=jnp.full((6,), 1e6), key=0))
    for i in range(3):
        g.add(JBetween(measured=jnp.asarray(d), weights=jnp.ones(6) * 100.0, target_key=i, source_key=i + 1))
    noise = np.random.RandomState(1).randn(4, 6).astype(np.float32) * 0.05
    poses = (np.stack(T) @ _exp(noise)).astype(np.float32)
    A, b, _ = jax.jit(g.linearize_full)(poses)
    return np.asarray(A), np.asarray(b), poses


@pytest.mark.parametrize("marg,keep", [([0], [1]), ([0, 1], [2, 3]), ([1], [0, 2])])
def test_marginalization_matches_jax(chain_system, marg, keep):
    A, b, poses = chain_system
    jH, jb = jmarginalize(jnp.asarray(A), jnp.asarray(b), marg, keep)
    tH, tb = marginalize_system(_t(A), _t(b), marg, keep)
    assert _rel(tH, jH) < SYSTEM_TOL and _rel(tb, jb) < SYSTEM_TOL
    jp = jmake_prior(jnp.asarray(A), jnp.asarray(b), jnp.asarray(poses), marg, keep)
    tp = make_marginal_prior(_t(A), _t(b), _t(poses), marg, keep)
    assert tp.pose_keys == jp.pose_keys == tuple(keep)
    for name in ("lin_poses", "sqrt_info_t", "delta_star"):
        assert _rel(getattr(tp, name), getattr(jp, name)) < SYSTEM_TOL, name


def test_marginal_prior_factor_matches_jax(chain_system):
    """multi_linearize and error (a batch of pose sets) on the same prior,
    carried across with interop, in a graph with a Between edge."""
    A, b, poses = chain_system
    jp = jmake_prior(jnp.asarray(A), jnp.asarray(b), jnp.asarray(poses), [0], [1, 2])
    arrays = interop.marginal_prior_to_numpy(jp)
    tp = interop.marginal_prior_from_numpy(arrays, device="cpu")
    assert isinstance(tp, MarginalPriorFactor) and tp.keys == (1, 2)
    back = interop.marginal_prior_to_numpy(tp)
    assert all(np.array_equal(back[k], arrays[k]) for k in ("lin_poses", "sqrt_info_t", "delta_star"))
    at = (poses @ _exp(np.random.RandomState(5).uniform(-0.05, 0.05, (4, 6)))).astype(np.float32)
    jH, jb, jerr = jax.jit(jp.multi_linearize)(at)
    tH, tb, terr = tp.multi_linearize(_t(at))
    assert tH.shape == (12, 12) and tH.dtype == torch.float32
    assert _rel(tH, jH) < SYSTEM_TOL and _rel(tb, jb) < SYSTEM_TOL and _rel(terr, jerr) < SYSTEM_TOL
    batch = np.stack([at, poses, at[::-1]])
    assert _rel(tp.error(_t(batch)), jax.jit(jax.vmap(jp.error))(batch)) < SYSTEM_TOL
    # through the graph's multi_linearize branch beside a Between edge
    d = _exp([0.02, 0.0, 0.05, 1.0, 0.1, 0.0])
    jg, tg = JGraph(num_poses=4), FactorGraph(num_poses=4)
    jg.add(jp)
    tg.add(tp)
    jg.add(JBetween(measured=jnp.asarray(d), weights=jnp.ones(6) * 100.0, target_key=2, source_key=3))
    tg.add(BetweenFactor(measured=_t(d), weights=torch.ones(6) * 100.0, target_key=2, source_key=3))
    jA, jb2, jerr2 = jax.jit(jg.linearize_full)(at)
    tA, tb2, terr2 = tg.linearize_full(_t(at))
    assert _rel(tA, jA) < SYSTEM_TOL and _rel(tb2, jb2) < SYSTEM_TOL and _rel(terr2, jerr2) < SYSTEM_TOL


def test_marginal_prior_nan_where_not_positive_definite():
    """A = I with A[8, 8] = -1e-3, marg [0], keep [1]: the kept block is not
    positive definite, and JAX's Cholesky gives NaN; so does the port's."""
    A = np.eye(12, dtype=np.float32)
    A[8, 8] = -1e-3
    b = np.linspace(-1.0, 1.0, 12).astype(np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32), _exp([0.0, 0.0, 0.1, 1.0, 0.0, 0.0])])
    jp = jmake_prior(jnp.asarray(A), jnp.asarray(b), jnp.asarray(poses), [0], [1])
    tp = make_marginal_prior(_t(A), _t(b), _t(poses), [0], [1])
    # the factor's lower triangle NaN (so Lᵀ's upper, the zeros below kept), delta* all NaN
    assert np.isnan(np.asarray(jp.sqrt_info_t)[np.triu_indices(6)]).all() and np.isnan(np.asarray(jp.delta_star)).all()
    for name in ("sqrt_info_t", "delta_star"):
        assert np.array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)), equal_nan=True), name
    assert torch.equal(tp.lin_poses, _t(poses[1:]))


def indefinite_stream(pkg: Pkg):
    """Window 2: a prior on pose 0; a Between edge 0 -> 1 whose z weight is
    -1e-3, with a unit prior on pose 1 that keeps the window's system
    positive definite; then pose 2. Marginalizing pose 0 meets the edge's
    negative curvature alone: the marginal prior on pose 1 is NaN, the
    window's LM cannot move, and the update keeps the previous estimates.
    -> records, snapshot."""
    isam = pkg.ISAM2(window_size=2, lm_params=pkg.LM(max_iterations=10), **pkg.kw)
    d = _exp([0.0, 0.0, 0.05, 1.0, 0.1, 0.0])
    T1, T2 = d, d @ d
    w = np.full(6, 1e2, np.float32)
    w[5] = -1e-3
    out = [_record(isam, isam.update([pkg.Prior(prior=pkg.arr(np.eye(4)), weights=pkg.arr(np.full(6, 1e6)), key=0)],
                                     {0: pkg.arr(np.eye(4))}))]
    init1 = T1 @ _exp([0.01, 0.0, 0.0, 0.05, 0.0, 0.0])
    out.append(_record(isam, isam.update(
        [pkg.Between(measured=pkg.arr(d), weights=pkg.arr(w), target_key=0, source_key=1),
         pkg.Prior(prior=pkg.arr(T1), weights=pkg.arr(np.ones(6)), key=1)], {1: pkg.arr(init1)})))
    init2 = T2 @ _exp([0.0, 0.01, 0.0, 0.0, 0.05, 0.0])
    out.append(_record(isam, isam.update(
        [pkg.Between(measured=pkg.arr(d), weights=pkg.arr(np.full(6, 1e2)), target_key=1, source_key=2)],
        {2: pkg.arr(init2)})))
    return out, interop.isam2_to_numpy(isam), init2


def test_isam2_update_keeps_estimates_at_nan_marginal_prior():
    (jr, js, init2), (tr, ts, _) = indefinite_stream(JAX), indefinite_stream(PORT)
    _assert_streams(jr, tr)
    assert tr[-1]["frozen"] == [0] and tr[-1]["window"] == [1, 2]
    for rec, snap in ((jr, js), (tr, ts)):
        (prior,) = snap["marginal_priors"]
        assert prior["pose_keys"] == (1,)
        assert np.isnan(prior["sqrt_info_t"][np.triu_indices(6)]).all() and np.isnan(prior["delta_star"]).all()
        # pose 1 where the update before left it, pose 2 at its initial value
        assert np.array_equal(rec[-1]["estimates"][1], rec[-2]["estimates"][1])
        assert np.array_equal(rec[-1]["estimates"][2], init2.astype(np.float32))


# -- the synthetic protocols --------------------------------------------------------


def _drift_truth(n: int, yaw) -> list:
    T = [np.eye(4, dtype=np.float32)]
    for i in range(n - 1):
        T.append((T[-1] @ _exp([0.0, 0.0, yaw(i), 1.0, 0.0, 0.0])).astype(np.float32))
    return T


def drift_stream(pkg: Pkg, full_edge_info: bool = True):
    """The JAX test's drift protocol: 10 poses, odometry with a yaw bias,
    window 3; then the late loop closure 0 <-> 9 with the true relative
    pose, and a PriorFactor on frozen pose 1 in the same update; then two
    more poses. -> (records, snapshot, the truth)."""
    T_true = _drift_truth(12, lambda i: 0.05 * np.sin(i))
    bias = _exp([0.0, 0.0, 0.02, 0.0, 0.0, 0.0])
    isam = pkg.ISAM2(window_size=3, lm_params=pkg.LM(max_iterations=10), full_edge_info=full_edge_info, **pkg.kw)
    w_odom = pkg.arr(np.full(6, 1e4))
    out = [_record(isam, isam.update([pkg.Prior(prior=pkg.arr(np.eye(4)), weights=pkg.arr(np.full(6, 1e6)), key=0)],
                                     {0: pkg.arr(np.eye(4))}))]

    def step(i):
        d_meas = np.linalg.inv(T_true[i - 1]) @ T_true[i] @ bias
        init = isam.calculate_estimate_pose(i - 1) @ d_meas
        res = isam.update([pkg.Between(measured=pkg.arr(d_meas), weights=w_odom, target_key=i - 1, source_key=i)],
                          {i: pkg.arr(init)})
        out.append(_record(isam, res))

    for i in range(1, 10):
        step(i)
    loop = pkg.Between(measured=pkg.arr(np.linalg.inv(T_true[0]) @ T_true[9]), weights=pkg.arr(np.full(6, 1e5)),
                       target_key=0, source_key=9)
    pin = pkg.Prior(prior=pkg.arr(T_true[1]), weights=pkg.arr(np.full(6, 1e2)), key=1)
    out.append(_record(isam, isam.update([loop, pin])))
    for i in range(10, 12):
        step(i)
    return out, interop.isam2_to_numpy(isam), T_true


def steady_stream(pkg: Pkg):
    """The JAX test's steady-state stream (exact measurements, inits
    perturbed by RandomState(0), 12 poses) at the drift stream's window (3)
    and LM (10 iterations), so that it meets the drift stream's structures."""
    rng = np.random.RandomState(0)
    isam = pkg.ISAM2(window_size=3, lm_params=pkg.LM(max_iterations=10), **pkg.kw)
    w = pkg.arr(np.full(6, 100.0))
    T = [np.eye(4, dtype=np.float32)]
    out = [_record(isam, isam.update([pkg.Prior(prior=pkg.arr(np.eye(4)), weights=pkg.arr(np.full(6, 1e6)), key=0)],
                                     {0: pkg.arr(np.eye(4))}))]
    d = _exp([0.01, 0.0, 0.02, 1.0, 0.05, 0.0])
    for i in range(1, 12):
        T.append(T[-1] @ d)
        init = T[i] @ _exp(rng.randn(6).astype(np.float32) * 0.02)
        out.append(_record(isam, isam.update(
            [pkg.Between(measured=pkg.arr(d), weights=w, target_key=i - 1, source_key=i)], {i: pkg.arr(init)})))
    return out, interop.isam2_to_numpy(isam), T


@pytest.fixture(scope="module")
def drift():
    return {pkg.name: drift_stream(pkg) for pkg in (JAX, PORT)}


def test_isam2_drift_and_late_loop_matches_jax(drift):
    (jr, js, T_true), (tr, ts, _) = drift["jax"], drift["torch"]
    _assert_streams(jr, tr)
    _assert_snapshots(js, ts)
    assert [r["loops"] for r in tr][10] == 2 and 0 in tr[-1]["frozen"]
    # updates 4-9 are the steady state: no structure is new
    assert not any(r["compiled"] for r in tr[4:10]) and tr[4]["num_compiles"] == tr[9]["num_compiles"]
    # the loop closure moved the frozen history toward the truth, as in the JAX test
    gap_before = np.linalg.norm(tr[9]["estimates"][5, :3, 3] - T_true[5][:3, 3])
    gap_after = np.linalg.norm(tr[10]["estimates"][5, :3, 3] - T_true[5][:3, 3])
    assert gap_after < 0.5 * gap_before, (gap_before, gap_after)


def test_isam2_steady_state_matches_jax():
    jr, js, _ = steady_stream(JAX)
    tr, ts, T = steady_stream(PORT)
    _assert_streams(jr, tr)
    _assert_snapshots(js, ts)
    assert tr[-1]["num_compiles"] == tr[4]["num_compiles"], [r["num_compiles"] for r in tr]
    _assert_poses(tr[-1]["estimates"][11], T[11], 5e-2, 1e-2)


def test_isam2_diagonal_edge_info_matches_jax(drift):
    """full_edge_info=False: the same stream; its skeleton keeps diag
    matrices, and its programs are the full-info run's (no new structure)."""
    jr, js, _ = drift_stream(JAX, full_edge_info=False)
    tr, ts, _ = drift_stream(PORT, full_edge_info=False)
    _assert_streams(jr, tr)
    _assert_snapshots(js, ts)
    for (_, _, _, info) in ts["history_edges"]:
        np.testing.assert_array_equal(info, np.diag(np.diagonal(info)))
    assert [r["num_compiles"] for r in tr] == [r["num_compiles"] for r in drift["torch"][0]]


def test_isam2_reanchor_transport_matches_jax():
    """The JAX test's transport: the re-anchored prior's optimum is the
    relax-corrected old optimum, and its offset survives."""
    rng = np.random.RandomState(0)
    lin = _exp(rng.randn(6).astype(np.float32) * 0.1)
    dstar = rng.randn(6).astype(np.float32) * 0.05
    T_pre = (lin @ _exp(dstar * 0.3)).astype(np.float32)
    C = _exp([0.0, 0.0, 0.05, 0.4, -0.2, 0.1])
    out = {}
    for pkg, Marginal in ((JAX, JMarginal), (PORT, MarginalPriorFactor)):
        isam = pkg.ISAM2(window_size=3, **pkg.kw)
        f = Marginal(lin_poses=pkg.arr(lin[None]), sqrt_info_t=pkg.arr(np.eye(6) * 10.0), delta_star=pkg.arr(dstar),
                     pose_keys=(7,))
        isam.estimates[7] = (C @ T_pre).astype(np.float32)
        out[pkg.name] = interop.marginal_prior_to_numpy(isam._reanchor(f, {7: T_pre}))
    j, t = out["jax"], out["torch"]
    assert t["pose_keys"] == j["pose_keys"] == (7,)
    assert _rel(t["lin_poses"], j["lin_poses"]) < 1e-6 and _rel(t["delta_star"], j["delta_star"]) < 1e-4
    opt_new = t["lin_poses"][0] @ _exp(t["delta_star"])
    np.testing.assert_allclose(opt_new, C @ lin @ _exp(dstar), atol=1e-5)
    assert float(np.linalg.norm(t["delta_star"])) > 1e-3


def test_isam2_dummy_matches_jax():
    T1 = _exp([0.1, 0, 0, 1.0, 0, 0])
    out = {}
    for pkg in (JAX, PORT):
        isam = pkg.Dummy(max_poses=2, **pkg.kw)
        res = isam.update([pkg.Prior(prior=pkg.arr(np.eye(4)), weights=pkg.arr(np.ones(6)), key=0)],
                          {0: pkg.arr(np.eye(4)), 1: pkg.arr(T1)})
        out[pkg.name] = (isam.calculate_estimate(), res.num_factors, res.num_values, isam.window, isam.num_compiles)
    j, t = out["jax"], out["torch"]
    np.testing.assert_array_equal(t[0], j[0])
    assert t[1:] == j[1:] == (1, 2, [0, 1], 0)


def test_isam2_refuses_factors_on_another_device():
    isam = ISAM2Ext(window_size=3, device="cpu")
    prior = PriorFactor(prior=torch.eye(4, device="meta"), weights=torch.ones(6, device="meta"), key=0)
    with pytest.raises(ValueError):
        isam.update([prior], {0: np.eye(4, dtype=np.float32)})


# -- the fixed-lag smoother ----------------------------------------------------------


def fixed_lag_chain(pkg: Pkg):
    """The JAX test's smoother chain: 8 poses, lag 2.5, Between edges,
    inits perturbed by RandomState(2)."""
    T = [np.eye(4, dtype=np.float32)]
    d = _exp([0.02, 0.0, 0.05, 1.0, 0.1, 0.0])
    sm = pkg.FixedLag(lag=2.5, max_poses=8, **pkg.kw)
    sm.update(0, 0.0, pkg.arr(np.eye(4)), [pkg.Prior(prior=pkg.arr(np.eye(4)), weights=pkg.arr(np.full(6, 1e6)), key=0)])
    rng = np.random.RandomState(2)
    out = []
    for i in range(1, 8):
        T.append(T[-1] @ d)
        init = T[i] @ _exp(rng.randn(6).astype(np.float32) * 0.05)
        est = sm.update(i, float(i), pkg.arr(init),
                        [pkg.Between(measured=pkg.arr(d), weights=pkg.arr(np.full(6, 100.0)), target_key=i - 1,
                                     source_key=i)])
        out.append((np.asarray(est).copy(), sorted(sm.frozen), sm.active, sm.num_compiles))
    return out


def fixed_lag_loop(pkg: Pkg):
    """The JAX test's smoother late loop: 9 poses with a yaw bias, lag 2.5,
    then add_factors([loop 0 <-> 8])."""
    T_true = _drift_truth(9, lambda i: 0.04 * np.cos(i))
    bias = _exp([0.0, 0.0, 0.025, 0.0, 0.0, 0.0])
    sm = pkg.FixedLag(lag=2.5, lm_params=pkg.LM(max_iterations=10), **pkg.kw)
    sm.update(0, 0.0, pkg.arr(np.eye(4)), [pkg.Prior(prior=pkg.arr(np.eye(4)), weights=pkg.arr(np.full(6, 1e6)), key=0)])
    for i in range(1, 9):
        d_meas = np.linalg.inv(T_true[i - 1]) @ T_true[i] @ bias
        sm.update(i, float(i), pkg.arr(sm.estimate(i - 1) @ d_meas),
                  [pkg.Between(measured=pkg.arr(d_meas), weights=pkg.arr(np.full(6, 1e4)), target_key=i - 1,
                               source_key=i)])
    before = np.stack([sm.estimate(i) for i in range(9)])
    res = sm.add_factors([pkg.Between(measured=pkg.arr(np.linalg.inv(T_true[0]) @ T_true[8]),
                                      weights=pkg.arr(np.full(6, 1e5)), target_key=0, source_key=8)])
    return before, np.stack([sm.estimate(i) for i in range(9)]), res.num_loop_closures, sorted(sm.frozen), T_true


def test_fixed_lag_smoother_matches_jax():
    for (je, jf, ja, jc), (te, tf, ta, tc) in zip(fixed_lag_chain(JAX), fixed_lag_chain(PORT)):
        _assert_poses(te, je)
        assert (tf, ta, tc) == (jf, ja, jc)
    jb, ja, jl, jfz, _ = fixed_lag_loop(JAX)
    tb, ta, tl, tfz, T_true = fixed_lag_loop(PORT)
    _assert_poses(tb, jb)
    _assert_poses(ta, ja)
    assert tl == jl == 1 and tfz == jfz and 0 in tfz
    err = [np.abs(np.linalg.inv(T_true[i]) @ e - np.eye(4))[:3, 3].max() for e, i in ((tb[8], 8), (ta[8], 8))]
    assert err[1] < 0.6 * err[0], err


# -- linear solvers --------------------------------------------------------------------


@pytest.fixture(scope="module")
def spd():
    """The JAX test's SPD system: 8 poses, J of 96 rows."""
    rng = np.random.RandomState(1)
    J = rng.randn(96, 48).astype(np.float32)
    A = (J.T @ J + 1e-2 * np.eye(48, dtype=np.float32)).astype(np.float32)
    return A, rng.randn(48).astype(np.float32)


def test_cg_solve_matches_jax_and_cholesky(spd):
    A, b = spd
    x_chol = np.asarray(jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(jnp.asarray(A), lower=True), b))
    x_j = np.asarray(jcg(jnp.asarray(A), jnp.asarray(b), tol=1e-10, maxiter=500))
    x_t = cg_solve(_t(A), _t(b), tol=1e-10, maxiter=500).numpy()
    np.testing.assert_allclose(x_t, x_chol, rtol=1e-2, atol=1e-3)
    assert _rel(x_t, x_j) < 1e-3
    # the stop: JAX's cg with maxiter = the port's count returns what its
    # own test stops at; the default tol, maxiter 10 n, x0
    x, k = cg_solve(_t(A), _t(b), return_iterations=True)
    k = int(k)
    assert 0 < k < 480
    x_jk = np.asarray(jcg(jnp.asarray(A), jnp.asarray(b), maxiter=k))
    assert _rel(x, jcg(jnp.asarray(A), jnp.asarray(b))) < 1e-4 and _rel(x, x_jk) < 1e-4
    x0 = np.full(48, 0.1, np.float32)
    assert _rel(cg_solve(_t(A), _t(b), x0=_t(x0), maxiter=7), jcg(jnp.asarray(A), jnp.asarray(b), x0=jnp.asarray(x0),
                                                                  maxiter=7)) < 1e-4


def test_block_jacobi_and_schur_match_jax(spd):
    A, b = spd
    r = np.random.RandomState(4).randn(48).astype(np.float32)
    assert _rel(block_jacobi_preconditioner(_t(A))(_t(r)), jjacobi(jnp.asarray(A))(jnp.asarray(r))) < 1e-4
    for poses, marks in (([0, 1, 2], [3, 4, 5, 6, 7]), ([7, 2], [0, 1, 3])):
        jH, jb = jschur(jnp.asarray(A), jnp.asarray(b), poses, marks)
        tH, tb = schur_pose_landmark(_t(A), _t(b), poses, marks)
        assert tH.shape == (6 * len(poses),) * 2
        assert _rel(tH, jH) < SYSTEM_TOL and _rel(tb, jb) < SYSTEM_TOL
