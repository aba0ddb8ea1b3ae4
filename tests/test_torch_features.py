"""PyTorch port vs the JAX package: kNN normals and covariances, inv3x3.

The same seeded numpy scans (a small ring world, 2048-point scans) go to
both packages' `estimate_normals_covs(k=10, grid_leaf=1.0)`, the
preprocessing of the two-scan registration. The kNN indices are equal
(tests/test_torch_hash_grid.py), so the raw neighbour covariances agree
within 1e-5 x max|ref|. Normals agree within 1e-4 and regularized
covariances within 1e-4 x max|ref| at every point except where the
normal is not determined: a repeated smallest eigenvalue (the gap to the
middle one under 1e-2 of the largest: the neighbours lie on a line) or a
normal square to the view direction (|n·v| < 1e-6). The points that
differ are counted; each must be such a point, and they must stay under 1%
of the scan. `inv3x3` agrees within 1e-5 x cond(A) x max|ref| a matrix
(the rounding of the determinant, amplified by the condition number) and
cuts the same singular inputs to zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_points_tpu.factors.linearized import inv3x3 as jinv3x3
from gtsam_points_tpu.ops import features as JF
from gtsam_points_tpu.ops import hash_grid as JG
from gtsam_points_tpu.ops.eigh3 import eigh3 as jeigh3
from gtsam_points_tpu.types.frame import make_frame as jmake
from gtsam_points_tpu.utils.synthetic import ring_scans, ring_trajectory, ring_world
from gtsam_points_tpu_torch.factors.linearized import inv3x3
from gtsam_points_tpu_torch.ops import features as TF
from gtsam_points_tpu_torch.types.frame import make_frame as tmake

torch.set_num_threads(1)
WORLD_N = 2200
SCAN_N = 2048
FEATURE_TOL = 1e-4
RAW_TOL = 1e-5
GAP_REL = 1e-2
VIEW_DOT = 1e-6
DEGENERATE_SHARE = 0.01


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def scans():
    world = ring_world(0, WORLD_N)
    return ring_scans(world, ring_trajectory(2, lap=100), scan_n=SCAN_N, seed=1)


def _jax_features(points, **kw):
    def run(f):
        g = JG.build_hash_grid(f.points, f.mask, 1.0)
        idx, _, valid = JG.knn_search(g, f.points, f.mask, 10, 27, 16)
        raw, _ = JF.neighbor_covariances(f.points, idx, valid)
        return JF.estimate_normals_covs(f, k=10, grid_leaf=1.0, **kw), raw, jeigh3(raw)[0]

    out, raw, eigvals = jax.jit(run)(jmake(points))
    return np.asarray(out.normals), np.asarray(out.covs), np.asarray(raw), np.asarray(eigvals)


def _determined(eigvals, normals, points, view_point=np.zeros(3, np.float32)):
    """Points whose normal is determined: a distinct smallest eigenvalue and
    a normal not square to the view direction."""
    gap = (eigvals[:, 1] - eigvals[:, 0]) / np.maximum(eigvals[:, 2], 1e-30)
    v = view_point[None] - points
    dot = np.abs(np.sum(normals * v, -1)) / np.maximum(np.linalg.norm(v, axis=-1), 1e-30)
    return (gap >= GAP_REL) & (dot >= VIEW_DOT)


@pytest.mark.parametrize("scan", [0, 1])
def test_estimate_normals_covs_matches_jax(scans, scan):
    pts = scans[scan]
    jn, jc, jraw, jw = _jax_features(pts)
    frame = TF.estimate_normals_covs(tmake(pts, device="cpu"), k=10, grid_leaf=1.0)
    tn, tc = frame.normals.numpy()[:SCAN_N], frame.covs.numpy()[:SCAN_N]
    jn, jc, jw = jn[:SCAN_N], jc[:SCAN_N], jw[:SCAN_N]
    ok = _determined(jw, jn, pts)
    differ = (np.abs(tn - jn).max(-1) >= FEATURE_TOL) | (np.abs(tc - jc).max((-2, -1)) >= FEATURE_TOL * np.abs(jc).max())
    print(f"scan {scan}: {int(differ.sum())} of {SCAN_N} points differ, all with an undetermined normal "
          f"({int((~ok).sum())} such points)")
    assert not np.any(differ & ok)
    assert differ.mean() < DEGENERATE_SHARE
    np.testing.assert_allclose(np.linalg.norm(tn, axis=-1), 1.0, atol=1e-5)


def test_neighbor_covariances_matches_jax(scans):
    """The same neighbour lists through both packages' scatter matrices."""
    pts = np.asarray(jmake(scans[0]).points)
    rng = np.random.RandomState(4)
    idx = rng.randint(-1, SCAN_N, (SCAN_N, 10)).astype(np.int32)
    valid = idx >= 0
    jc, jm = (np.asarray(x) for x in jax.jit(JF.neighbor_covariances)(pts, idx, valid))
    tc, tm = TF.neighbor_covariances(*(torch.from_numpy(a) for a in (pts, idx, valid)))
    assert _rel(tc.numpy(), jc) < RAW_TOL
    assert _rel(tm.numpy(), jm) < RAW_TOL


@pytest.mark.parametrize("mode", ["eig", "none"])
def test_regularize_covariances_matches_jax(scans, mode):
    _, _, raw, eigvals = _jax_features(scans[0])
    raw, eigvals = raw[:SCAN_N], eigvals[:SCAN_N]
    j = np.asarray(jax.jit(lambda c: JF.regularize_covariances(c, mode))(raw))
    t = TF.regularize_covariances(torch.from_numpy(raw), mode).numpy()
    if mode == "none":
        np.testing.assert_array_equal(t, raw)
        return
    gap = (eigvals[:, 1] - eigvals[:, 0]) / np.maximum(eigvals[:, 2], 1e-30)
    ok = gap >= GAP_REL
    assert np.abs(t - j)[ok].max() < FEATURE_TOL * np.abs(j).max()
    np.testing.assert_allclose(np.linalg.eigvalsh(t[ok].astype(np.float64)), np.broadcast_to([1e-3, 1, 1], (ok.sum(), 3)),
                               atol=1e-4)


def test_view_point_and_single_field_entry_points(scans):
    """A view point off the origin flips the normals as JAX's; the one-field
    entry points give the fields of estimate_normals_covs bit for bit."""
    pts = scans[1]
    vp = np.asarray([3.0, -2.0, 1.0], np.float32)
    jn, _, _, jw = _jax_features(pts, view_point=jnp.asarray(vp))
    frame = tmake(pts, device="cpu")
    both = TF.estimate_normals_covs(frame, k=10, grid_leaf=1.0, view_point=torch.from_numpy(vp))
    ok = _determined(jw[:SCAN_N], jn[:SCAN_N], pts, vp)
    assert np.abs(both.normals.numpy()[:SCAN_N] - jn[:SCAN_N])[ok].max() < FEATURE_TOL
    normals = TF.estimate_normals(frame, k=10, grid_leaf=1.0, view_point=torch.from_numpy(vp))
    covs = TF.estimate_covariances(frame, k=10, grid_leaf=1.0)
    assert torch.equal(normals.normals, both.normals) and normals.covs is None
    assert torch.equal(covs.covs, both.covs) and covs.normals is None


def test_inv3x3_matches_jax():
    """Random SPD matrices at scales 1e-3 .. 1e3, and singular ones, which
    both packages send to zero."""
    rng = np.random.RandomState(5)
    A = rng.randn(4000, 3, 3).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) * (10.0 ** rng.uniform(-3, 3, (4000, 1, 1))).astype(np.float32)
    A[::10, :, 2] = 0.0  # singular: a zero row and column, det exactly 0
    A[::10, 2, :] = 0.0
    j = np.asarray(jax.jit(jinv3x3)(A))
    t = inv3x3(torch.from_numpy(A)).numpy()
    zero_j, zero_t = ~j.any(axis=(1, 2)), ~t.any(axis=(1, 2))
    np.testing.assert_array_equal(zero_t, zero_j)
    assert zero_j[::10].all() and zero_j.sum() < 1000
    live = ~zero_j
    cond = np.linalg.cond(A[live].astype(np.float64))
    err = np.abs(t - j)[live].max(axis=(1, 2)) / np.abs(j)[live].max(axis=(1, 2))
    assert np.all(err <= 1e-5 * cond), float((err / cond).max())


@pytest.mark.parametrize("case", ["card readings", "wide gap", "narrow gap past eps"])
def test_phase19_gap_limit(case):
    """chip_smoke.py's limit on a point with a determined normal (phase 19):
    the four such points read on the H100 (normal gap, covariance gap over
    max|ref|, eigen gap) pass; a 9e-4 normal error at a wide eigen gap, and
    one of 4e-4 at the narrowest gap allowed, fail."""
    import chip_smoke

    points = {
        "card readings": [(1.014e-4, 8.875e-5, 1.014e-2), (8.768e-5, 1.128e-4, 1.020e-2),
                          (8.744e-5, 1.125e-4, 1.020e-2), (9.155e-5, 1.203e-4, 1.234e-2)],
        "wide gap": [(9e-4, 5e-5, 0.3)],
        "narrow gap past eps": [(4e-4, 5e-5, chip_smoke.FEATURE_GAP_REL)],
    }[case]
    assert [chip_smoke._past_gap_limit(*p) for p in points] == [case != "card readings"] * len(points)
