"""PyTorch port vs the JAX package: the double-hash index and the hash grid.

The same seeded numpy input goes to both packages: random packed keys for
`build_hash_index` and `probe`, and a small ring-world scene (a 2048-point
scan padded to 2304 slots; queries: the next scan moved by the true
relative pose, 0.3 m off, every 7th masked) for `build_hash_grid`,
`knn_search`, `radius_search` and `brute_force_knn`.

Integer outputs match bit for bit: keys, hash tables, tiles, counts, kNN
indices and masks. Float outputs that are copies (tiles, records) match
bit for bit. Squared distances match within 2 ulp: XLA's CPU code rounds
the sum (dx² + dy²) + dz² its own way, and both packages lie within 2.4 ulp
of the float64 distance on this scene. A kNN index may differ from JAX's
only where the two candidates tie: their float64 distances to the query
lie within 1 ulp of the float32 distance. Such ties are counted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_points_tpu.ops import hash_grid as JG
from gtsam_points_tpu.ops import hash_index as JH
from gtsam_points_tpu.utils.synthetic import ring_scans, ring_trajectory, ring_world
from gtsam_points_tpu_torch import interop
from gtsam_points_tpu_torch.ops import hash_grid as TG
from gtsam_points_tpu_torch.ops import hash_index as TH
from gtsam_points_tpu_torch.ops import voxel_keys as vk

torch.set_num_threads(1)
WORLD_N = 2200
SCAN_N = 2048
CAPACITY = 2304
MAX_SQ = 4.0  # max_corr_dist 2.0, as the two-scan registration
RADIUS = 1.5
MAX_NEIGHBORS = 12

GRID_CASES = {
    "plain": {},
    "coarse": {"coarse_factor": 4},
    "overflow": {"cell_capacity": 300},  # the scan occupies about 1460 leaf-1.0 cells
    "truncation": {"max_points_per_cell": 2},  # most cells hold more than 2 points
}


@pytest.fixture(scope="module")
def scene():
    world = ring_world(0, WORLD_N)
    T = ring_trajectory(2, lap=100)
    scans = ring_scans(world, T, scan_n=SCAN_N, seed=1)
    points = np.zeros((CAPACITY, 3), np.float32)
    points[:SCAN_N] = scans[0]
    points[SCAN_N:] = scans[0][0]
    mask = np.arange(CAPACITY) < SCAN_N
    T_rel = np.linalg.inv(T[0]) @ T[1]
    queries = (scans[1] @ T_rel[:3, :3].T + T_rel[:3, 3] + 0.3).astype(np.float32)
    qmask = np.ones(len(queries), bool)
    qmask[::7] = False
    return {"points": points, "mask": mask, "queries": queries, "qmask": qmask}


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _grids(scene, kw):
    jg = jax.jit(lambda p, m: JG.build_hash_grid(p, m, 1.0, **kw))(scene["points"], scene["mask"])
    tg = TG.build_hash_grid(*_t(scene["points"], scene["mask"]), 1.0, **kw)
    return jg, tg


def _assert_grid_equal(j: dict, t: dict):
    for k, a in j.items():
        if k == "coarse":
            assert (a is None) == (t[k] is None)
            if a is not None:
                _assert_grid_equal(a, t[k])
            continue
        assert a.dtype == t[k].dtype and a.shape == t[k].shape, k
        # floats by their bits (tiles are copies; inf padding included)
        np.testing.assert_array_equal(a.view(np.int32), t[k].view(np.int32), err_msg=k)


def _check_knn(j, t, points, queries):
    """j, t: (idx, sq, valid) of JAX and the port -> number of index ties.
    Masks equal; distances within 2 ulp; an index differs only where its
    candidate's float64 distance is within 1 ulp of JAX's candidate's."""
    ji, js, jv = (np.asarray(x) for x in j)
    ti, ts, tv = (x.numpy() for x in t)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(np.isinf(ts), np.isinf(js))
    fin = np.isfinite(js)
    ulp = np.spacing(np.where(fin, js, 1.0).astype(np.float32))
    assert np.all(np.abs(np.where(fin, ts - js, 0.0)) <= 2 * ulp)
    rows, cols = np.nonzero(ti != ji)
    p64, q64 = points.astype(np.float64), queries.astype(np.float64)
    d_t = np.sum((p64[ti[rows, cols]] - q64[rows]) ** 2, -1)
    d_j = np.sum((p64[ji[rows, cols]] - q64[rows]) ** 2, -1)
    assert np.all((ti[rows, cols] >= 0) & (ji[rows, cols] >= 0))
    assert np.all(np.abs(d_t - d_j) <= ulp[rows, cols]), (rows, cols)
    return len(rows)


@pytest.mark.parametrize("case", ["spread", "crowded"])
def test_hash_index_matches_jax(case):
    """Random keys with INVALID_KEY padding; "crowded" packs 3000 keys into
    a 4096-slot table, so many keys lose in both tables and are dropped."""
    rng = np.random.RandomState(0 if case == "spread" else 1)
    keys = rng.randint(0, 2**30, 3000).astype(np.int32)
    keys[::11] = vk.INVALID_KEY
    size = None if case == "spread" else 4096
    j = np.asarray(jax.jit(lambda k: JH.build_hash_index(k, size))(keys))
    t = TH.build_hash_index(torch.from_numpy(keys), size).numpy()
    np.testing.assert_array_equal(t, j)
    assert TH.table_size_for(3000) == JH.table_size_for(3000)
    stored = int((t[..., 0] >= 0).sum())
    valid = int((keys != vk.INVALID_KEY).sum())
    assert (stored < valid) == (case == "crowded"), (stored, valid)

    queries = np.concatenate([keys[:1500], rng.randint(0, 2**30, 1500).astype(np.int32)])
    jr, jf = (np.asarray(x) for x in jax.jit(lambda i, q: JH.probe(i, None, q))(j, queries))
    tr, tf = TH.probe(torch.from_numpy(t), None, torch.from_numpy(queries))
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_array_equal(tr.numpy(), jr)


@pytest.mark.parametrize("case", list(GRID_CASES))
def test_build_hash_grid_matches_jax(scene, case):
    """Every field bit for bit; the overflow case drops cells (`overflowed`),
    the truncation case keeps the first J points of each cell in the stable
    sort's order."""
    jg, tg = _grids(scene, GRID_CASES[case])
    _assert_grid_equal(interop.hash_grid_to_numpy(jg), interop.hash_grid_to_numpy(tg))
    assert bool(tg.overflowed) == (case == "overflow") == bool(jg.overflowed)
    if case == "truncation":
        assert int((tg.cell_count > tg.points_per_cell).sum()) > 100
    if case == "coarse":
        assert tg.coarse.points_per_cell == 64 and tg.coarse.cell_capacity == 4096


@pytest.mark.parametrize("coarse", [False, True], ids=["fine", "coarse"])
@pytest.mark.parametrize("cells", [27, 7])
@pytest.mark.parametrize("k", [1, 10])
def test_knn_search_matches_jax(scene, k, cells, coarse):
    jg, tg = _grids(scene, GRID_CASES["coarse" if coarse else "plain"])
    q, m = scene["queries"], scene["qmask"]
    j = jax.jit(lambda g, q, m: JG.knn_search(g, q, m, k, cells, max_sq_dist=MAX_SQ))(jg, q, m)
    t = TG.knn_search(tg, *_t(q, m), k, cells, max_sq_dist=MAX_SQ)
    ties = _check_knn(j, t, scene["points"], q)
    found = float(t[2].float().mean())
    print(f"k={k} cells={cells} coarse={coarse}: {found:.3f} of the slots found, {ties} index ties")
    assert found > 0.3


@pytest.mark.parametrize("k", [1, 10])
def test_knn_on_the_jax_grid(scene, k):
    """The JAX grid (with its coarse level), carried across by interop, gives
    the port's search JAX's results."""
    jg, _ = _grids(scene, GRID_CASES["coarse"])
    tg = interop.hash_grid_from_numpy(interop.hash_grid_to_numpy(jg), device="cpu")
    q, m = scene["queries"], scene["qmask"]
    j = jax.jit(lambda g, q, m: JG.knn_search(g, q, m, k, 27, max_sq_dist=MAX_SQ))(jg, q, m)
    assert _check_knn(j, TG.knn_search(tg, *_t(q, m), k, 27, max_sq_dist=MAX_SQ), scene["points"], q) >= 0


@pytest.mark.parametrize("coarse", [False, True], ids=["fine", "coarse"])
def test_radius_search_matches_jax(scene, coarse):
    jg, tg = _grids(scene, GRID_CASES["coarse" if coarse else "plain"])
    q, m = scene["queries"], scene["qmask"]
    ji, js, jv, jn = jax.jit(lambda g, q, m: JG.radius_search(g, q, m, RADIUS, MAX_NEIGHBORS))(jg, q, m)
    ti, ts, tv, tn = TG.radius_search(tg, *_t(q, m), RADIUS, MAX_NEIGHBORS)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    _check_knn((ji, js, jv), (ti, ts, tv), scene["points"], q)
    assert int(tn.max()) == MAX_NEIGHBORS


def test_brute_force_knn_matches_jax(scene):
    p, pm, q, qm = scene["points"], scene["mask"], scene["queries"], scene["qmask"]
    j = jax.jit(lambda: JG.brute_force_knn(jnp.asarray(p), pm, q, qm, 10, block=512))()
    ti, ts, tv = TG.brute_force_knn(*_t(p, pm, q, qm), 10, block=512)
    ji, js, jv = (np.asarray(x) for x in j)
    np.testing.assert_array_equal(tv.numpy(), jv)
    # |a|^2 + |b|^2 - 2 a.b cancels: an index may differ only between
    # candidates whose float64 distances lie within that cancellation
    scale = np.spacing(np.float32(np.max(np.sum(q * q, -1)) + np.max(np.sum(p * p, -1))))
    rows, cols = np.nonzero(ti.numpy() != ji)
    d = [np.sum((p[a].astype(np.float64) - q[r]) ** 2) for a, r in ((ti.numpy()[rows, cols], rows), (ji[rows, cols], rows))]
    assert np.all(np.abs(d[0] - d[1]) <= 8 * scale)
    assert np.all(np.abs(np.where(jv, ts.numpy() - js, 0.0)) <= 8 * scale)
    print(f"brute force: {len(rows)} index ties of {int(jv.sum())}")


def test_grid_knn_agrees_with_brute_force(scene):
    """The port's grid kNN of the scan's own points equals its exact kNN for
    every neighbour closer than one leaf (the reference's oracle check)."""
    p, pm = scene["points"], scene["mask"]
    tg = TG.build_hash_grid(*_t(p, pm), 1.0, max_points_per_cell=32)
    _, gs, _ = TG.knn_search(tg, *_t(p, pm), 4, 27)
    _, bs, bv = TG.brute_force_knn(*_t(p, pm, p, pm), 4)
    within = (bs < 1.0) & bv
    scale = np.spacing(np.float32(2 * np.max(np.sum(p * p, -1))))
    assert int(within.sum()) > 0.75 * 4 * SCAN_N  # 6541 of 8192 neighbours on this scene
    np.testing.assert_allclose(gs[within].numpy(), bs[within].numpy(), rtol=0, atol=8 * scale)


@pytest.mark.parametrize("entry", ["knn_search", "make_gicp_factor", "make_icp_factor", "estimate_normals_covs"])
def test_max_points_per_cell_is_the_grids(scene, entry):
    """The per-cell budget is fixed when the grid is built: the builders
    that make a grid pass it to build_hash_grid, and a search given a grid
    with another budget raises instead of ignoring it."""
    from gtsam_points_tpu_torch.factors import make_gicp_factor, make_icp_factor
    from gtsam_points_tpu_torch.ops.features import estimate_normals_covs
    from gtsam_points_tpu_torch.types.frame import make_frame

    p, pm = _t(scene["points"][:SCAN_N], scene["mask"][:SCAN_N])
    tg = TG.build_hash_grid(p, pm, 1.0, max_points_per_cell=8)
    if entry == "knn_search":
        want = TG.knn_search(tg, p, pm, 4)
        for got, ref in zip(TG.knn_search(tg, p, pm, 4, max_points_per_cell=8), want):
            assert torch.equal(got, ref)
        with pytest.raises(ValueError, match="max_points_per_cell"):
            TG.knn_search(tg, p, pm, 4, max_points_per_cell=16)
        return
    frame = estimate_normals_covs(make_frame(scene["points"][:SCAN_N], device="cpu"), k=10, grid_leaf=1.0,
                                  max_points_per_cell=8)
    if entry == "estimate_normals_covs":
        ref = estimate_normals_covs(make_frame(scene["points"][:SCAN_N], device="cpu"), k=10, grid=tg,
                                    max_points_per_cell=8)
        assert torch.equal(frame.normals, ref.normals) and torch.equal(frame.covs, ref.covs)
        return
    make = make_gicp_factor if entry == "make_gicp_factor" else make_icp_factor
    factor = make(0, 1, frame, frame, max_corr_dist=2.0, max_points_per_cell=8)
    assert factor.grid.points_per_cell == 8
    for name in ("cell_points", "cell_pt_index", "cell_count", "hash_index"):
        assert torch.equal(getattr(factor.grid, name), getattr(tg, name))
    poses = torch.eye(4).expand(2, 4, 4).contiguous()
    factor.correspondences(poses)
    with pytest.raises(ValueError, match="max_points_per_cell"):
        make(0, 1, frame, frame, max_corr_dist=2.0, grid=tg).correspondences(poses)  # the default budget, 16
