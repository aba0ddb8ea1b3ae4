"""PyTorch port vs the JAX package: coarse-to-fine VGICP pyramid registration.

A 3000-point room (walls, floor, ceiling, pillars) is the target; the source
is another sampling of it with noise, so identity is the truth. Both
packages build their own pyramid from the same numpy points and covariances
and register from the same four seeded initial poses. The port runs its one
route (K1's plain version on the CPU); the JAX package runs with K1 executing
in interpret mode (`use_pallas=True`, as tests/test_pallas_linearize.py runs
it) and with its XLA twin (`use_pallas=False`). Every pose is held within
1e-3 m and 1e-3 rad of the JAX pose.

The JAX side calls its register_scan_pyramid once per stage: stages pass
nothing but the pose between them, and a one-stage call compiles once per
stage shape for the whole file, where a whole schedule would compile again
for every schedule (some 6 s each on the CPU)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gtsam_points_tpu.ops.pallas_linearize as PL
from gtsam_points_tpu.ops.features import estimate_normals_covs_moments as jcovs
from gtsam_points_tpu.ops.voxelmap import build_voxelmap as jbuild
from gtsam_points_tpu.registration import pyramid as jpyr
from gtsam_points_tpu.types.frame import make_frame as jmake
from gtsam_points_tpu.utils import se3 as jse3
from gtsam_points_tpu_torch.ops import fused_linearize as FL
from gtsam_points_tpu_torch.registration import pyramid as tpyr
from gtsam_points_tpu_torch.types.frame import make_frame as tmake
from gtsam_points_tpu_torch.utils import se3 as tse3

torch.set_num_threads(1)
N = 3000
N_INITS = 4
TOL_M = 1e-3
TOL_RAD = 1e-3


def _room(rng, n):
    """n points on a 16 x 12 x 4 m room's walls, floor and ceiling, and on
    six pillars of radius 0.4 m. The room is centred at (0.3, 0.45, 0.2), so
    no wall lies on a voxel boundary of any leaf (a wall on one splits its
    noisy points between two voxels, and neither package then converges)."""
    a, b = rng.rand(2, n).astype(np.float32)
    face = rng.randint(0, 8, n)  # 0-1 x walls, 2-3 y walls, 4-5 floor and ceiling, 6-7 pillars
    k = rng.randint(0, 6, n)
    ang = 2 * np.pi * a
    x = np.select([face < 2, face < 6], [np.where(face == 0, -8.0, 8.0), 16 * a - 8], -5 + 2 * k + 0.4 * np.cos(ang))
    y = np.select(
        [face < 2, face < 4, face < 6],
        [12 * a - 6, np.where(face == 2, -6.0, 6.0), 12 * b - 6],
        np.where(k % 2 == 0, -3.0, 3.0) + 0.4 * np.sin(ang),
    )
    z = np.where((face == 4) | (face == 5), np.where(face == 4, -2.0, 2.0), 4 * b - 2)
    return (np.stack([x, y, z], 1) + [0.3, 0.45, 0.2]).astype(np.float32)


def _covs(pts):
    f = jax.jit(jcovs)(jmake(pts))
    return np.asarray(f.covs)[: len(pts)]


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(5)
    tgt = _room(rng, N)
    src = _room(rng, N) + rng.randn(N, 3).astype(np.float32) * 0.01  # truth is identity
    tc, sc = _covs(tgt), _covs(src)
    xis = rng.uniform(-0.1, 0.1, (N_INITS, 6)).astype(np.float32)
    T0s = np.array(jax.vmap(jse3.se3_exp)(jnp.asarray(xis)))
    jtgt = jmake(tgt, covs=tc)
    build = jax.jit(jbuild)  # the leaf is traced: one compile for every leaf
    return {
        "jmaps": {leaf: build(jtgt, jnp.float32(leaf)) for leaf in (4.0, 2.0, 1.0)},
        "jsrc": jmake(src, covs=sc),
        "ttgt": tmake(tgt, covs=tc, device="cpu"), "tsrc": tmake(src, covs=sc, device="cpu"),
        "src_points": src, "T0s": T0s,
    }


def _stages(pkg, name):
    return {
        "default": pkg.DEFAULT_STAGES,
        "quality": pkg.QUALITY_STAGES,
        "legacy": ((2.0, 3), (1.0, 2)),
        "refresh": (pkg.PyramidStage(2.0, 3, stride=2, refresh=2), pkg.PyramidStage(1.0, 2)),
    }[name]


@functools.lru_cache(maxsize=None)
def _jax_stage(iters, stride, refresh, use_pallas):
    """JAX's register_scan_pyramid over one stage of this shape, jitted."""
    stage = (jpyr.PyramidStage(0.0, iters, stride, refresh),)  # the leaf lives in the map
    return jax.jit(lambda vm, src, T: jpyr.register_scan_pyramid((vm,), src, T, stage, use_pallas=use_pallas))


def _jax_register(scene, jsrc, stages, T0, use_pallas):
    T = jnp.asarray(T0)
    for st in jpyr._norm_stages(stages):
        # each stage finishes before the next is dispatched: the interpret
        # mode's callback thread dispatches operations too, and a dispatch on
        # the main thread while it runs can deadlock
        T = jax.block_until_ready(
            _jax_stage(st.iters, st.stride, st.refresh, use_pallas)(scene["jmaps"][st.leaf], jsrc, T)
        )
    return np.asarray(T)


def _jax_poses(monkeypatch, scene, name, use_pallas):
    stages = _stages(jpyr, name)
    if not use_pallas:
        return [_jax_register(scene, scene["jsrc"], stages, T0, False) for T0 in scene["T0s"]]
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(PL, "_on_tpu", lambda: True)
    with pltpu.force_tpu_interpret_mode():
        return [_jax_register(scene, scene["jsrc"], stages, T0, True) for T0 in scene["T0s"]]


def assert_poses_close(tposes, jposes):
    rot, trans = tse3.pose_error(torch.from_numpy(np.stack(jposes)), torch.stack(tposes))
    assert float(trans.max()) < TOL_M, trans
    assert float(rot.max()) < TOL_RAD, rot


@pytest.mark.parametrize("use_pallas", [True, False], ids=["kernel", "xla"])
@pytest.mark.parametrize("name", ["default", "quality", "legacy", "refresh"])
def test_register_scan_pyramid_matches_jax(monkeypatch, scene, name, use_pallas):
    stages = _stages(tpyr, name)
    maps = tpyr.build_pyramid(scene["ttgt"], stages, device="cpu")
    FL.unary_launches = 0
    tposes = [
        tpyr.register_scan_pyramid(maps, scene["tsrc"], torch.from_numpy(T0), stages, device="cpu")
        for T0 in scene["T0s"]
    ]
    assert FL.unary_launches == 0  # CPU tensors take the plain version
    assert_poses_close(tposes, _jax_poses(monkeypatch, scene, name, use_pallas))
    rot, trans = tse3.pose_error(torch.eye(4), torch.stack(tposes))  # identity is the truth
    assert float(trans.max()) < 0.01 and float(rot.max()) < 0.005, (trans, rot)


@pytest.mark.parametrize("with_covs", [True, False], ids=["covs", "eps"])
def test_register_pair_pyramid_matches_jax(scene, with_covs):
    """The one-call form (its own pyramid, DEFAULT_STAGES) against JAX's
    pair route, the XLA twin; without source covariances it runs K1's eps
    mode."""
    T0 = scene["T0s"][0]
    jsrc = scene["jsrc"] if with_covs else jmake(scene["src_points"])
    tsrc = scene["tsrc"] if with_covs else tmake(scene["src_points"], device="cpu")
    jT = _jax_register(scene, jsrc, jpyr.DEFAULT_STAGES, T0, False)
    tT = tpyr.register_pair_pyramid(scene["ttgt"], tsrc, torch.from_numpy(T0), device="cpu")
    assert_poses_close([tT], [jT])
    tI = tpyr.register_pair_pyramid(scene["ttgt"], tsrc, device="cpu")  # T0 = identity
    assert tI.shape == (4, 4) and bool(torch.all(torch.isfinite(tI)))


def test_stage_schedule_and_device_rule(monkeypatch, scene):
    """Legacy tuples normalise to PyramidStage; iters=3 over refresh=2 runs
    2 + 1 iterations after 2 probes; entry points without device= mean cuda."""
    assert tpyr._norm_stages([(2.0, 3)]) == (tpyr.PyramidStage(2.0, 3, 1, 0),)
    calls = []
    real_probe, real_lin = FL.probe_moments, FL.linearize_vgicp_unary
    monkeypatch.setattr(FL, "probe_moments", lambda *a: calls.append("probe") or real_probe(*a))
    monkeypatch.setattr(FL, "linearize_vgicp_unary", lambda *a, **k: calls.append("lin") or real_lin(*a, **k))
    stages = (tpyr.PyramidStage(2.0, 3, stride=2, refresh=2),)
    maps = tpyr.build_pyramid(scene["ttgt"], stages, device="cpu")
    tpyr.register_scan_pyramid(maps, scene["tsrc"], torch.eye(4), stages, device="cpu")
    assert calls == ["probe", "lin", "lin", "probe", "lin"]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpyr.build_pyramid(scene["ttgt"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpyr.register_scan_pyramid(maps, scene["tsrc"], torch.eye(4), stages)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpyr.register_pair_pyramid(scene["ttgt"], scene["tsrc"])
