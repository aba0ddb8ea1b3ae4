"""Rules of the PyTorch port package, checked on its sources:

- it imports neither jax nor the JAX package (it keeps its own copies);
- its entry points run on `cuda` unless the caller asks for the CPU, and
  raise instead of dropping to the CPU when CUDA is absent;
- it pins float32 arithmetic (no TF32)."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import gtsam_points_tpu_torch
from gtsam_points_tpu_torch.factors import (
    PriorFactor,
    make_evm_factor,
    make_gicp_factor,
    make_imu_measurements,
    make_lsq_ba_factor,
    sim3_identity,
)
from gtsam_points_tpu_torch.ops.incremental_covariance import empty_incremental_covariance_map
from gtsam_points_tpu_torch.ops.voxelmap import empty_voxelmap, load_voxelmap, save_voxelmap
from gtsam_points_tpu_torch.optim import FactorGraph, FixedLagSmoother, ISAM2Ext
from gtsam_points_tpu_torch.parallel import Mesh, build_sharded_voxelmap, init_distributed, make_mesh, shard_frame
from gtsam_points_tpu_torch.parallel.distributed import optimize_lm_sharded
from gtsam_points_tpu_torch.pipelines.odometry import (
    OdometryParams,
    init_odometry,
    make_odometry_stepper,
)
from gtsam_points_tpu_torch.registration import (
    GNCParams,
    RANSACParams,
    estimate_fpfh,
    estimate_pose_gnc,
    estimate_pose_ransac,
)
from gtsam_points_tpu_torch.types.frame import make_frame
from gtsam_points_tpu_torch.utils import profiling
from gtsam_points_tpu_torch.utils.bspline import fit_knots
from gtsam_points_tpu_torch.utils.io import load_frame_npz, save_frame_npz
from gtsam_points_tpu_torch.utils.jacobian_test import check_factor_jacobian, numeric_gradient
from gtsam_points_tpu_torch.utils.offload import OffloadPool
from gtsam_points_tpu_torch.utils.raycast import raycast_voxels
from gtsam_points_tpu_torch.utils.stats import RunningStatistics

torch.set_num_threads(1)
PKG = pathlib.Path(gtsam_points_tpu_torch.__file__).parent
REPO = PKG.parent


def test_package_imports_without_jax():
    """Every module imports in a fresh interpreter where `import jax` fails."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['gtsam_points_tpu'] = None\n"
        "import gtsam_points_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "[importlib.import_module(n) for n in names]\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k in sys.modules if sys.modules[k] is not None)\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_no_source_names_jax_or_the_jax_package():
    banned = re.compile(r"^\s*(import jax|from jax)|gtsam_points_tpu\.", re.M)
    sources = (sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu")) + sorted(PKG.rglob("*.cuh"))
               + sorted(PKG.rglob("*.cpp")))
    assert len(sources) >= 20
    for path in sources:
        assert not banned.search(path.read_text()), path
    assert not banned.search((REPO / "chip_smoke.py").read_text())


def test_entry_points_refuse_cpu_fallback(monkeypatch, tmp_path):
    """Without device=, entry points mean cuda; with CUDA absent they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frame = make_frame([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]], device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_odometry(frame, OdometryParams(map_capacity=1024))
    with pytest.raises(RuntimeError):
        make_frame([[0.0, 0.0, 0.0]])
    with pytest.raises(RuntimeError):
        empty_voxelmap(1.0, 1024)
    with pytest.raises(RuntimeError):
        make_odometry_stepper(OdometryParams())
    # explicit CPU works, and a frame on another device than asked is refused
    state = init_odometry(frame, OdometryParams(map_capacity=1024), device="cpu")
    assert state.vmap.keys.device.type == "cpu"
    with pytest.raises(ValueError):
        init_odometry(frame, OdometryParams(map_capacity=1024), device="meta")
    # the incremental back end and loop detection, the same way
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ISAM2Ext(window_size=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FixedLagSmoother(lag=2.5)
    assert ISAM2Ext(window_size=3, device="cpu").device.type == "cpu"
    assert FixedLagSmoother(lag=2.5, device="cpu")._isam.device.type == "cpu"
    with pytest.raises(ValueError):
        ISAM2Ext(window_size=3, device="cpu").update(
            [PriorFactor(prior=torch.eye(4, device="meta"), weights=torch.ones(6, device="meta"), key=0)])
    pts = torch.rand(64, 3, generator=torch.Generator().manual_seed(0)).numpy() * 4.0
    nframe = make_frame(pts, normals=[[0.0, 0.0, 1.0]] * 64, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        estimate_fpfh(nframe)
    feats = estimate_fpfh(nframe, k=8, device="cpu")
    assert feats.shape == (nframe.capacity, 33) and feats.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        estimate_pose_gnc(nframe, nframe, feats, feats)
    with pytest.raises(ValueError):
        estimate_pose_gnc(nframe, nframe, feats, feats.to("meta"), device="cpu")
    res = estimate_pose_gnc(nframe, nframe, feats, feats, GNCParams(max_iterations=2), device="cpu")
    assert res.T_target_source.device.type == "cpu"
    # RANSAC, the bundle-adjustment factors and the voxel map's file
    small = RANSACParams(max_iterations=16, rescore_top=4, num_overlap_samples=32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        estimate_pose_ransac(nframe, nframe, feats, feats, small)
    with pytest.raises(ValueError):
        estimate_pose_ransac(nframe, nframe, feats, feats.to("meta"), small, device="cpu")
    res = estimate_pose_ransac(nframe, nframe, feats, feats, small, device="cpu")
    assert res.T_target_source.device.type == "cpu"
    per_key = {0: pts[:20], 1: pts[20:40], 2: pts[40:]}
    moments = {k: (len(p), p.mean(0), np.cov(p.T)) for k, p in per_key.items()}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_evm_factor("plane", per_key)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_lsq_ba_factor(moments)
    assert make_evm_factor("edge", per_key, device="cpu").points.device.type == "cpu"
    assert make_lsq_ba_factor(moments, device="cpu").covs.device.type == "cpu"
    path = str(tmp_path / "map.npz")
    save_voxelmap(path, empty_voxelmap(1.0, 1024, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_voxelmap(path)
    assert load_voxelmap(path, device="cpu").table.device.type == "cpu"
    # the IMU samples, the Sim(3) identity, the incremental covariance map and its statistics
    stamps, zeros = [0.0, 0.01, 0.02], np.zeros((3, 3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_imu_measurements(stamps, zeros, zeros)
    assert make_imu_measurements(stamps, zeros, zeros, 8, device="cpu").dts.shape == (8,)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sim3_identity()
    assert sim3_identity(device="cpu").scale.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        empty_incremental_covariance_map(64)
    assert empty_incremental_covariance_map(64, device="cpu").eig_stats.count.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RunningStatistics.empty((2,))
    assert RunningStatistics.empty((2,), device="cpu").total.device.type == "cpu"
    # the distributed layer: the sharded map, the rank's device, the mesh and the sharded LM
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_sharded_voxelmap(frame, 1.0, 2)
    assert build_sharded_voxelmap(frame, 1.0, 2, device="cpu").keys.shape == (2, frame.capacity)
    with pytest.raises(ValueError):
        build_sharded_voxelmap(frame, 1.0, 2, device="meta")
    store = f"file://{tmp_path / 'store'}"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_distributed(0, 1, store, "gloo")
    assert init_distributed(0, 1, store, "gloo", device="cpu").type == "cpu"
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh()
        mesh = make_mesh(axis="factor", device="cpu")
        assert mesh.device.type == "cpu" and mesh.size("factor") == 1
        with pytest.raises(ValueError):
            shard_frame(frame, make_mesh(axis="factor", device="meta"), axis="factor")
        graph = FactorGraph(num_poses=1)
        graph.add(PriorFactor(prior=torch.eye(4), weights=torch.ones(6), key=0))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            optimize_lm_sharded(graph, torch.eye(4)[None], Mesh([0], ("factor",), "cuda"))
        assert optimize_lm_sharded(graph, torch.eye(4)[None], mesh).poses.device.type == "cpu"
        with pytest.raises(ValueError):
            optimize_lm_sharded(graph, torch.eye(4, device="meta")[None], mesh)
    finally:
        torch.distributed.destroy_process_group()
    # the frame's file, the offload pool and the device trace
    path = str(tmp_path / "frame.npz")
    save_frame_npz(path, frame)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_frame_npz(path)
    assert load_frame_npz(path, device="cpu").points.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OffloadPool(1024)
    assert OffloadPool(1024, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with profiling.trace(str(tmp_path / "trace")):
            pass
    with profiling.trace(str(tmp_path / "trace"), device="cpu"):
        torch.ones(2).sum()
    assert (tmp_path / "trace" / "trace.json").exists()
    # the B-spline fit
    stamps, poses = torch.arange(5) / 10.0, torch.eye(4).expand(5, 4, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fit_knots(stamps, poses, 0.0, 0.4, 0.1)
    assert fit_knots(stamps, poses, 0.0, 0.4, 0.1, iterations=1, device="cpu").knots.device.type == "cpu"
    with pytest.raises(ValueError):
        fit_knots(stamps, poses.to("meta"), 0.0, 0.4, 0.1, device="cpu")
    # the raycaster and the Jacobian check's numeric gradient
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        raycast_voxels([[0.0, 0.0, 0.0]], [[1.0, 1.0, 1.0]], 0.5, 8)
    coords, valid = raycast_voxels([[0.0, 0.0, 0.0]], [[1.0, 1.0, 1.0]], 0.5, 8, device="cpu")
    assert coords.device.type == "cpu" and int(valid.sum()) == 6
    with pytest.raises(ValueError):
        raycast_voxels(torch.zeros(1, 3, device="meta"), torch.ones(1, 3, device="meta"), 0.5, 8, device="cpu")
    eye2 = np.stack([np.eye(4, dtype=np.float32)] * 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        numeric_gradient(lambda p: p.sum(), eye2, 1)
    assert numeric_gradient(lambda p: p.sum(), eye2, 1, device="cpu").shape == (6,)
    with pytest.raises(ValueError):
        numeric_gradient(lambda p: p.sum(), torch.from_numpy(eye2).to("meta"), 1, device="cpu")
    # check_factor_jacobian has no device of its own: it runs on its factor's (a CPU factor here, as no
    # CUDA factor can be made without CUDA) and refuses poses on another device
    gframe = make_frame(pts, covs=np.tile(np.eye(3, dtype=np.float32), (64, 1, 1)), device="cpu")
    gicp = make_gicp_factor(0, 1, gframe, gframe, max_corr_dist=1.0)
    assert set(check_factor_jacobian(gicp, eye2)) == {"source", "target"}
    with pytest.raises(ValueError):
        check_factor_jacobian(gicp, torch.from_numpy(eye2).to("meta"))


def test_every_module_has_a_counterpart():
    """Every module of the JAX package has a file at the same path in the
    port (the TPU kernels of ops/pallas_linearize.py are ops/fused_linearize.py's):
    the port does all that the JAX package does."""
    jax_package = REPO / "gtsam_points_tpu"
    renamed = {"ops/pallas_linearize.py": "ops/fused_linearize.py"}
    modules = [p.relative_to(jax_package).as_posix() for p in sorted(jax_package.rglob("*.py"))]
    assert len(modules) >= 60 and "utils/raycast.py" in modules and "utils/jacobian_test.py" in modules
    assert [m for m in modules if not (PKG / renamed.get(m, m)).is_file()] == []


def test_native_loads_only_its_own_library():
    """The port's host library is built from its own source into build/native/;
    nothing under gtsam_points_tpu/ or native/ is read or mapped."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['gtsam_points_tpu'] = None\n"
        "from gtsam_points_tpu_torch import native\n"
        "assert native.available()\n"
        "print(native.SOURCE)\n"
        "print(native.library_path())\n"
        "print(open('/proc/self/maps').read())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    source, lib, maps = out.stdout.split("\n", 2)
    assert pathlib.Path(source).parent == PKG / "native"
    assert pathlib.Path(lib).parent == REPO / "build" / "native"
    assert lib in maps
    for banned in (REPO / "gtsam_points_tpu", REPO / "native"):
        assert str(banned) + "/" not in maps
    text = (PKG / "native" / "__init__.py").read_text()
    assert "gtsam_points_tpu/" not in text.replace("gtsam_points_tpu_torch/", "")


def test_native_raises_without_a_compiler(monkeypatch, tmp_path):
    """No fallback: with nothing built and no g++ on PATH, every entry point raises."""
    from gtsam_points_tpu_torch import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    (tmp_path / "points.bin").write_bytes(np.zeros(6, np.float32).tobytes())
    pts = np.zeros((4, 3), np.float32)
    for call in (native.available, lambda: native.read_floats(str(tmp_path / "points.bin")),
                 lambda: native.HostKdTree(pts), lambda: native.voxelgrid_downsample(pts, 0.5)):
        with pytest.raises(RuntimeError, match="compiler"):
            call()
    assert not (tmp_path / "native").exists() or not any((tmp_path / "native").iterdir())


def test_float32_pins():
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_kernel_build_is_deferred_and_keyed_by_source(monkeypatch, tmp_path):
    """Importing builds nothing; the library name carries the digest of the
    source and of every csrc/*.cuh header, and lives in build/kernels/
    (which .gitignore lists). Editing a header or a source changes the name,
    so a stale library is never loaded."""
    import shutil

    from gtsam_points_tpu_torch import _build

    path = _build.library_path("linearize_fused")
    assert path.parent == REPO / "build" / "kernels"
    assert path.name.startswith("liblinearize_fused-") and path.suffix == ".so"
    assert "build/" in (REPO / ".gitignore").read_text().split()
    assert set(_build.SOURCES) == {p.stem for p in (PKG / "csrc").glob("*.cu")}
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)

    csrc = tmp_path / "csrc"
    shutil.copytree(PKG / "csrc", csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    assert _build.library_path("vgicp_unary") == _build.library_path("vgicp_unary")
    names = {name: _build.library_path(name) for name in _build.SOURCES}
    assert names["vgicp_unary"] == REPO / "build" / "kernels" / _build.library_path("vgicp_unary").name
    header = csrc / "unary_point.cuh"
    assert '#include "unary_point.cuh"' in (csrc / "vgicp_unary.cu").read_text()
    assert '#include "unary_point.cuh"' in (csrc / "vgicp_unary_dense.cu").read_text()
    header.write_text(header.read_text() + "// edited\n")
    edited = {name: _build.library_path(name) for name in _build.SOURCES}
    assert all(edited[name] != names[name] for name in _build.SOURCES)
    (csrc / "vgicp_moments.cu").write_text((csrc / "vgicp_moments.cu").read_text() + "// edited\n")
    assert _build.library_path("vgicp_moments") != edited["vgicp_moments"]
    assert _build.library_path("vgicp_unary") == edited["vgicp_unary"]
