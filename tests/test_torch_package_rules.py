"""Rules of the PyTorch port package, checked on its sources:

- it imports neither jax nor the JAX package (it keeps its own copies);
- its entry points run on `cuda` unless the caller asks for the CPU, and
  raise instead of dropping to the CPU when CUDA is absent;
- it pins float32 arithmetic (no TF32)."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

import gtsam_points_tpu_torch
from gtsam_points_tpu_torch.ops.voxelmap import empty_voxelmap
from gtsam_points_tpu_torch.pipelines.odometry import (
    OdometryParams,
    init_odometry,
    make_odometry_stepper,
)
from gtsam_points_tpu_torch.types.frame import make_frame

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
    sources = sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu"))
    assert len(sources) >= 20
    for path in sources:
        assert not banned.search(path.read_text()), path
    assert not banned.search((REPO / "chip_smoke.py").read_text())


def test_entry_points_refuse_cpu_fallback(monkeypatch):
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


def test_float32_pins():
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_kernel_build_is_deferred_and_keyed_by_source():
    """Importing builds nothing; the library name carries the source digest
    and lives in build/kernels/ (which .gitignore lists)."""
    from gtsam_points_tpu_torch import _build

    path = _build.library_path("linearize_fused")
    assert path.parent == REPO / "build" / "kernels"
    assert path.name.startswith("liblinearize_fused-") and path.suffix == ".so"
    assert "build/" in (REPO / ".gitignore").read_text().split()
    assert set(_build.SOURCES) == {p.stem for p in (PKG / "csrc").glob("*.cu")}
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
