"""Build the package's CUDA sources into shared libraries and load them.

Each source under `csrc/` has a plain C interface. It is compiled with nvcc
for sm_90a into `build/kernels/` at the root of the checkout, on first use,
and loaded with ctypes. The library's file name carries a digest of the
source, of every header under `csrc/` (`*.cuh`, which a source may include)
and of the flags, so an edited source or header is rebuilt and a stale
library is never loaded. Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

# every kernel source of the package, by stem of csrc/<name>.cu
SOURCES = ("linearize_fused", "vgicp_unary", "vgicp_moments", "vgicp_unary_dense", "vgicp_unary_batch")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def library_path(name: str) -> Path:
    """build/kernels/lib<name>-<digest>.so, the digest over csrc/<name>.cu,
    every csrc/*.cuh by name and content, and the flags."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def nvcc(name: str, out: Path, verbose: bool = False) -> subprocess.Popen:
    """Start nvcc on csrc/<name>.cu into `out`; stdout and stderr joined.
    `verbose` adds `-Xptxas -v` (registers, spills)."""
    cmd = [nvcc_path(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()), "-o", str(out),
           str(CSRC_DIR / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build_all(verbose: bool = False) -> Dict[str, str]:
    """Build every source that has no current library. -> compiler output
    per source ("" when it was already built). `verbose` adds `-Xptxas -v`
    (registers, spills). One nvcc per source, all started together; every
    one is waited for before a failure is raised."""
    logs = {name: "" for name in SOURCES}
    running = {}
    for name in SOURCES:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        running[name] = (nvcc(name, tmp, verbose), tmp, out)
    failed = []
    for name, (proc, tmp, out) in running.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{logs[name]}")
        else:
            os.replace(tmp, out)  # atomic: a reader never sees half a library
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
