"""ctypes bindings to the port's host runtime (`host_ops.cpp` beside this file).

Port of the JAX package's native/ module: fast host-side IO, an exact
KdTree kNN (the oracle the reference validates its kNN against,
src/test/test_kdtree.cpp), and voxel-grid downsampling for the data-loading
path. `host_ops.cpp` is this package's own copy of the JAX package's
source, built at first use by g++ into `build/native/` at the
root of the checkout, under a file name that carries a digest of the source
and of the flags, so an edited source is rebuilt and a stale library never
loaded. Nothing is built when this module is imported.

There is no fallback: when the library cannot be built or loaded, every
entry point raises. The plain numpy versions below (`*_plain`) compute what
the library computes, and are there for the tests to hold it to:
`floor(p * float32(1 / leaf))` keys, voxels in first-seen order, float64
sums in input order, the capacity cut of a voxel first seen past it; the
exact kNN by brute force, ordered by (distance, index) as the library's heap.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from gtsam_points_tpu_torch import _build

SOURCE = Path(__file__).resolve().parent / "host_ops.cpp"
BUILD_DIR = _build.BUILD_DIR.parent / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)


def library_path() -> Path:
    """build/native/libgtsam_points_host-<digest>.so, the digest over the source and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libgtsam_points_host-{h.hexdigest()[:16]}.so"


def _compiler() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH: the host library cannot be built")
    return cxx


def build() -> Path:
    """Build the library unless it is built -> its path. Raises with the compiler's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a reader never sees half a library
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.gpt_read_floats.restype = ctypes.c_int64
        lib.gpt_read_floats.argtypes = [ctypes.c_char_p, _F32P, ctypes.c_int64]
        lib.gpt_kdtree_build.restype = ctypes.c_void_p
        lib.gpt_kdtree_build.argtypes = [_F32P, ctypes.c_int64]
        lib.gpt_kdtree_free.restype = None
        lib.gpt_kdtree_free.argtypes = [ctypes.c_void_p]
        lib.gpt_kdtree_knn.restype = None
        lib.gpt_kdtree_knn.argtypes = [ctypes.c_void_p, _F32P, ctypes.c_int64, ctypes.c_int32, _I32P, _F32P]
        lib.gpt_voxelgrid.restype = ctypes.c_int64
        lib.gpt_voxelgrid.argtypes = [_F32P, ctypes.c_int64, ctypes.c_float, _F32P, ctypes.c_int64]
        _lib = lib
        return lib


def available() -> bool:
    """True once the library is built and loaded; raises when it cannot be."""
    return _load() is not None


def _points(x) -> np.ndarray:
    a = np.ascontiguousarray(x, dtype=np.float32)
    if a.ndim != 2 or a.shape[1] != 3:
        raise ValueError(f"expected [N, 3] points, got shape {a.shape}")
    return a


def read_floats(path: str) -> np.ndarray:
    """The file's bytes as float32 (a trailing partial float dropped), by the library."""
    lib = _load()
    n = lib.gpt_read_floats(os.fsencode(path), None, 0)
    if n < 0:
        raise FileNotFoundError(path)
    out = np.empty(n, dtype=np.float32)
    got = lib.gpt_read_floats(os.fsencode(path), out.ctypes.data_as(_F32P), n)
    return out[:got]


class HostKdTree:
    """Exact KdTree over [N, 3] float32 points, built by the library."""

    def __init__(self, points):
        self._lib = _load()
        self.points = _points(points)  # the tree borrows this buffer: kept alive with the tree
        self._handle = self._lib.gpt_kdtree_build(self.points.ctypes.data_as(_F32P), len(self.points))

    def knn(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """-> (indices [Q, k] int32, squared distances [Q, k] float32), nearest
        first; a missing neighbour is -1 at 1e30."""
        queries = _points(queries)
        if k < 1:
            raise ValueError(f"k must be positive, got {k}")
        idx = np.empty((len(queries), k), dtype=np.int32)
        sq = np.empty((len(queries), k), dtype=np.float32)
        self._lib.gpt_kdtree_knn(self._handle, queries.ctypes.data_as(_F32P), len(queries), k,
                                 idx.ctypes.data_as(_I32P), sq.ctypes.data_as(_F32P))
        return idx, sq

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self._lib.gpt_kdtree_free(self._handle)
            self._handle = None


def voxelgrid_downsample(points, leaf: float, capacity: Optional[int] = None) -> np.ndarray:
    """The mean of each occupied `leaf` voxel, [M, 3] float32, voxels in the
    order first seen; at most `capacity` of them (a voxel first seen after
    `capacity` others is dropped with all its points)."""
    points = _points(points)
    cap = len(points) if capacity is None else int(capacity)
    out = np.empty((cap, 3), dtype=np.float32)
    n = _load().gpt_voxelgrid(points.ctypes.data_as(_F32P), len(points), leaf, out.ctypes.data_as(_F32P), cap)
    return out[:n].copy()


# -- plain versions: what the library computes, in numpy (for the tests) -----


def read_floats_plain(path: str) -> np.ndarray:
    return np.fromfile(path, dtype=np.float32)


def voxelgrid_downsample_plain(points, leaf: float, capacity: Optional[int] = None) -> np.ndarray:
    """`voxelgrid_downsample` in numpy: host_ops.cpp's float32 keys, its
    first-seen order and capacity cut, its float64 sums in input order."""
    points = _points(points)
    cap = len(points) if capacity is None else int(capacity)
    inv = np.float32(1.0) / np.float32(leaf)
    keys = np.floor(points * inv).astype(np.int32)
    _, first, inverse = np.unique(keys, axis=0, return_index=True, return_inverse=True)
    inverse = inverse.reshape(-1)
    slot_of = np.empty(len(first), dtype=np.int64)
    slot_of[np.argsort(first, kind="stable")] = np.arange(len(first))
    slot = slot_of[inverse]
    keep = slot < cap
    m = min(len(first), cap)
    sums = np.zeros((m, 3), dtype=np.float64)
    np.add.at(sums, slot[keep], points[keep].astype(np.float64))  # unbuffered: in input order
    counts = np.bincount(slot[keep], minlength=m).astype(np.float64)
    return (sums / counts[:, None]).astype(np.float32)


def knn_plain(points, queries, k: int, chunk: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    """The exact kNN by brute force, host_ops.cpp's float32 distances
    ((dx² + dy²) + dz²), ordered by (distance, index); -1 at 1e30 past the
    points. Among points tied at the k-th distance it may keep others than
    the library."""
    points, queries = _points(points), _points(queries)
    n = len(points)
    idx = np.full((len(queries), k), -1, dtype=np.int32)
    sq = np.full((len(queries), k), 1e30, dtype=np.float32)
    kk = min(k, n)
    for lo in range(0, len(queries), chunk):
        d3 = points[None, :, :] - queries[lo:lo + chunk, None, :]
        d = (d3[..., 0] * d3[..., 0] + d3[..., 1] * d3[..., 1]) + d3[..., 2] * d3[..., 2]
        part = np.argpartition(d, kk - 1, axis=1)[:, :kk] if kk < n else np.broadcast_to(np.arange(n), d.shape)
        dp = np.take_along_axis(d, part, axis=1)
        order = np.lexsort((part, dp), axis=1)
        idx[lo:lo + chunk, :kk] = np.take_along_axis(part, order, axis=1)
        sq[lo:lo + chunk, :kk] = np.take_along_axis(dp, order, axis=1)
    return idx, sq
