"""The grids of the unary kernels (K1, K5, K2) and of K4 in the PyTorch port.

Each kernel's summation order, and so its result bit for bit, is fixed by
its grid, which must be a function of N alone. K1 runs one point a thread
on 128-thread blocks, at most the 256 rows its final pass sums, and K5 and
K4 run K1's partial kernel on K1's grid. A wrapper holds its
library's exported grid to its own when it loads the library; here the
libraries are stand-ins, since the kernels build only where there is a card.
On the CPU K5's plain version is K1's called without weights, bit for bit.
"""

import inspect

import numpy as np
import pytest
import torch

from gtsam_points_tpu_torch.ops import fused_linearize as FL
from gtsam_points_tpu_torch.utils import se3

torch.set_num_threads(1)


def test_moments_grid_keeps_its_values(monkeypatch):
    """K4's grid is K1's: ceil(n / 128) blocks, at least 1, at most 256. Its
    first design's grid (256-thread blocks, at most 1024) is gone, and a
    library that exports it is refused."""
    assert not hasattr(FL, "moments_num_blocks")
    sizes = (1, 255, 256, 257, 3136, 25088, 262144, 10**6)
    assert [FL.unary_num_blocks(n) for n in sizes] == [1, 2, 2, 3, 25, 196, 256, 256]
    loader, grid, values = LIBRARIES["K4"]
    monkeypatch.setattr(FL._build, "load", lambda name: _fake_library(lambda n: max(1, min(-(-n // 256), 1024)),
                                                                      **values))
    with pytest.raises(RuntimeError, match="does not match its wrapper"):
        loader()


def test_unary_grid_depends_on_n_alone():
    """K1's grid: one point a thread on 128-thread blocks, at least 1 block
    and at most the 256 rows the shared final pass sums; 25, 49, 98 and 196
    blocks at the pyramid's four stages."""
    assert list(inspect.signature(FL.unary_num_blocks).parameters) == ["n"]
    assert [FL.unary_num_blocks(n) for n in (3136, 6272, 12544, 25088)] == [25, 49, 98, 196]
    assert [FL.unary_num_blocks(n) for n in (0, 1, 128, 129, 32768, 32769, 10**8)] == [1, 1, 1, 2, 256, 256, 256]
    sizes = range(0, 300_000, 997)
    grid = [FL.unary_num_blocks(n) for n in sizes]
    assert grid == sorted(grid) and grid == [FL.unary_num_blocks(n) for n in sizes]
    assert all(1 <= b <= FL._FINAL_ROWS for b in grid)
    assert max(FL.unary_batch_num_blocks(n) for n in sizes) <= FL._FINAL_ROWS  # K2 shares the final pass


class _Fn:
    """A stand-in for a ctypes function: callable, with settable argtypes."""

    def __init__(self, value=0):
        self.argtypes, self.restype, self.value = None, None, value

    def __call__(self, *args):
        return self.value(*args) if callable(self.value) else self.value


def _fake_library(grid, **values):
    lib = type("Lib", (), {})()
    for name in ("gpt_vgicp_unary", "gpt_vgicp_unary_dense", "gpt_vgicp_unary_batch", "gpt_vgicp_moments"):
        setattr(lib, name, _Fn())
    for name, value in values.items():
        setattr(lib, name, _Fn(value))
    lib.gpt_vgicp_unary_num_blocks = _Fn(grid)
    lib.gpt_vgicp_unary_batch_num_blocks = _Fn(grid)
    return lib


LIBRARIES = {
    "K1": (FL._unary_library, FL.unary_num_blocks,
           dict(gpt_vgicp_unary_out_len=29, gpt_vgicp_unary_threads=128)),
    "K5": (FL._unary_dense_library, FL.unary_num_blocks,
           dict(gpt_vgicp_unary_dense_out_len=29, gpt_vgicp_unary_dense_threads=128)),
    "K4": (FL._moments_library, FL.unary_num_blocks,
           dict(gpt_vgicp_moments_out_len=92, gpt_vgicp_moments_threads=128)),
    "K2": (FL._unary_batch_library, FL.unary_batch_num_blocks,
           dict(gpt_vgicp_unary_batch_out_len=29, gpt_vgicp_unary_batch_threads=64,
                gpt_vgicp_unary_batch_max_lanes=65535)),
}


@pytest.mark.parametrize("kernel", sorted(LIBRARIES))
def test_wrapper_holds_library_grid_to_its_own(monkeypatch, kernel):
    """A library whose exported grid agrees with the wrapper's loads; one
    whose grid differs anywhere is refused when it loads. K5's and K4's
    wrappers hold their libraries to K1's grid: the dense view's grid (a
    column of eight points a thread) and K4's first grid are refused."""
    loader, grid, values = LIBRARIES[kernel]
    monkeypatch.setattr(FL._build, "load", lambda name: _fake_library(grid, **values))
    loader()
    wrong = {
        "K1": lambda n: max(1, min(-(-n // 256), 1024)),  # the first design's grid
        "K5": lambda n: max(1, -(-(-(-n // 8)) // 128)),  # the dense view's grid
        "K4": lambda n: max(1, min(-(-n // 256), 1024)),  # K4's first grid
        "K2": lambda n: grid(n) + (n == 10**6),
    }[kernel]
    monkeypatch.setattr(FL._build, "load", lambda name: _fake_library(wrong, **values))
    with pytest.raises(RuntimeError, match="does not match its wrapper"):
        loader()


def _payload(n, seed):
    """A seeded scan against made-up voxels: each point's raw moment row
    (count, sum p, sum ppᵀ upper) from 0-7 points scattered around it, found
    flags with a tenth False, source covariances and a pose off the
    identity."""
    rng = np.random.RandomState(seed)
    p = ((rng.rand(3, n) - 0.5) * 20.0).astype(np.float32)
    momT = np.zeros((10, n), np.float32)
    counts = rng.randint(0, 8, n)
    for i in range(n):
        q = p[:, i : i + 1] + rng.randn(3, counts[i]) * 0.3
        upper = [q[0] * q[0], q[0] * q[1], q[0] * q[2], q[1] * q[1], q[1] * q[2], q[2] * q[2]]
        momT[:, i] = [counts[i], *q.sum(1), *(u.sum() for u in upper)]
    found = rng.rand(n) > 0.1
    g = rng.randn(n, 3, 3) * 0.05
    covs = np.einsum("nij,nkj->nik", g, g) + np.eye(3) * 0.01
    covs6 = np.stack([covs[:, 0, 0], covs[:, 0, 1], covs[:, 0, 2], covs[:, 1, 1], covs[:, 1, 2], covs[:, 2, 2]])
    delta = se3.se3_exp(torch.tensor([0.01, -0.02, 0.015, 0.1, -0.05, 0.08], dtype=torch.float64))
    return (torch.from_numpy(p), torch.from_numpy(momT), torch.from_numpy(found), delta.to(torch.float32),
            torch.from_numpy(covs6.astype(np.float32)))


@pytest.mark.parametrize("n", [1, 3000, 4097])
def test_dense_plain_equals_unary_plain_bit_for_bit(n):
    """K5's route on CPU tensors equals K1's route without weights, bit for
    bit, with source covariances and in eps mode."""
    p, momT, found, delta, covs6 = _payload(n, seed=20 + n % 7)
    for sc in (covs6, None):
        k5 = FL.linearize_vgicp_unary_dense(p, momT, found, delta, 3.0, 1e-3, sc)
        k1 = FL.linearize_vgicp_unary(p, momT, found, delta, 3.0, 1e-3, sc, weights=None)
        assert int(k1.num_inliers) > 0 or n == 1
        for a, b in zip(k5, k1):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
