"""Fused point linearization (K3) and the frozen-correspondence error.

Port of `linearize_fused` and `error_fused` in
gtsam_points_tpu/ops/pallas_linearize.py. `linearize_fused` on a CUDA tensor
launches the hand-written kernel in csrc/linearize_fused.cu (or raises); on a
CPU tensor it takes `linearize_fused_plain`, the same math in plain PyTorch
(`planar.linearize_point_system` on `planar.transform`). `error_fused` is
plain PyTorch on every device, as the reference's is XLA on every backend.

`launches` counts the kernel launches of `linearize_fused`, so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from gtsam_points_tpu_torch import _build
from gtsam_points_tpu_torch.factors.linearized import Linearized
from gtsam_points_tpu_torch.ops import planar

launches = 0

_THREADS = 256  # csrc/linearize_fused.cu kThreads
_OUT = 92  # 78 upper-triangle H entries, 12 g, err, count
_POINTS_PER_THREAD = 4
_MAX_BLOCKS = 1024

# [12, 12] -> position of H[min(a,b)][max(a,b)] in the kernel's output row
_TRI = [[0] * 12 for _ in range(12)]
for _a in range(12):
    for _b in range(_a, 12):
        _TRI[_a][_b] = _TRI[_b][_a] = _a * 12 - _a * (_a - 1) // 2 + (_b - _a)
_tri_index: Dict[torch.device, torch.Tensor] = {}


def num_blocks(n: int) -> int:
    """Grid size: about four points a thread, at most 1024 blocks. It depends
    on n alone, so the summation order, and the result, is fixed for a shape."""
    return max(1, min(-(-n // (_THREADS * _POINTS_PER_THREAD)), _MAX_BLOCKS))


def _library():
    lib = _build.load("linearize_fused")
    fn = lib.gpt_linearize_fused
    if fn.argtypes is None:  # first use in this process
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        if lib.gpt_linearize_fused_out_len() != _OUT or lib.gpt_linearize_fused_threads() != _THREADS:
            raise RuntimeError("csrc/linearize_fused.cu does not match its wrapper")
    return fn


def _check(name: str, x: torch.Tensor, shape, dtype, device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _unpack(out: torch.Tensor) -> Linearized:
    index = _tri_index.get(out.device)
    if index is None:
        index = _tri_index[out.device] = torch.tensor(_TRI, dtype=torch.int64, device=out.device)
    H = out[index]
    g = out[78:90]
    return Linearized(
        H_tt=H[:6, :6],
        H_ss=H[6:, 6:],
        H_ts=H[:6, 6:],
        b_t=-g[:6],
        b_s=-g[6:],
        error=out[90],
        num_inliers=out[91].to(torch.int32),
    )


def linearize_fused_cuda(p_src, mu, W6, mask, delta) -> Linearized:
    """Launch the Hopper kernel. Inputs: p_src/mu [3, N] f32, W6 [6, N] f32,
    mask [N] bool, delta [4, 4] f32, all contiguous on one CUDA device."""
    global launches
    dev = p_src.device
    if dev.type != "cuda":
        raise ValueError(f"linearize_fused_cuda needs CUDA tensors, got {dev}")
    n = p_src.shape[-1]
    _check("p_src", p_src, (3, n), torch.float32, dev)
    _check("mu", mu, (3, n), torch.float32, dev)
    _check("W6", W6, (6, n), torch.float32, dev)
    _check("mask", mask, (n,), torch.bool, dev)
    _check("delta", delta, (4, 4), torch.float32, dev)
    fn = _library()
    blocks = num_blocks(n)
    partial = torch.empty((blocks, _OUT), dtype=torch.float32, device=dev)
    out = torch.empty((_OUT,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            p_src.data_ptr(), mu.data_ptr(), W6.data_ptr(), mask.data_ptr(), delta.data_ptr(),
            partial.data_ptr(), out.data_ptr(), n, blocks, stream,
        )
    if err != 0:
        raise RuntimeError(f"linearize_fused kernel launch failed with CUDA error {err}")
    launches += 1
    return _unpack(out)


def linearize_fused_plain(p_src, mu, W6, mask, delta) -> Linearized:
    """The same function in plain PyTorch, on any device."""
    pm = planar.transform(delta, p_src)
    return planar.linearize_point_system(p_src, pm, pm - mu, W6, mask, delta[:3, :3])


def linearize_fused(p_src, mu, W6, mask, delta) -> Linearized:
    """Fused transform + residual + weight + Jacobian + reduction. Planar
    inputs: p_src/mu [3, N], W6 [6, N], mask [N] bool, delta [4, 4]. CUDA
    tensors go to the kernel, CPU tensors to the plain version."""
    if p_src.device.type == "cpu":
        return linearize_fused_plain(p_src, mu, W6, mask, delta)
    return linearize_fused_cuda(p_src, mu, W6, mask, delta)


def error_fused(p_src, mu, W6, mask, delta) -> torch.Tensor:
    """Frozen-correspondence error sum rᵀWr; delta [..., 4, 4] -> [...]."""
    pm = planar.transform(delta, p_src)
    return planar.weighted_error(pm - mu, W6, mask)
