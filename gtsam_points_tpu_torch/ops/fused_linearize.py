"""Fused linearizations on Hopper kernels, and the probes that feed them.

Port of gtsam_points_tpu/ops/pallas_linearize.py, in part:

- K3, `linearize_fused`: the 12x12 point-to-distribution system on a frozen
  correspondence payload. On a CUDA tensor it launches the hand-written
  kernel in csrc/linearize_fused.cu (or raises); on a CPU tensor it takes
  `linearize_fused_plain` (`planar.linearize_point_system` on
  `planar.transform`). The kernel sums 29 terms a point and expands them to
  the 12x12 system once; `linearize_fused_source_plain` is that arithmetic in
  plain PyTorch, for the tests. `error_fused` is plain PyTorch on every
  device, as the reference's is XLA on every backend.
- K1, `linearize_vgicp_unary`: the unary (source-block-only) VGICP system
  from raw voxel moments. On a CUDA tensor it launches csrc/vgicp_unary.cu
  (or raises); on a CPU tensor it takes `linearize_vgicp_unary_plain`, the
  port of the reference's XLA twin `linearize_vgicp_unary_xla`.
- K2, `linearize_vgicp_unary_batch`: K1's sums for B poses over one shared
  source, in one launch pair. On CUDA tensors it launches
  csrc/vgicp_unary_batch.cu (or raises); on CPU tensors it takes
  `linearize_vgicp_unary_batch_plain`, `torch.func.vmap` of K1's plain
  version: the port of the reference's off-TPU route, `jax.vmap` of
  `linearize_vgicp_unary_xla`.
- K4, `linearize_vgicp_moments`: the full 12x12 VGICP system from raw voxel
  moments (finalize, fused covariance in the target frame, 3x3 inverse,
  Jacobians and reduction in one pass). On a CUDA tensor it launches
  csrc/vgicp_moments.cu (or raises); on a CPU tensor it takes
  `linearize_vgicp_moments_plain`, the port of `linearize_vgicp_moments_xla`.
  `vgicp_scan_linearize` is the single-scan entry point: probe, then K4.
- K5, `linearize_vgicp_unary_dense`: K1's contract without weights, over
  the dense [8, N/8] view of the planes, eight points a thread. On a CUDA
  tensor it launches csrc/vgicp_unary_dense.cu (or raises); on a CPU tensor
  it takes `linearize_vgicp_unary_dense_plain`, which is K1's plain version
  (called without weights), as the reference falls back to the same XLA
  twin off the TPU.
- `probe_moments`: transform + hash probe -> the raw moment rows K1 and K4 read.
  The reference selects the matched record with two 0/1 matmuls, a TPU
  device whose sums hold exactly one nonzero term; here the record picked by
  `table_probe` is used directly, which gives the same rows.

`launches`, `unary_launches`, `unary_batch_launches`, `moments_launches` and
`dense_launches` count the kernel launches of K3, K1, K2, K4 and K5, so a run
can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from gtsam_points_tpu_torch import _build
from gtsam_points_tpu_torch.factors.linearized import Linearized
from gtsam_points_tpu_torch.ops import planar
from gtsam_points_tpu_torch.ops import voxel_keys as vk
from gtsam_points_tpu_torch.ops.voxelmap import GaussianVoxelMap, table_probe

launches = 0
unary_launches = 0
unary_batch_launches = 0
moments_launches = 0
dense_launches = 0

_THREADS = 128  # csrc/linearize_fused.cu kThreads
_MAX_BLOCKS = 256  # its kMaxBlocks
_OUT = 92  # 78 upper-triangle H entries, 12 g, err, count

# [12, 12] -> position of H[min(a,b)][max(a,b)] in the kernel's output row
_TRI = [[0] * 12 for _ in range(12)]
for _a in range(12):
    for _b in range(_a, 12):
        _TRI[_a][_b] = _TRI[_b][_a] = _a * 12 - _a * (_a - 1) // 2 + (_b - _a)
_tri_index: Dict[torch.device, torch.Tensor] = {}


def num_blocks(n: int) -> int:
    """K3's grid: one point a thread, at most 256 blocks. It depends on n
    alone, so the summation order, and the result, is fixed for a shape."""
    return max(1, min(-(-n // _THREADS), _MAX_BLOCKS))


def _library():
    """K3's launcher, csrc/linearize_fused.cu."""
    lib = _build.load("linearize_fused")
    fn = lib.gpt_linearize_fused
    if fn.argtypes is None:  # first use in this process
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        if (lib.gpt_linearize_fused_out_len() != _OUT or lib.gpt_linearize_fused_threads() != _THREADS
                or lib.gpt_linearize_fused_max_blocks() != _MAX_BLOCKS):
            raise RuntimeError("csrc/linearize_fused.cu does not match its wrapper")
    return fn


def _check(name: str, x: torch.Tensor, shape, dtype, device: torch.device, contiguous: bool = True) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if contiguous and not x.is_contiguous():
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
    partial = torch.empty((blocks, _UNARY_OUT), dtype=torch.float32, device=dev)  # K3's 29 sums, K1's layout
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


def _expand_source_sums(sums: torch.Tensor, delta: torch.Tensor) -> Linearized:
    """K3's final step in plain PyTorch: the 29 sums of the rotated-source
    block (K1's layout, with q = R p in place of p and W in place of A) ->
    the 12x12 system. With J~ = [-skew(q) | I], D = diag(R, R) and N =
    [I 0; -skew(t) I]: J_s = J~ D and J_t = -J~ N, so H_ss = Dᵀ H~ D,
    H_tt = Nᵀ H~ N, H_ts = -Nᵀ H~ D, b_s = -Dᵀ g~ and b_t = Nᵀ g~."""
    R, t = delta[:3, :3], delta[:3, 3]
    zero = t.new_zeros(())
    z3 = t.new_zeros((3, 3))
    eye3 = torch.eye(3, dtype=t.dtype, device=t.device)
    skew_t = torch.stack([
        torch.stack([zero, -t[2], t[1]]),
        torch.stack([t[2], zero, -t[0]]),
        torch.stack([-t[1], t[0], zero]),
    ])
    D = torch.cat([torch.cat([R, z3], 1), torch.cat([z3, R], 1)])
    N = torch.cat([torch.cat([eye3, z3], 1), torch.cat([-skew_t, eye3], 1)])
    src = _unpack_unary(sums)
    H, g = src.H_ss, -src.b_s  # H~, g~
    HD = H @ D
    return Linearized(
        H_tt=N.T @ (H @ N),
        H_ss=D.T @ HD,
        H_ts=-(N.T @ HD),
        b_t=N.T @ g,
        b_s=-(D.T @ g),
        error=src.error,
        num_inliers=src.num_inliers,
    )


def linearize_fused_source_plain(p_src, mu, W6, mask, delta) -> Linearized:
    """K3's own arithmetic in plain PyTorch, on any device: per point
    q = R p and r = (q + t) - mu, the 29 sums of `_unary_terms` with W as
    the weight (0 where the mask is False), then `_expand_source_sums`. The
    same function as `linearize_fused_plain`, summed another way."""
    R, t = delta[:3, :3], delta[:3, 3]
    q = R @ p_src
    r = (q + t[:, None]) - mu
    zero = torch.zeros((), dtype=p_src.dtype, device=p_src.device)
    q, r, w = (torch.where(mask, x, zero) for x in (q, r, W6))
    terms = _unary_terms(q, w, r, mask.to(p_src.dtype))
    return _expand_source_sums(torch.sum(terms, dim=1), delta)


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


# ---------------------------------------------------------------------------
# K1: unary VGICP linearize from raw voxel moments
# ---------------------------------------------------------------------------

_UNARY_THREADS = 256  # csrc/vgicp_unary.cu kThreads
_UNARY_OUT = 29  # h11 (6), sA (9), A (6), p x u (3), u (3), error, weighted count
_UNARY_MAX_BLOCKS = 1024

# [6, 6] H_ss = [[h11, sA], [sAᵀ, A]] as positions in the 29 sums
_UNARY_H = [
    [0, 1, 2, 6, 7, 8],
    [1, 3, 4, 9, 10, 11],
    [2, 4, 5, 12, 13, 14],
    [6, 9, 12, 15, 16, 17],
    [7, 10, 13, 16, 18, 19],
    [8, 11, 14, 17, 19, 20],
]
_unary_h_index: Dict[torch.device, torch.Tensor] = {}


def unary_num_blocks(n: int) -> int:
    """K1's grid: one point a thread, at most 1024 blocks. It depends on n
    alone, so the summation order, and the result, is fixed for a shape."""
    return max(1, min(-(-n // _UNARY_THREADS), _UNARY_MAX_BLOCKS))


def _unary_library():
    """K1's launcher, csrc/vgicp_unary.cu."""
    lib = _build.load("vgicp_unary")
    fn = lib.gpt_vgicp_unary
    if fn.argtypes is None:  # first use in this process
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_float, ctypes.c_float]
            + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        if lib.gpt_vgicp_unary_out_len() != _UNARY_OUT or lib.gpt_vgicp_unary_threads() != _UNARY_THREADS:
            raise RuntimeError("csrc/vgicp_unary.cu does not match its wrapper")
    return fn


def _unpack_unary(col: torch.Tensor) -> Linearized:
    """29 sums (h11, sA, A, p x u, u, error, weighted count) [..., 29] ->
    Linearized with only the source block, each field with col's leading
    axes; the target blocks are zero."""
    index = _unary_h_index.get(col.device)
    if index is None:
        # an asynchronous copy: a blocking one would sync the stream
        index = torch.tensor(_UNARY_H, dtype=torch.int64).to(col.device, non_blocking=True)
        _unary_h_index[col.device] = index
    lead = col.shape[:-1]
    z6 = col.new_zeros(lead + (6, 6))
    return Linearized(
        H_tt=z6,
        H_ss=col[..., index],
        H_ts=z6,
        b_t=col.new_zeros(lead + (6,)),
        b_s=-col[..., 21:27],
        error=col[..., 27],
        num_inliers=col[..., 28].to(torch.int32),
    )


def _check_unary(p_src, momT, found, delta, src_covs6, weights=None, contiguous: bool = True) -> int:
    """Shapes, dtypes and one device of K1's and K5's inputs; contiguity only
    for the kernels. -> N"""
    dev = p_src.device
    if p_src.dim() != 2:
        raise ValueError(f"p_src has shape {tuple(p_src.shape)}, expected [3, N]")
    n = p_src.shape[1]
    _check("p_src", p_src, (3, n), torch.float32, dev, contiguous)
    _check("momT", momT, (10, n), torch.float32, dev, contiguous)
    _check("found", found, (n,), torch.bool, dev, contiguous)
    _check("delta", delta, (4, 4), torch.float32, dev, contiguous)
    if src_covs6 is not None:
        _check("src_covs6", src_covs6, (6, n), torch.float32, dev, contiguous)
    if weights is not None:
        _check("weights", weights, (n,), torch.float32, dev, contiguous)
    return n


def linearize_vgicp_unary_cuda(
    p_src, momT, found, delta, min_voxel_points, eps=1e-3, src_covs6=None, weights=None
) -> Linearized:
    """Launch the Hopper kernel. Inputs: p_src [3, N], momT [10, N], found
    [N] bool, delta [4, 4], src_covs6 [6, N] or None, weights [N] or None, all
    f32 (but found) and contiguous on one CUDA device."""
    global unary_launches
    dev = p_src.device
    if dev.type != "cuda":
        raise ValueError(f"linearize_vgicp_unary_cuda needs CUDA tensors, got {dev}")
    n = _check_unary(p_src, momT, found, delta, src_covs6, weights)
    fn = _unary_library()
    blocks = unary_num_blocks(n)
    partial = torch.empty((blocks, _UNARY_OUT), dtype=torch.float32, device=dev)
    out = torch.empty((_UNARY_OUT,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            p_src.data_ptr(), momT.data_ptr(), found.data_ptr(),
            None if weights is None else weights.data_ptr(),
            None if src_covs6 is None else src_covs6.data_ptr(),
            delta.data_ptr(), float(min_voxel_points), float(eps),
            partial.data_ptr(), out.data_ptr(), n, blocks, stream,
        )
    if err != 0:
        raise RuntimeError(f"vgicp_unary kernel launch failed with CUDA error {err}")
    unary_launches += 1
    return _unpack_unary(out)


def _voxel_stats(momT: torch.Tensor):
    """Raw moment rows [10, N] -> (mean [3, N], covariance [6, N]) of each
    point's voxel: sum p / n and sum ppᵀ / n - mu muᵀ."""
    safe = torch.clamp(momT[0], min=1.0)
    mu = momT[1:4] / safe
    mu2 = torch.stack(
        [mu[0] * mu[0], mu[0] * mu[1], mu[0] * mu[2], mu[1] * mu[1], mu[1] * mu[2], mu[2] * mu[2]]
    )
    return mu, momT[4:10] / safe - mu2


def linearize_vgicp_unary_plain(
    p_src, momT, found, delta, min_voxel_points, eps=1e-3, src_covs6=None, weights=None
) -> Linearized:
    """The same function in plain PyTorch, on any device: the reference's
    XLA twin `linearize_vgicp_unary_xla`. `weights` ([N], non-negative)
    scale each point's contribution, so `num_inliers` is the weighted count."""
    okf = (found & (momT[0] >= min_voxel_points)).to(torch.float32)
    if weights is not None:
        okf = okf * weights
    mu, ct6 = _voxel_stats(momT)
    R = delta[:3, :3]
    # fused covariance in the source frame: F = Rᵀ C_t R + C_src (or + eps I)
    F = planar.sym_rotate(R.T, ct6)
    if src_covs6 is not None:
        F = F + src_covs6
    else:
        F = torch.stack([F[0] + eps, F[1], F[2], F[3] + eps, F[4], F[5] + eps])
    A = planar.sym_inv(F) * okf[None, :]
    d = delta[:3, 3, None] - mu
    rp = p_src + R.T @ d  # r' = Rᵀ r
    return _unpack_unary(torch.sum(_unary_terms(p_src, A, rp, okf), dim=1))


def _unary_terms(p_src, A, rp, count):
    """The 29 per-point terms [29, N] of the unary source block, in the
    kernels' order: h11 = skew(p) A skew(p)ᵀ (6), sA = skew(p) A (9), A (6),
    p x u (3), u = A r' (3), u·r', count. p_src, rp [3, N]; A [6, N]
    (symmetric, upper); count [N]."""
    axx, axy, axz, ayy, ayz, azz = A
    u0 = axx * rp[0] + axy * rp[1] + axz * rp[2]
    u1 = axy * rp[0] + ayy * rp[1] + ayz * rp[2]
    u2 = axz * rp[0] + ayz * rp[1] + azz * rp[2]
    err = u0 * rp[0] + u1 * rp[1] + u2 * rp[2]
    p0, p1, p2 = p_src[0], p_src[1], p_src[2]
    # sA = skew(p) A; skew rows (0, -p2, p1), (p2, 0, -p0), (-p1, p0, 0)
    sA00 = -p2 * axy + p1 * axz
    sA01 = -p2 * ayy + p1 * ayz
    sA02 = -p2 * ayz + p1 * azz
    sA10 = p2 * axx - p0 * axz
    sA11 = p2 * axy - p0 * ayz
    sA12 = p2 * axz - p0 * azz
    sA20 = -p1 * axx + p0 * axy
    sA21 = -p1 * axy + p0 * ayy
    sA22 = -p1 * axz + p0 * ayz
    # h11 = sA skew(p)ᵀ: h11[i][j] = sA[i] . skew_row[j]
    h1100 = -p2 * sA01 + p1 * sA02
    h1101 = p2 * sA00 - p0 * sA02
    h1102 = -p1 * sA00 + p0 * sA01
    h1111 = p2 * sA10 - p0 * sA12
    h1112 = -p1 * sA10 + p0 * sA11
    h1122 = -p1 * sA20 + p0 * sA21
    bt0 = p1 * u2 - p2 * u1
    bt1 = p2 * u0 - p0 * u2
    bt2 = p0 * u1 - p1 * u0
    stack = torch.stack(
        [
            h1100, h1101, h1102, h1111, h1112, h1122,
            sA00, sA01, sA02, sA10, sA11, sA12, sA20, sA21, sA22,
            axx, axy, axz, ayy, ayz, azz,
            bt0, bt1, bt2, u0, u1, u2,
            err, count,
        ]
    )  # [29, N]
    return stack


def linearize_vgicp_unary(
    p_src, momT, found, delta, min_voxel_points, eps=1e-3, src_covs6=None, weights=None
) -> Linearized:
    """Unary (source-block-only) VGICP linearize from raw moment rows.

    p_src [3, N], momT [10, N] (count, sum p, sum ppᵀ upper of each point's
    voxel), found [N] bool, delta [4, 4], src_covs6 [6, N] or None (then
    eps-regularized point-to-distribution), weights [N] or None. -> Linearized
    with H_ss, b_s, error and num_inliers set and zero target blocks. CUDA
    tensors go to the kernel, CPU tensors to the plain version."""
    if p_src.device.type == "cpu":
        return linearize_vgicp_unary_plain(p_src, momT, found, delta, min_voxel_points, eps, src_covs6, weights)
    return linearize_vgicp_unary_cuda(p_src, momT, found, delta, min_voxel_points, eps, src_covs6, weights)


def probe_moments(vmap: GaussianVoxelMap, p_src: torch.Tensor, mask: torch.Tensor, delta: torch.Tensor):
    """Transform + hash probe + one bucket-row gather -> (momT [10, N]
    contiguous, found [N]): the correspondence refresh that feeds K1."""
    pm = planar.transform(delta, p_src)
    keys = vk.point_keys_planar(pm, mask, vmap.leaf)
    _, found, pick, _ = table_probe(vmap.table, keys)
    return pick[:, 2:12].T.contiguous(), found & mask


# ---------------------------------------------------------------------------
# K5: K1's sums without weights over the dense view
# ---------------------------------------------------------------------------

_DENSE_THREADS = 128  # csrc/vgicp_unary_dense.cu kThreads
_DENSE_ROWS = 8  # its kRows: the rows of the dense view, points a thread


def unary_dense_num_blocks(n: int) -> int:
    """K5's grid for n >= 1 points: one thread a column of the [8, ceil(n/8)]
    view, _DENSE_THREADS columns a block."""
    cols = -(-n // _DENSE_ROWS)
    return -(-cols // _DENSE_THREADS)


def _unary_dense_library():
    """K5's launcher, csrc/vgicp_unary_dense.cu."""
    lib = _build.load("vgicp_unary_dense")
    fn = lib.gpt_vgicp_unary_dense
    if fn.argtypes is None:  # first use in this process
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_float]
            + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        if (lib.gpt_vgicp_unary_dense_out_len() != _UNARY_OUT
                or lib.gpt_vgicp_unary_dense_threads() != _DENSE_THREADS
                or lib.gpt_vgicp_unary_dense_rows() != _DENSE_ROWS):
            raise RuntimeError("csrc/vgicp_unary_dense.cu does not match its wrapper")
    return fn


def linearize_vgicp_unary_dense_cuda(
    p_src, momT, found, delta, min_voxel_points, eps=1e-3, src_covs6=None
) -> Linearized:
    """Launch the Hopper kernel. Inputs: p_src [3, N] with N >= 1, momT
    [10, N], found [N] bool, delta [4, 4], src_covs6 [6, N] or None, all f32
    (but found) and contiguous on one CUDA device."""
    global dense_launches
    n = _check_unary(p_src, momT, found, delta, src_covs6)
    dev = p_src.device
    if dev.type != "cuda":
        raise ValueError(f"linearize_vgicp_unary_dense_cuda needs CUDA tensors, got {dev}")
    if n < 1:
        raise ValueError("linearize_vgicp_unary_dense_cuda needs at least one point")
    fn = _unary_dense_library()
    blocks = unary_dense_num_blocks(n)
    partial = torch.empty((blocks, _UNARY_OUT), dtype=torch.float32, device=dev)
    out = torch.empty((_UNARY_OUT,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            p_src.data_ptr(), momT.data_ptr(), found.data_ptr(),
            None if src_covs6 is None else src_covs6.data_ptr(),
            delta.data_ptr(), float(min_voxel_points), float(eps),
            partial.data_ptr(), out.data_ptr(), n, blocks, stream,
        )
    if err != 0:
        raise RuntimeError(f"vgicp_unary_dense kernel launch failed with CUDA error {err}")
    dense_launches += 1
    return _unpack_unary(out)


# The same function in plain PyTorch, on any device: K1's plain version,
# called without weights, as the reference takes `linearize_vgicp_unary_xla`
# for K5 off the TPU.
linearize_vgicp_unary_dense_plain = linearize_vgicp_unary_plain


def linearize_vgicp_unary_dense(
    p_src, momT, found, delta, min_voxel_points, eps=1e-3, src_covs6=None
) -> Linearized:
    """Unary VGICP linearize over the dense view: K1's contract
    (`linearize_vgicp_unary`) without weights. -> Linearized with H_ss, b_s,
    error and num_inliers set and zero target blocks. CUDA tensors go to the
    kernel, CPU tensors to the plain version."""
    if p_src.device.type == "cpu":
        _check_unary(p_src, momT, found, delta, src_covs6, contiguous=False)
        return linearize_vgicp_unary_dense_plain(p_src, momT, found, delta, min_voxel_points, eps, src_covs6)
    return linearize_vgicp_unary_dense_cuda(p_src, momT, found, delta, min_voxel_points, eps, src_covs6)


# ---------------------------------------------------------------------------
# K2: K1 for B poses over one shared source, in one launch
# ---------------------------------------------------------------------------


_BATCH_THREADS = 64  # csrc/vgicp_unary_batch.cu kThreads
_BATCH_POINTS_PER_THREAD = 4  # its kQuadsPerThread quads of four points
_BATCH_MAX_BLOCKS = 256  # its kMaxBlocks, blocks a lane
_BATCH_MAX_LANES = 65535  # its kMaxLanes: the lanes run on gridDim.y


def unary_batch_num_blocks(n: int) -> int:
    """K2's blocks a lane: four points a thread, at most 256 blocks. It
    depends on n alone, never on the number of lanes, so a lane's sums, and
    its result, are the same whichever lanes share the launch."""
    return max(1, min(-(-n // (_BATCH_THREADS * _BATCH_POINTS_PER_THREAD)), _BATCH_MAX_BLOCKS))


def _unary_batch_library():
    """K2's launcher, csrc/vgicp_unary_batch.cu."""
    lib = _build.load("vgicp_unary_batch")
    fn = lib.gpt_vgicp_unary_batch
    if fn.argtypes is None:  # first use in this process
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_float]
            + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        if (lib.gpt_vgicp_unary_batch_out_len() != _UNARY_OUT
                or lib.gpt_vgicp_unary_batch_threads() != _BATCH_THREADS
                or lib.gpt_vgicp_unary_batch_max_lanes() != _BATCH_MAX_LANES):
            raise RuntimeError("csrc/vgicp_unary_batch.cu does not match its wrapper")
    return fn


def _check_unary_batch(p_src, momT_b, found_b, deltas, src_covs6, contiguous: bool):
    """Shapes, dtypes and one device of K2's inputs; contiguity only for the
    kernel. -> (B, N)"""
    dev = p_src.device
    if deltas.dim() != 3 or deltas.shape[0] < 1:
        raise ValueError(f"deltas has shape {tuple(deltas.shape)}, expected [B, 4, 4] with B >= 1")
    b, n = deltas.shape[0], p_src.shape[-1]
    _check("p_src", p_src, (3, n), torch.float32, dev, contiguous)
    _check("momT_b", momT_b, (b, 10, n), torch.float32, dev, contiguous)
    _check("found_b", found_b, (b, n), torch.bool, dev, contiguous)
    _check("deltas", deltas, (b, 4, 4), torch.float32, dev, contiguous)
    if src_covs6 is not None:
        _check("src_covs6", src_covs6, (6, n), torch.float32, dev, contiguous)
    return b, n


def linearize_vgicp_unary_batch_cuda(
    p_src, momT_b, found_b, deltas, min_voxel_points, eps=1e-3, src_covs6=None
) -> Linearized:
    """Launch the Hopper kernel. Inputs: p_src [3, N] and src_covs6 [6, N] or
    None shared by the lanes, momT_b [B, 10, N], found_b [B, N] bool, deltas
    [B, 4, 4], all f32 (but found_b) and contiguous on one CUDA device, with
    1 <= B <= 65535. An expanded (stride 0) momT_b is refused: each lane reads
    its own rows. 16-byte loads are taken where N is a multiple of 4 and the
    planes are aligned; the result does not depend on it."""
    global unary_batch_launches
    dev = p_src.device
    if dev.type != "cuda":
        raise ValueError(f"linearize_vgicp_unary_batch_cuda needs CUDA tensors, got {dev}")
    b, n = _check_unary_batch(p_src, momT_b, found_b, deltas, src_covs6, contiguous=True)
    if b > _BATCH_MAX_LANES:
        raise ValueError(f"{b} lanes, at most {_BATCH_MAX_LANES} in one launch")
    fn = _unary_batch_library()
    blocks = unary_batch_num_blocks(n)
    partial = torch.empty((b, blocks, _UNARY_OUT), dtype=torch.float32, device=dev)
    out = torch.empty((b, _UNARY_OUT), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            p_src.data_ptr(), momT_b.data_ptr(), found_b.data_ptr(),
            None if src_covs6 is None else src_covs6.data_ptr(),
            deltas.data_ptr(), float(min_voxel_points), float(eps),
            partial.data_ptr(), out.data_ptr(), n, blocks, b, stream,
        )
    if err != 0:
        raise RuntimeError(f"vgicp_unary_batch kernel launch failed with CUDA error {err}")
    unary_batch_launches += 1
    return _unpack_unary(out)


def linearize_vgicp_unary_batch_plain(
    p_src, momT_b, found_b, deltas, min_voxel_points, eps=1e-3, src_covs6=None
) -> Linearized:
    """The same function in plain PyTorch, on any device: K1's plain version
    mapped over (momT_b, found_b, deltas) with p_src and src_covs6 shared, as
    the reference maps `linearize_vgicp_unary_xla` off the TPU."""

    def lane(momT, found, delta):
        return linearize_vgicp_unary_plain(p_src, momT, found, delta, min_voxel_points, eps, src_covs6)

    return torch.func.vmap(lane)(momT_b, found_b, deltas)


def linearize_vgicp_unary_batch(
    p_src, momT_b, found_b, deltas, min_voxel_points, eps=1e-3, src_covs6=None
) -> Linearized:
    """Batched unary VGICP linearize: B poses sharing one source scan.

    p_src [3, N] and src_covs6 [6, N] or None are shared; momT_b [B, 10, N],
    found_b [B, N] bool, deltas [B, 4, 4]. -> Linearized whose fields carry a
    leading [B] axis, with H_ss, b_s, error and num_inliers set and zero
    target blocks. CUDA tensors go to the kernel (one launch pair for all B),
    CPU tensors to the plain version."""
    if p_src.device.type == "cpu":
        _check_unary_batch(p_src, momT_b, found_b, deltas, src_covs6, contiguous=False)
        return linearize_vgicp_unary_batch_plain(p_src, momT_b, found_b, deltas, min_voxel_points, eps, src_covs6)
    return linearize_vgicp_unary_batch_cuda(p_src, momT_b, found_b, deltas, min_voxel_points, eps, src_covs6)


# ---------------------------------------------------------------------------
# K4: full 12x12 VGICP linearize from raw voxel moments
# ---------------------------------------------------------------------------


def _moments_library():
    """K4's launcher, csrc/vgicp_moments.cu."""
    lib = _build.load("vgicp_moments")
    fn = lib.gpt_vgicp_moments
    if fn.argtypes is None:  # first use in this process
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_float]
            + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        if lib.gpt_vgicp_moments_out_len() != _OUT or lib.gpt_vgicp_moments_threads() != _UNARY_THREADS:
            raise RuntimeError("csrc/vgicp_moments.cu does not match its wrapper")
    return fn


def linearize_vgicp_moments_cuda(
    p_src, momT, found, delta, min_voxel_points, eps=1e-3, src_covs6=None
) -> Linearized:
    """Launch the Hopper kernel. Inputs: p_src [3, N], momT [10, N], found
    [N] bool, delta [4, 4], src_covs6 [6, N] or None, all f32 (but found) and
    contiguous on one CUDA device."""
    global moments_launches
    dev = p_src.device
    if dev.type != "cuda":
        raise ValueError(f"linearize_vgicp_moments_cuda needs CUDA tensors, got {dev}")
    n = p_src.shape[-1]
    _check("p_src", p_src, (3, n), torch.float32, dev)
    _check("momT", momT, (10, n), torch.float32, dev)
    _check("found", found, (n,), torch.bool, dev)
    _check("delta", delta, (4, 4), torch.float32, dev)
    if src_covs6 is not None:
        _check("src_covs6", src_covs6, (6, n), torch.float32, dev)
    fn = _moments_library()
    blocks = unary_num_blocks(n)  # K1's grid: one point a thread
    partial = torch.empty((blocks, _OUT), dtype=torch.float32, device=dev)
    out = torch.empty((_OUT,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            p_src.data_ptr(), momT.data_ptr(), found.data_ptr(),
            None if src_covs6 is None else src_covs6.data_ptr(),
            delta.data_ptr(), float(min_voxel_points), float(eps),
            partial.data_ptr(), out.data_ptr(), n, blocks, stream,
        )
    if err != 0:
        raise RuntimeError(f"vgicp_moments kernel launch failed with CUDA error {err}")
    moments_launches += 1
    return _unpack(out)


def linearize_vgicp_moments_plain(
    p_src, momT, found, delta, min_voxel_points, eps=1e-3, src_covs6=None
) -> Linearized:
    """The same function in plain PyTorch, on any device: the reference's
    XLA twin `linearize_vgicp_moments_xla`. The fused covariance is
    C_t + R C_s Rᵀ in the target frame, or C_t + eps I."""
    ok = found & (momT[0] >= min_voxel_points)
    mu, C6 = _voxel_stats(momT)
    if src_covs6 is not None:
        fused = C6 + planar.sym_rotate(delta[:3, :3], src_covs6)
    else:
        eye6 = torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 1.0], dtype=C6.dtype, device=C6.device) * eps
        fused = C6 + eye6[:, None]
    W6 = planar.sym_inv(fused)
    pm = planar.transform(delta, p_src)
    return planar.linearize_point_system(p_src, pm, pm - mu, W6, ok, delta[:3, :3])


def linearize_vgicp_moments(
    p_src, momT, found, delta, min_voxel_points, eps=1e-3, src_covs6=None
) -> Linearized:
    """Fused VGICP linearize from raw moment rows.

    p_src [3, N], momT [10, N] (count, sum p, sum ppᵀ upper of each point's
    voxel), found [N] bool, delta [4, 4], src_covs6 [6, N] or None (then
    eps-regularized point-to-distribution). -> the full Linearized (target
    and source blocks). CUDA tensors go to the kernel, CPU tensors to the
    plain version."""
    if p_src.device.type == "cpu":
        return linearize_vgicp_moments_plain(p_src, momT, found, delta, min_voxel_points, eps, src_covs6)
    return linearize_vgicp_moments_cuda(p_src, momT, found, delta, min_voxel_points, eps, src_covs6)


def vgicp_scan_linearize(
    vmap: GaussianVoxelMap, p_src, mask, delta, min_voxel_points, eps=1e-3, src_covs6=None
) -> Linearized:
    """One-call scan-to-map VGICP linearize: transform, hash probe and the
    matched record's raw moments (`probe_moments`), then K4. p_src [3, N]
    and src_covs6 [6, N] contiguous on CUDA (the kernel refuses a strided
    view), mask [N] bool, delta [4, 4]; runs where the tensors lie."""
    momT, found = probe_moments(vmap, p_src, mask, delta)
    return linearize_vgicp_moments(p_src, momT, found, delta, min_voxel_points, eps, src_covs6)
