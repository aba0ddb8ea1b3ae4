"""Downsampling and outlier removal.

Port of gtsam_points_tpu/ops/downsample.py: `voxelgrid_sampling` (one sort
by packed voxel key, then per-voxel means), `random_sampling`,
`randomgrid_sampling` and `remove_outliers`; fixed output capacities.

The reference's scatter-adds (`.at[].add`) become sorted-run sums
(`voxelmap._run_sum`): each voxel sums its points in the sorted order from
its first to its last, on every device, so the card's result equals the
CPU's bit for bit (`index_add_` on CUDA adds in no fixed order). The random
samplers draw from an explicit `torch.Generator`; each splits into the
public function that draws and a function that takes the draws
(`*_from_scores`, `*_from_permutation`), which the tests feed the
reference's own draws.
"""

from __future__ import annotations

from typing import Optional

import torch

from gtsam_points_tpu_torch.ops import voxel_keys as vk
from gtsam_points_tpu_torch.ops.voxelmap import _is_new_run, _run_sum
from gtsam_points_tpu_torch.types.frame import Frame

_FIELDS = ("points", "normals", "covs", "intensities", "times")


def _sorted_runs(keys: torch.Tensor, order: torch.Tensor):
    """Keys sorted by `order` -> (valid [N], is_new [N], seg [N]): run
    starts among valid keys and each key's run index."""
    skeys = keys[order]
    valid = skeys != vk.INVALID_KEY
    is_new = _is_new_run(skeys)
    return valid, is_new, torch.cumsum(is_new.to(torch.int64), dim=0) - 1


def voxelgrid_sampling(frame: Frame, leaf: float, capacity: Optional[int] = None) -> Frame:
    """The mean of the points (and attributes) of each voxel. The output
    capacity defaults to the input's; voxels past it (in key order) are
    dropped."""
    n = frame.capacity
    cap = capacity if capacity is not None else n
    keys = vk.point_keys(frame.points, frame.mask, leaf)
    order = torch.argsort(keys, stable=True)
    valid, _, seg = _sorted_runs(keys, order)
    slot = torch.where(valid, torch.clamp(seg, max=cap), cap)  # sorted: invalid keys sort last
    offsets = torch.searchsorted(slot, torch.arange(cap + 1, dtype=slot.dtype, device=slot.device))
    counts = offsets[1:] - offsets[:-1]
    denom = torch.clamp(counts, min=1).to(torch.float32)

    def mean(arr):
        if arr is None:
            return None
        summed = _run_sum(arr[order].reshape(n, -1), slot, cap)
        return (summed / denom[:, None]).reshape((cap,) + arr.shape[1:])

    out = {k: mean(getattr(frame, k)) for k in _FIELDS}
    if out["normals"] is not None:
        norm = torch.linalg.norm(out["normals"], dim=-1, keepdim=True)
        out["normals"] = out["normals"] / torch.clamp(norm, min=1e-12)
    mask = counts > 0
    out["points"] = torch.where(mask[:, None], out["points"], out["points"][:1])
    return Frame(mask=mask, **out)


def random_sampling_from_scores(frame: Frame, num_samples: int, scores: torch.Tensor) -> Frame:
    """The `num_samples` valid points of lowest score [N] (invalid points last)."""
    scores = torch.where(frame.mask, scores, 2.0)
    order = torch.argsort(scores, stable=True)[:num_samples]
    return Frame(mask=frame.mask[order],
                 **{k: None if getattr(frame, k) is None else getattr(frame, k)[order] for k in _FIELDS})


def random_sampling(frame: Frame, num_samples: int, generator: Optional[torch.Generator] = None) -> Frame:
    """Uniform sampling without replacement among the valid points."""
    scores = torch.rand((frame.capacity,), generator=generator, device=frame.device)
    return random_sampling_from_scores(frame, num_samples, scores)


def randomgrid_sampling_from_permutation(frame: Frame, leaf: float, sampling_rate: float, perm: torch.Tensor,
                                         capacity: Optional[int] = None) -> Frame:
    """Voxel-stratified sampling: keep about `sampling_rate` of the points,
    at most an equal budget a voxel, the points of a voxel taken in the
    order of the permutation `perm` [N]; kept points compacted to the front."""
    n = frame.capacity
    cap = capacity if capacity is not None else n
    target = torch.round(sampling_rate * frame.mask.sum().to(torch.float32)).to(torch.int64)
    keys = vk.point_keys(frame.points, frame.mask, leaf)
    order = perm[torch.argsort(keys[perm], stable=True)]
    valid, is_new, seg = _sorted_runs(keys, order)
    arange = torch.arange(n, dtype=torch.int64, device=keys.device)
    seg_start = torch.zeros((n + 1,), dtype=torch.int64, device=keys.device)
    seg_start[torch.where(is_new, seg, n)] = arange
    rank = arange - seg_start[torch.clamp(seg, min=0)]
    num_cells = torch.clamp(seg[-1] + 1, min=1)
    budget = torch.clamp(torch.div(target, num_cells, rounding_mode="floor"), min=1)
    keep = valid & (rank < budget)
    dest = torch.cumsum(keep.to(torch.int64), dim=0) - 1
    dest = torch.where(keep & (dest < cap), dest, cap)

    def compact(arr):
        if arr is None:
            return None
        out = arr.new_zeros((cap + 1,) + arr.shape[1:])
        out[dest] = arr[order]
        return out[:cap]

    kept = torch.zeros((cap + 1,), dtype=torch.bool, device=keys.device)
    kept[dest] = keep
    return Frame(mask=kept[:cap], **{k: compact(getattr(frame, k)) for k in _FIELDS})


def randomgrid_sampling(frame: Frame, leaf: float, sampling_rate: float, generator: Optional[torch.Generator] = None,
                        capacity: Optional[int] = None) -> Frame:
    """`randomgrid_sampling_from_permutation` with a uniform random permutation."""
    perm = torch.randperm(frame.capacity, generator=generator, device=frame.device)
    return randomgrid_sampling_from_permutation(frame, leaf, sampling_rate, perm, capacity)


def remove_outliers(
    frame: Frame,
    k: int = 10,
    std_thresh: float = 1.0,
    num_neighbor_cells: int = 27,
    grid_leaf: Optional[float] = None,
) -> Frame:
    """Statistical outlier removal: a point is an outlier when its mean kNN
    distance exceeds the cloud's mean + std_thresh x its deviation, or when
    it has no neighbour within the grid's reach. Outliers leave the mask;
    nothing moves."""
    from gtsam_points_tpu_torch.ops.hash_grid import build_hash_grid, knn_search

    mask = frame.mask
    if grid_leaf is None:
        # the spacing scale from the bounding box's volume (one host read)
        m = mask[:, None]
        lo = torch.amin(torch.where(m, frame.points, float("inf")), dim=0)
        hi = torch.amax(torch.where(m, frame.points, float("-inf")), dim=0)
        vol = torch.prod(torch.clamp(hi - lo, min=1e-3))
        grid_leaf = float(torch.pow(vol / torch.clamp(mask.sum(), min=1), 1.0 / 3.0) * 4.0)
    grid = build_hash_grid(frame.points, mask, grid_leaf)
    _, sq, valid = knn_search(grid, frame.points, mask, k + 1, num_neighbor_cells)
    d = torch.sqrt(torch.where(valid, sq, 0.0))
    n_nb = torch.sum(valid[:, 1:], dim=1)
    mean_d = torch.sum(d[:, 1:], dim=1) / torch.clamp(n_nb, min=1)
    ok = mask & (n_nb > 0)  # a point with no neighbour in reach is an outlier, outside the statistics
    n_ok = torch.clamp(torch.sum(ok), min=1)
    mu = torch.sum(torch.where(ok, mean_d, 0.0)) / n_ok
    var = torch.sum(torch.where(ok, (mean_d - mu) ** 2, 0.0)) / n_ok
    return frame.replace(mask=ok & (mean_d <= mu + std_thresh * torch.sqrt(var)))
