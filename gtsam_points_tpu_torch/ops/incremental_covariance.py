"""Incremental covariance map: a point map whose normals and covariances are
re-estimated at every insert, with eigenvalue-based validity gating.

Port of gtsam_points_tpu/ops/incremental_covariance.py. A fixed-capacity
point buffer is written as a ring; each insert rebuilds the hash grid over
all resident points, searches their k nearest neighbours and re-estimates
every covariance. A point is valid when its two log10 eigenvalue ratios lie
within `ratio_sigma` standard deviations of their running statistics
(utils/stats.RunningStatistics), which gain one sample, the batch mean,
per insert; during the first `warmup` inserts every point with enough
neighbours is valid. `knn_search_valid` searches the valid points only,
`knn_search_force` all resident points.

The ring write writes `frame.capacity` slots from the cursor but advances the
cursor by the frame's valid points, as the reference does. A frame larger
than the map would write some slots twice, in an order neither the
reference's scatter nor CUDA's defines; `insert` refuses it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gtsam_points_tpu_torch._device import DeviceLike, check_on, resolve_device
from gtsam_points_tpu_torch.ops.eigh3 import eigh3
from gtsam_points_tpu_torch.ops.features import neighbor_covariances
from gtsam_points_tpu_torch.ops.hash_grid import build_hash_grid, knn_search
from gtsam_points_tpu_torch.types.frame import Frame
from gtsam_points_tpu_torch.utils.stats import RunningStatistics


class IncrementalCovarianceMap(NamedTuple):
    """points [C, 3], mask [C], normals [C, 3], covs [C, 3, 3], valid [C]
    (passes the gating), birth [C] int32 (the insert that wrote the slot),
    epoch () int32, eig_stats (over the two log eigenvalue ratios [2]) and
    cursor () int32, the next ring position."""

    points: torch.Tensor
    mask: torch.Tensor
    normals: torch.Tensor
    covs: torch.Tensor
    valid: torch.Tensor
    birth: torch.Tensor
    epoch: torch.Tensor
    eig_stats: RunningStatistics
    cursor: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def as_frame(self) -> Frame:
        """The valid points with their normals and covariances."""
        return Frame(points=self.points, mask=self.mask & self.valid, normals=self.normals, covs=self.covs)


def empty_incremental_covariance_map(capacity: int, *, device: DeviceLike = None) -> IncrementalCovarianceMap:
    dev = resolve_device(device)
    return IncrementalCovarianceMap(
        points=torch.zeros((capacity, 3), dtype=torch.float32, device=dev),
        mask=torch.zeros((capacity,), dtype=torch.bool, device=dev),
        normals=torch.zeros((capacity, 3), dtype=torch.float32, device=dev),
        covs=torch.zeros((capacity, 3, 3), dtype=torch.float32, device=dev),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=dev),
        birth=torch.zeros((capacity,), dtype=torch.int32, device=dev),
        epoch=torch.zeros((), dtype=torch.int32, device=dev),
        eig_stats=RunningStatistics.empty((2,), device=dev),
        cursor=torch.zeros((), dtype=torch.int32, device=dev),
    )


def insert(
    cmap: IncrementalCovarianceMap,
    frame: Frame,
    k: int = 10,
    grid_leaf: float = 1.0,
    ratio_sigma: float = 3.0,
    warmup: int = 256,
) -> IncrementalCovarianceMap:
    """Write the frame into the ring (over the oldest slots) and re-estimate
    the covariances and validity of the whole buffer. Runs on the map's
    device; the frame must lie there too and hold at most `capacity` slots."""
    check_on(cmap.points.device, frame.points)
    cap = cmap.capacity
    n = frame.capacity
    if n > cap:
        raise ValueError(f"a frame of {n} slots does not fit a map of {cap}: the ring write would repeat slots")
    epoch = cmap.epoch + 1

    pos = ((cmap.cursor + torch.arange(n, dtype=torch.int32, device=cmap.points.device)) % cap).long()
    write = frame.mask
    points, mask, birth = cmap.points.clone(), cmap.mask.clone(), cmap.birth.clone()
    points[pos] = torch.where(write[:, None], frame.points, cmap.points[pos])
    mask[pos] = write | cmap.mask[pos]
    birth[pos] = torch.where(write, epoch, cmap.birth[pos])
    cursor = (cmap.cursor + frame.num_valid().to(torch.int32)) % cap

    grid = build_hash_grid(points, mask, grid_leaf)
    nn_idx, _, nn_valid = knn_search(grid, points, mask, k)
    raw_cov, _ = neighbor_covariances(points, nn_idx, nn_valid)
    eigvals, eigvecs = eigh3(raw_cov)

    e = torch.clamp(eigvals, min=1e-12)
    ratios = torch.stack([torch.log10(e[:, 1] / e[:, 0]), torch.log10(e[:, 2] / e[:, 1])], dim=-1)  # [C, 2]
    enough = torch.sum(nn_valid.to(torch.int32), dim=-1) >= 5
    stats = cmap.eig_stats
    in_warmup = stats.count < warmup
    mean, std = stats.mean(), torch.clamp(stats.std(), min=1e-3)
    within = torch.all(torch.abs(ratios - mean) <= ratio_sigma * std, dim=-1)
    valid = mask & enough & (in_warmup | within)

    batch_w = (mask & enough).to(torch.float32)
    batch_n = torch.clamp(torch.sum(batch_w), min=1.0)
    batch_mean = torch.sum(ratios * batch_w[:, None], dim=0) / batch_n

    return IncrementalCovarianceMap(
        points=points,
        mask=mask,
        normals=eigvecs[..., 0],
        covs=raw_cov,
        valid=valid,
        birth=birth,
        epoch=epoch,
        eig_stats=stats.add(batch_mean),
        cursor=cursor,
    )


def knn_search_valid(cmap: IncrementalCovarianceMap, queries: torch.Tensor, query_mask: torch.Tensor, k: int,
                     **kwargs):
    """kNN over the valid points only (`grid_leaf` picks the grid's leaf,
    default 1.0; the rest goes to knn_search)."""
    grid = build_hash_grid(cmap.points, cmap.mask & cmap.valid, kwargs.pop("grid_leaf", 1.0))
    return knn_search(grid, queries, query_mask, k, **kwargs)


def knn_search_force(cmap: IncrementalCovarianceMap, queries: torch.Tensor, query_mask: torch.Tensor, k: int,
                     **kwargs):
    """kNN over all resident points, valid or not."""
    grid = build_hash_grid(cmap.points, cmap.mask, kwargs.pop("grid_leaf", 1.0))
    return knn_search(grid, queries, query_mask, k, **kwargs)
