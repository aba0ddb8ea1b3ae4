"""Source-side voxel clustering: registration and map inserts on the cells of
a scan instead of its points.

Port of gtsam_points_tpu/registration/cluster.py. A scan is clustered once
by a voxel grid (pose-independent, so it belongs to preprocessing): each
occupied cell becomes one record

  cluster = (centroid, covariance = intra-cell scatter + mean member
             covariance, weight = point count)

and the unary VGICP linearize consumes clusters as it consumes points, the
weight scaling each record's contribution (every sum is linear in it). A
25k-point LiDAR scan occupies a few thousand leaf-1.0 cells, so each probe
and each linearize reads that many records instead of 25k points.

Within a cluster the first-moment (b-vector) terms are exact for the
translation block, and exact for the rotation block when all members share
the target voxel; the H terms use the centroid's outer product in place of
E[ppᵀ], a Gauss-Newton scaling rather than a shift of the fixed point.

As in the point pyramid (registration/pyramid.py), there is no `use_pallas`
and no batched API: every Gauss-Newton iteration runs
`linearize_vgicp_unary` with the weights and the cluster covariances (K1's
Hopper kernel on CUDA tensors, its plain version on CPU tensors), and
callers loop over initial poses.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from gtsam_points_tpu_torch._device import DeviceLike, check_on, resolve_device
from gtsam_points_tpu_torch.ops import fused_linearize, planar
from gtsam_points_tpu_torch.ops import voxel_keys as vk
from gtsam_points_tpu_torch.ops.voxelmap import _MOM_LANES, GaussianVoxelMap, _scan_moments, insert_rows_incremental
from gtsam_points_tpu_torch.registration.pyramid import PyramidStage, StageSpec, _norm_stages
from gtsam_points_tpu_torch.types.frame import Frame
from gtsam_points_tpu_torch.utils import se3
from gtsam_points_tpu_torch.utils.solve6 import solve6


class SourceClusters(NamedTuple):
    """Per-voxel aggregation of a source scan, planar (lane axis = C).

    pts_p:  [3, C] cluster centroids (source frame)
    covs6:  [6, C] cluster covariance (xx, xy, xz, yy, yz, zz): intra-cell
            scatter + mean member covariance
    weight: [C] f32 member count (0 on padding slots)
    mask:   [C] bool valid-cluster flag (valid slots come first: keys sort
            ascending and INVALID_KEY is the largest)
    """

    pts_p: torch.Tensor
    covs6: torch.Tensor
    weight: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.mask.shape[0]

    def strided(self, stride: int) -> "SourceClusters":
        """Fixed-stride subset, each field contiguous (the kernels take only
        contiguous planes). Clusters are key-sorted, so a stride walks the
        space roughly uniformly, as the point pyramid's stride does."""
        if stride <= 1:
            return self
        return SourceClusters(
            pts_p=self.pts_p[:, ::stride].contiguous(),
            covs6=self.covs6[:, ::stride].contiguous(),
            weight=self.weight[::stride].contiguous(),
            mask=self.mask[::stride].contiguous(),
        )


# The reference's schedules: basin capture on every fourth cluster at leaf
# 4 (three iterations), then refinement at stride 2 and 1 at leaf 1.
DEFAULT_CLUSTER_STAGES = (
    PyramidStage(4.0, 3, stride=4),
    PyramidStage(1.0, 2, stride=2),
    PyramidStage(1.0, 2, stride=1),
)

# One more fine iteration on the full cluster set.
QUALITY_CLUSTER_STAGES = (
    PyramidStage(4.0, 3, stride=4),
    PyramidStage(1.0, 2, stride=2),
    PyramidStage(1.0, 3, stride=1),
)

DEFAULT_CLUSTER_LEAF = 1.0
DEFAULT_CLUSTER_CAPACITY = 5632


def cluster_source(source: Frame, leaf: float, capacity: int, device: DeviceLike = None) -> SourceClusters:
    """Aggregate `source` into per-voxel clusters at `leaf`, on `device`
    (default `cuda`; the frame must lie there). The cells are summed as the
    map build sums them (`ops/voxelmap._scan_moments`: one sort, then each
    cell's rows in order), so two builds on the card agree bit for bit.
    Cells beyond `capacity` (the highest packed keys) are dropped.

    The covariances are the exact raw cluster moments, with no
    regularization, so `insert_clusters_incremental` reproduces the
    per-point map; `register_clusters_pyramid` and `VGICPClustersFactor` add
    their own eps (a one-point cluster of a frame without covariances has a
    zero covariance)."""
    dev = resolve_device(device)
    check_on(dev, source.points)
    keys, mom = _scan_moments(source, torch.tensor(leaf, dtype=torch.float32, device=dev), capacity)
    mask = keys != vk.INVALID_KEY
    cnt = mom[:, 0]
    safe = torch.clamp(cnt, min=1.0)
    mu = mom[:, 1:4] / safe[:, None]  # [C, 3]
    s6 = mom[:, 4:10] / safe[:, None]
    cov6 = torch.stack(
        [
            s6[:, 0] - mu[:, 0] * mu[:, 0],
            s6[:, 1] - mu[:, 0] * mu[:, 1],
            s6[:, 2] - mu[:, 0] * mu[:, 2],
            s6[:, 3] - mu[:, 1] * mu[:, 1],
            s6[:, 4] - mu[:, 1] * mu[:, 2],
            s6[:, 5] - mu[:, 2] * mu[:, 2],
        ]
    )  # [6, C]
    return SourceClusters(
        pts_p=torch.where(mask, mu.T, 0.0).contiguous(),
        covs6=torch.where(mask, cov6, 0.0).contiguous(),
        weight=torch.where(mask, cnt, 0.0).contiguous(),
        mask=mask,
    )


def insert_clusters_incremental(vmap: GaussianVoxelMap, clusters: SourceClusters, T: torch.Tensor):
    """Incremental map insert from clustered scan moments: each cluster's
    raw moments move to the world frame exactly under T (the parallel-axis
    identity s1' = n mu_w, S2' = n (R C Rᵀ + mu_w mu_wᵀ)) and merge through
    `insert_rows_incremental`, which sorts the clusters' keys instead of the
    scan's points. Clusters carry no intensity: a map fed only this way has
    zero per-voxel intensity.

    -> (new_vmap, overflow), the contract of `insert_frame_incremental`."""
    mu_w = planar.transform(T, clusters.pts_p)  # [3, C]
    n = torch.where(clusters.mask, clusters.weight, 0.0)  # [C]
    cw6 = planar.sym_rotate(T[:3, :3], clusters.covs6)  # [6, C]
    m0, m1, m2 = mu_w[0], mu_w[1], mu_w[2]
    s2 = torch.stack(
        [
            cw6[0] + m0 * m0, cw6[1] + m0 * m1, cw6[2] + m0 * m2,
            cw6[3] + m1 * m1, cw6[4] + m1 * m2, cw6[5] + m2 * m2,
        ]
    )  # [6, C]
    C = clusters.capacity
    rows = torch.cat(
        [n[:, None], (n * mu_w).T, (n * s2).T, n.new_zeros((C, _MOM_LANES - 10))], dim=1
    )
    keys = vk.point_keys_planar(mu_w, clusters.mask, vmap.leaf)
    return insert_rows_incremental(vmap, keys, rows, C)


def register_clusters_pyramid(
    maps: Sequence[GaussianVoxelMap],
    clusters: SourceClusters,
    T0: torch.Tensor,
    stages: Sequence[StageSpec] = DEFAULT_CLUSTER_STAGES,
    min_voxel_points: float = 1.0,
    damping: float = 1e-6,
    eps: float = 1e-3,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Coarse-to-fine Gauss-Newton registration of source clusters against
    the map pyramid: `register_scan_pyramid` with clusters for points
    (`stride` strides clusters). `eps` regularizes the cluster covariance
    diagonal. Every iteration runs `linearize_vgicp_unary` with the weights
    and the covariances: K1 on CUDA tensors, its plain version only on CPU
    tensors. Nothing is read to the host. For several initial poses, call
    once per pose. Runs on `device` (default `cuda`), where the maps, the
    clusters and T0 must lie. -> refined T [4, 4]."""
    dev = resolve_device(device)
    check_on(dev, clusters.pts_p, T0, *(vm.table for vm in maps))
    stages = _norm_stages(stages)
    clusters = clusters._replace(covs6=planar.sym_add_eye(clusters.covs6, eps))
    damp = damping * torch.eye(6, dtype=torch.float32, device=clusters.pts_p.device)
    T = T0.to(torch.float32).contiguous()
    for vm, st in zip(maps, stages):
        cl = clusters.strided(st.stride)
        refresh = st.refresh if st.refresh > 0 else st.iters
        base_iters, extra_rounds = divmod(st.iters, refresh)
        for r in range(refresh):
            momT, found = fused_linearize.probe_moments(vm, cl.pts_p, cl.mask, T)
            for _ in range(base_iters + (1 if r < extra_rounds else 0)):
                lin = fused_linearize.linearize_vgicp_unary(
                    cl.pts_p, momT, found, T, min_voxel_points, src_covs6=cl.covs6, weights=cl.weight
                )
                xi = solve6(lin.H_ss + damp, lin.b_s)
                T = T @ se3.se3_exp(xi)
    return T
