"""Distributed graph optimization: a factor set split over the ranks.

Port of gtsam_points_tpu/parallel/distributed.py:
- the factor axis: each rank owns F/W factors of a `VGICPFactorBatch`
  (`shard_factor_batch`), linearizes them (K3, one launch a factor) into a
  system of its own, and one all-reduce of (A, b, error) sums the ranks'
  systems; the frozen error of the LM's candidates is one all-reduce too;
- the poses, the dense system (A [6P, 6P], b) and the solve and retract are
  replicated: every rank runs the same LM on the same reduced values, so
  every decision (accept, lambda, stop) is taken alike on every rank and
  the poses are equal bit for bit on all of them. Only the 6x6 blocks of
  the poses cross between the ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from gtsam_points_tpu_torch._device import check_on, resolve_device
from gtsam_points_tpu_torch.factors.batch import VGICPFactorBatch
from gtsam_points_tpu_torch.ops.voxelmap import GaussianVoxelMap
from gtsam_points_tpu_torch.optim.graph import FactorGraph
from gtsam_points_tpu_torch.optim.lm import LMParams, LMResult, optimize_lm
from gtsam_points_tpu_torch.parallel.sharding import Axis, Mesh, all_reduce_sum
from gtsam_points_tpu_torch.types.frame import _map_attrs


@dataclasses.dataclass(frozen=True)
class ShardedFactorBatch:
    """This rank's slice `local` of a VGICPFactorBatch split along a mesh
    axis. The graph adds it through `add_to_system`, as it adds the whole
    set; every rank must run the same graph, since each linearization and
    each error is a collective."""

    local: VGICPFactorBatch
    mesh: Mesh
    axis: Axis

    @property
    def keys(self):
        return ()

    def add_to_system(self, A: torch.Tensor, b: torch.Tensor, poses: torch.Tensor):
        """This rank's factors' blocks, summed over the ranks in one
        all-reduce of (A, b, error), added to (A [P, P, 6, 6], b [P, 6])
        -> (A, b, error, frozen_error_fn)."""
        group = self.mesh.group(self.axis)
        A_l, b_l, err_l, local_error = self.local.add_to_system(torch.zeros_like(A), torch.zeros_like(b), poses)
        payload = all_reduce_sum(torch.cat([A_l.reshape(-1), b_l.reshape(-1), err_l.reshape(1)]), group)
        na, nb = A.numel(), b.numel()

        def frozen_error(new_poses):
            err = torch.as_tensor(local_error(new_poses), dtype=poses.dtype, device=poses.device)
            return all_reduce_sum(err.reshape(-1).clone(), group).reshape(err.shape)

        return A + payload[:na].reshape(A.shape), b + payload[na:na + nb].reshape(b.shape), payload[-1], frozen_error

    def error(self, poses: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(self.local.error(poses).reshape(1), self.mesh.group(self.axis))[0]


def shard_factor_batch(batch: VGICPFactorBatch, mesh: Mesh, axis: str = "factor") -> ShardedFactorBatch:
    """Keep this rank's F/W factors of the set (the rank at position i on
    the axis keeps factors i x F/W .. (i+1) x F/W - 1), on its device. The
    factor count must divide evenly over the axis."""
    f, w = batch.num_factors(), mesh.size(axis)
    if f % w:
        raise ValueError(f"{f} factors do not divide over {w} ranks on {axis!r}")
    k = f // w
    i = mesh.index(axis)

    def mine(x):
        return x[i * k:(i + 1) * k].to(mesh.device)

    local = VGICPFactorBatch(
        voxelmaps=GaussianVoxelMap(*(mine(x) for x in batch.voxelmaps)),
        sources=_map_attrs(batch.sources, mine),
        target_keys=mine(batch.target_keys),
        source_keys=mine(batch.source_keys),
        min_voxel_points=batch.min_voxel_points,
    )
    return ShardedFactorBatch(local=local, mesh=mesh, axis=axis)


def optimize_lm_sharded(graph: FactorGraph, poses: torch.Tensor, mesh: Mesh,
                        params: Optional[LMParams] = None) -> LMResult:
    """LM with the pose state replicated on every rank of the mesh; the
    factor work splits wherever the graph's factors were split
    (`shard_factor_batch`, or a map-sharded factor). The poses must lie on
    the mesh's device (a `cuda` mesh raises when CUDA is absent)."""
    check_on(resolve_device(mesh.device), poses)
    return optimize_lm(graph, poses, params)
