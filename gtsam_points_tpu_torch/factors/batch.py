"""A set of F VGICP factors with stacked inputs, added to the system at once.

Port of gtsam_points_tpu/factors/batch.py (the reference's counterpart of
NonlinearFactorSetGPU). The inputs stay stacked as in the reference: every
field of the voxel maps and of the source frames has a leading [F] axis, and
the keys are [F] int32 tensors (target key < 0: the identity target, fixed).
The reference vmaps one linearization over the F factors; here the set is F
`VGICPFactor`s on the slices of the stacked inputs, and each computes its
correspondences and runs K3 (`fused_linearize.linearize_fused`: the kernel
on CUDA tensors, its plain version, the reference's
`planar.linearize_point_system`, on CPU tensors), one launch a factor. The
blocks go into A [P, P, 6, 6] and b [P, 6] as the reference's scatter-adds
put them (a target key < 0 adds no target block, duplicate keys
accumulate), factor by factor in a fixed order on every device (`index_add_`
on CUDA would add in no fixed order), so A and b equal those of the same
factors added one by one. The frozen error scores candidate poses
[..., P, 4, 4] on the correspondences of the linearization point (the
reference recomputes them at the old poses: the same values).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from gtsam_points_tpu_torch.factors.linearized import add_blocks
from gtsam_points_tpu_torch.factors.vgicp import VGICPFactor
from gtsam_points_tpu_torch.ops.voxelmap import GaussianVoxelMap
from gtsam_points_tpu_torch.types.frame import Frame


@dataclasses.dataclass(frozen=True)
class VGICPFactorBatch:
    """voxelmaps: a GaussianVoxelMap with a leading [F] axis on every field;
    sources: a Frame with a leading [F] axis; target_keys, source_keys: [F]
    int32 pose indices."""

    voxelmaps: GaussianVoxelMap
    sources: Frame
    target_keys: torch.Tensor
    source_keys: torch.Tensor
    min_voxel_points: float

    @property
    def keys(self):
        # the keys are tensors: the graph adds the set through add_to_system
        return ()

    def num_factors(self) -> int:
        return self.sources.points.shape[0]

    @functools.cached_property
    def _factors(self):
        """One VGICPFactor a member on its slice of the stacked inputs (one
        read of the keys)."""
        eye = torch.eye(4, dtype=self.sources.points.dtype, device=self.sources.points.device)
        out = []
        for f, (t, s) in enumerate(zip(self.target_keys.tolist(), self.source_keys.tolist())):
            src = Frame(**{k.name: None if getattr(self.sources, k.name) is None else getattr(self.sources, k.name)[f]
                           for k in dataclasses.fields(Frame)})
            out.append(VGICPFactor(voxelmap=GaussianVoxelMap(*(x[f] for x in self.voxelmaps)), source=src,
                                   fixed_target_pose=eye, target_key=t, source_key=s,
                                   min_voxel_points=self.min_voxel_points))
        return out

    def add_to_system(self, A: torch.Tensor, b: torch.Tensor, poses: torch.Tensor):
        """Add every factor's blocks to (A [P, P, 6, 6], b [P, 6]) at poses
        [P, 4, 4] -> (A, b, error, frozen_error_fn)."""
        A, b = A.clone(), b.clone()
        err, err_fns = A.new_zeros(()), []
        for factor in self._factors:
            lin, efn = factor.linearize_corr(poses, factor.correspondences(poses))
            err = err + add_blocks(A, b, factor.keys, lin)
            err_fns.append(efn)

        def frozen_error(new_poses):
            total = 0.0
            for efn in err_fns:
                total = total + efn(new_poses)
            return total

        return A, b, err, frozen_error

    def error(self, poses: torch.Tensor) -> torch.Tensor:
        """The set's error at poses [P, 4, 4], correspondences searched there."""
        total = poses.new_zeros(())
        for factor in self._factors:
            total = total + factor.error(poses)
        return total


def make_vgicp_factor_batch(voxelmaps_list, sources_list, target_keys, source_keys,
                            min_voxel_points: float = 5.0) -> VGICPFactorBatch:
    """Stack per-factor voxel maps and sources (all of one capacity, on one
    device) into a set."""
    dev = sources_list[0].device
    stacked_vm = GaussianVoxelMap(*(torch.stack(xs) for xs in zip(*voxelmaps_list)))
    stacked_src = Frame(**{
        k.name: None if getattr(sources_list[0], k.name) is None
        else torch.stack([getattr(s, k.name) for s in sources_list])
        for k in dataclasses.fields(Frame)
    })
    return VGICPFactorBatch(
        voxelmaps=stacked_vm,
        sources=stacked_src,
        target_keys=torch.as_tensor(target_keys, dtype=torch.int32, device=dev),
        source_keys=torch.as_tensor(source_keys, dtype=torch.int32, device=dev),
        min_voxel_points=min_voxel_points,
    )
