"""A Gaussian voxel map sharded by hashed voxel key, and its VGICP factor.

Port of gtsam_points_tpu/parallel/sharded_voxelmap.py. Every voxel cell has
one owner, `shard_of_keys` of its key (a murmur mix modulo the shard count),
so a map of S shards holds S times the cells of one, and insert and lookup
need no directory of owners:

- a sharded map here is a `GaussianVoxelMap` with a leading [S] axis on
  every field, all shards on one device (`build_sharded_voxelmap`), or, once
  `place_sharded` put it on a mesh, a `ShardedVoxelMap`: this rank's shard
  alone on this rank's device, the counterpart of JAX's array whose shards
  lie on the devices of the mesh. `sharded_insert_frame`,
  `sharded_num_voxels` and `sharded_overlap` take either and give the same
  answer; on a placed map the last two sum over the ranks. The linearize
  and the factor take a placed map only.
- INSERT: one stable sort partitions the scan by owner
  (`partition_frame_by_shard`); each shard merges only its own slice. A
  placed map inserts its own slice and sends nothing.
- LINEARIZE (VGICP): each rank probes its own shard with every source
  point; a point's voxel lies on one shard, so the hits split across ranks.
  Each rank forms its partial 12x12 system with K3
  (`fused_linearize.linearize_fused`: the kernel on CUDA tensors, its plain
  version, the reference's `planar.linearize_point_system`, on CPU tensors),
  and ONE all-reduce of the 488-byte `Linearized` payload gives every rank
  the replicated map's system, whatever the size of the scan or the map.

A JAX `shard_map` body takes shard 0 of each device's block, which is right
only with one shard a device: `_check_shard_axis` keeps that rule here,
where each rank takes the shard at its own position on the mesh axis.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Union

import torch

from gtsam_points_tpu_torch._device import DeviceLike, check_on, resolve_device
from gtsam_points_tpu_torch.factors.base import relative_pose
from gtsam_points_tpu_torch.factors.linearized import Linearized
from gtsam_points_tpu_torch.ops import fused_linearize, planar
from gtsam_points_tpu_torch.ops import voxel_keys as vk
from gtsam_points_tpu_torch.ops.voxelmap import (
    GaussianVoxelMap,
    build_voxelmap,
    insert_frame,
    lookup_fetch_planar,
    lookup_voxels,
)
from gtsam_points_tpu_torch.parallel.sharding import Axis, Mesh, _names, all_reduce_sum
from gtsam_points_tpu_torch.types.frame import Frame, _map_attrs
from gtsam_points_tpu_torch.utils import se3

_SHARD_MIX1 = 0x9E3779B1
_SHARD_MIX2 = 0x85EBCA77
_U32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2^32 for int64 h in [0, 2^32): m is split in 16-bit
    halves so that no int64 product overflows."""
    return (h * (m & 0xFFFF) + (((h * (m >> 16)) & 0xFFFF) << 16)) & _U32


def shard_of_keys(keys: torch.Tensor, num_shards: int) -> torch.Tensor:
    """Owning shard [..] int32 of each packed voxel key: the reference's
    uint32 murmur mix, here in int64 masked to 32 bits (torch has no uint32
    arithmetic), equal to it bit for bit."""
    h = keys.to(torch.int64) & _U32  # the uint32 view of the int32 key
    h = _mul32(h ^ (h >> 15), _SHARD_MIX1)
    h = _mul32(h ^ (h >> 13), _SHARD_MIX2)
    h = h ^ (h >> 16)
    return (h % num_shards).to(torch.int32)


def _shard_mask(frame: Frame, leaf, num_shards: int, shard_id: int) -> torch.Tensor:
    keys = vk.point_keys(frame.points, frame.mask, leaf)
    return frame.mask & (shard_of_keys(keys, num_shards) == shard_id)


def _stack(maps) -> GaussianVoxelMap:
    return GaussianVoxelMap(*(torch.stack(xs) for xs in zip(*maps)))


def _shard(svmap: GaussianVoxelMap, s: int) -> GaussianVoxelMap:
    return GaussianVoxelMap(*(x[s] for x in svmap))


def _part(parts: Frame, s: int) -> Frame:
    return _map_attrs(parts, lambda x: x[s])


@dataclasses.dataclass(frozen=True)
class ShardedVoxelMap:
    """A sharded map placed on a mesh: `local` is shard `shard` of
    `num_shards`, on this rank's device; the other shards lie on the other
    ranks of the mesh axis `axis`."""

    local: GaussianVoxelMap
    shard: int
    num_shards: int
    mesh: Mesh
    axis: Axis

    @property
    def group(self):
        return self.mesh.group(self.axis)


SomeShardedMap = Union[GaussianVoxelMap, ShardedVoxelMap]


def _num_shards(svmap: SomeShardedMap) -> int:
    return svmap.num_shards if isinstance(svmap, ShardedVoxelMap) else svmap.keys.shape[0]


def _map_device(svmap: SomeShardedMap) -> torch.device:
    return (svmap.local if isinstance(svmap, ShardedVoxelMap) else svmap).keys.device


def build_sharded_voxelmap(frame: Frame, leaf: float, num_shards: int, capacity_per_shard: Optional[int] = None,
                           *, device: DeviceLike = None) -> GaussianVoxelMap:
    """-> GaussianVoxelMap with a leading [num_shards] axis on every field
    (scalars become [num_shards]), shard s built from the points it owns,
    on `device` (default `cuda`; raises when CUDA is absent unless the
    caller asked for the CPU), where the frame must lie. Total capacity =
    num_shards x capacity_per_shard (default: the frame's capacity a shard).
    Every shard has the same table shape at one capacity, so they stack.
    Place it on a mesh with `place_sharded`."""
    check_on(resolve_device(device), frame.points)
    cap = capacity_per_shard if capacity_per_shard is not None else frame.capacity
    return _stack([build_voxelmap(frame.replace(mask=_shard_mask(frame, leaf, num_shards, s)), leaf, capacity=cap)
                   for s in range(num_shards)])


def partition_frame_by_shard(frame: Frame, leaf, num_shards: int, capacity_per_shard: Optional[int] = None,
                             slack: float = 1.5):
    """Partition a scan by owning shard with ONE stable sort:
    -> (Frame with a leading [num_shards] axis and per-shard capacity C,
        overflow: the owned points dropped because a shard's slice was full).

    Shard s receives only its own points, in their order in the scan, so a
    shard's insert work is about scan / num_shards. C defaults to slack x
    ceil(N / num_shards), rounded up to 128: the hashed ownership is close
    to uniform, so it overflows with negligible probability, and overflow
    is counted, not hidden."""
    n = frame.capacity
    dev = frame.device
    keys = vk.point_keys(frame.points, frame.mask, leaf)
    sid = torch.where(frame.mask, shard_of_keys(keys, num_shards), num_shards)
    if capacity_per_shard is None:
        s_cap = -(-n // num_shards)
        s_cap = int(-(-int(s_cap * slack) // 128) * 128)
    else:
        s_cap = capacity_per_shard

    order = torch.argsort(sid, stable=True)  # owned points grouped by shard, padding last
    sid_sorted = sid[order]
    starts = torch.searchsorted(sid_sorted, torch.arange(num_shards, dtype=sid.dtype, device=dev))
    pos = torch.arange(n, device=dev) - starts[torch.clamp(sid_sorted, 0, num_shards - 1).long()]
    owned = sid_sorted < num_shards
    keep = owned & (pos < s_cap)
    dest = torch.where(keep, sid_sorted.long() * s_cap + pos, num_shards * s_cap)
    overflow = torch.sum((owned & ~keep).to(torch.int32), dtype=torch.int32)

    def scatter(x):
        flat = x.new_zeros((num_shards * s_cap + 1,) + x.shape[1:])
        flat[dest] = x[order]  # only the dropped sentinel row is written twice
        return flat[:-1].reshape((num_shards, s_cap) + x.shape[1:])

    parts = _map_attrs(frame, scatter)
    mask = torch.zeros((num_shards * s_cap + 1,), dtype=torch.bool, device=dev)
    mask[dest] = keep
    return parts.replace(mask=mask[:-1].reshape(num_shards, s_cap)), overflow


def sharded_insert_frame(svmap: SomeShardedMap, frame: Frame, capacity_per_shard: Optional[int] = None):
    """Insert a scan: one sort partitions it by owner
    (`partition_frame_by_shard`), then each shard merges its own slice with
    `insert_frame`. A placed map merges this rank's slice alone: no
    collective. -> (new sharded map of the same kind, overflow count of
    dropped owned points)."""
    check_on(_map_device(svmap), frame.points)
    if isinstance(svmap, ShardedVoxelMap):
        parts, overflow = partition_frame_by_shard(frame, svmap.local.leaf, svmap.num_shards, capacity_per_shard)
        return dataclasses.replace(svmap, local=insert_frame(svmap.local, _part(parts, svmap.shard))), overflow
    num_shards = svmap.keys.shape[0]
    parts, overflow = partition_frame_by_shard(frame, svmap.leaf[0], num_shards, capacity_per_shard)
    return _stack([insert_frame(_shard(svmap, s), _part(parts, s)) for s in range(num_shards)]), overflow


def _check_shard_axis(svmap: SomeShardedMap, mesh: Mesh, axis) -> None:
    """One shard a rank: the shard count must equal the number of ranks on
    the mesh axis (or axes); twice as many shards would drop half the map."""
    names = _names(axis)
    size = mesh.size(names)
    n_shards = _num_shards(svmap)
    if n_shards != size:
        raise ValueError(
            f"sharded voxelmap has {n_shards} shards but mesh axis {names} has "
            f"total size {size}; one shard per device is required"
        )


def place_sharded(svmap: GaussianVoxelMap, mesh: Mesh, axis="shard") -> ShardedVoxelMap:
    """Keep this rank's shard of a stacked map, the one at the rank's
    position on the mesh axis, on the rank's device. `axis` may be a mesh
    axis name or a tuple of names: on a (host, chip) mesh, ("host", "chip")
    splits the shards over every rank, host-major, and the linearize's
    all-reduce spans both axes."""
    _check_shard_axis(svmap, mesh, axis)
    s = mesh.index(axis)
    local = GaussianVoxelMap(*(x[s].to(mesh.device) for x in svmap))
    return ShardedVoxelMap(local=local, shard=s, num_shards=svmap.keys.shape[0], mesh=mesh, axis=axis)


def sharded_num_voxels(svmap: SomeShardedMap) -> torch.Tensor:
    """The voxels of every shard together, () int32; on a placed map, one
    all-reduce over the ranks."""
    if isinstance(svmap, ShardedVoxelMap):
        return all_reduce_sum(svmap.local.num_voxels.clone(), svmap.group)
    return torch.sum(svmap.num_voxels, dtype=torch.int32)


def sharded_overlap(svmap: SomeShardedMap, frame: Frame, T: torch.Tensor) -> torch.Tensor:
    """The share of the frame's points, moved by T, that land in an occupied
    voxel of ANY shard. A point's voxel has one owner, so on a placed map
    the ranks' hit counts add up, in one all-reduce."""
    check_on(_map_device(svmap), frame.points, T)
    pts = se3.transform_points(T, frame.points)
    if isinstance(svmap, ShardedVoxelMap):
        _, found = lookup_voxels(svmap.local, pts, frame.mask)
        hits = all_reduce_sum(torch.sum(found.to(torch.float32)).reshape(1), svmap.group)[0]
    else:
        found = torch.stack([lookup_voxels(_shard(svmap, s), pts, frame.mask)[1]
                             for s in range(svmap.keys.shape[0])])
        hits = torch.sum(torch.any(found, dim=0).to(torch.float32))
    return hits / torch.clamp(frame.num_valid(), min=1)


def _local_shard(svmap: ShardedVoxelMap, mesh: Mesh, axis) -> GaussianVoxelMap:
    """This rank's shard of a placed map, checked against the mesh axis. A
    stacked map is refused: every rank would hold every shard."""
    if not isinstance(svmap, ShardedVoxelMap):
        raise TypeError(f"a placed ShardedVoxelMap is required (place_sharded), not {type(svmap).__name__}")
    _check_shard_axis(svmap, mesh, axis)
    s = mesh.index(axis)
    if svmap.shard != s:
        raise ValueError(f"this rank holds shard {svmap.shard}, but is at {s} on mesh axis {axis!r}")
    return svmap.local


def _source_planar(source: Frame):
    """(points [3, N], covs6 [6, N] or None), contiguous."""
    pts_p = source.points.T.contiguous()
    c = source.covs
    if c is None:
        return pts_p, None
    return pts_p, torch.stack([c[:, 0, 0], c[:, 0, 1], c[:, 0, 2], c[:, 1, 1], c[:, 1, 2], c[:, 2, 2]])


def _local_corr(vm: GaussianVoxelMap, pts_p, covs6, mask, delta, min_voxel_points):
    """This shard's frozen correspondence payload at `delta`:
    (found [N], mu [3, N], W6 [6, N], moved points [3, N]), hits only for
    voxels this shard owns."""
    pm = planar.transform(delta, pts_p)
    found, cnt, mu, C6 = lookup_fetch_planar(vm, pm, mask)
    found = found & (cnt >= min_voxel_points)
    if covs6 is not None:
        fused = C6 + planar.sym_rotate(delta[:3, :3], covs6)
    else:
        fused = planar.sym_add_eye(C6, 1e-3)
    return found, mu, planar.sym_inv(fused), pm


def _all_reduce_linearized(lin: Linearized, group) -> Linearized:
    """Sum a Linearized over the group in ONE all-reduce of its 122 floats
    (the inlier count as an f32, exact below 2^24)."""
    payload = torch.cat([lin.H_tt.reshape(-1), lin.H_ss.reshape(-1), lin.H_ts.reshape(-1), lin.b_t, lin.b_s,
                         lin.error.reshape(1), lin.num_inliers.to(torch.float32).reshape(1)])
    all_reduce_sum(payload, group)
    return Linearized(
        H_tt=payload[0:36].reshape(6, 6),
        H_ss=payload[36:72].reshape(6, 6),
        H_ts=payload[72:108].reshape(6, 6),
        b_t=payload[108:114],
        b_s=payload[114:120],
        error=payload[120],
        num_inliers=payload[121].to(torch.int32),
    )


def _linearize_local(vm, pts_p, covs6, mask, delta, min_voxel_points):
    """K3 on this shard's hits -> (this rank's partial Linearized, the
    correspondences (found, mu, W6))."""
    found, mu, W6, _ = _local_corr(vm, pts_p, covs6, mask, delta, min_voxel_points)
    lin = fused_linearize.linearize_fused(pts_p, mu.contiguous(), W6.contiguous(), found.contiguous(),
                                          delta.contiguous())
    return lin, (found, mu, W6)


def linearize_vgicp_sharded(svmap: ShardedVoxelMap, source: Frame, delta: torch.Tensor, mesh: Mesh,
                            axis: Axis = "shard", min_voxel_points: float = 5.0) -> Linearized:
    """Map-sharded VGICP linearization: this rank's probe and K3 on its
    shard, then one all-reduce of the Linearized payload over the ranks of
    `axis`. Equal, up to the order of the f32 sums, to the system against
    the replicated map; every rank gets the same bits."""
    vm = _local_shard(svmap, mesh, axis)
    check_on(vm.keys.device, source.points, delta)
    pts_p, covs6 = _source_planar(source)
    lin, _ = _linearize_local(vm, pts_p, covs6, source.mask, delta, min_voxel_points)
    return _all_reduce_linearized(lin, mesh.group(axis))


@dataclasses.dataclass(frozen=True)
class VGICPShardedFactor:
    """VGICP factor whose target map is sharded over the ranks of a mesh.

    The cost of factors/vgicp.VGICPFactor, with the map's shards on the
    ranks of `axis`: a linearization is `linearize_vgicp_sharded` (K3 on
    each rank, one all-reduce of 488 bytes), and its frozen error scores
    candidate poses on each rank's correspondences and sums them in one
    all-reduce of the errors. It provides `linearize_with_error_fn`, so a
    FactorGraph takes it as it takes any factor of one or two keys. Every
    rank must run the same graph: each linearization and each error is a
    collective."""

    voxelmaps: ShardedVoxelMap  # placed: this rank's shard
    source: Frame  # the whole scan, on every rank
    fixed_target_pose: torch.Tensor
    target_key: int
    source_key: int
    min_voxel_points: float
    mesh: Mesh
    axis: Axis = "shard"

    @property
    def keys(self):
        return (self.target_key, self.source_key)

    @functools.cached_property
    def _local(self) -> GaussianVoxelMap:
        return _local_shard(self.voxelmaps, self.mesh, self.axis)

    @functools.cached_property
    def _source_planar(self):
        return _source_planar(self.source)

    def linearize_with_error_fn(self, poses: torch.Tensor):
        """-> (the reduced Linearized, frozen_error_fn). The error function
        evaluates candidate poses [..., P, 4, 4] on the correspondences of
        this linearization point (majorize-minimize, as factors/batch.py's
        frozen error) and all-reduces the errors."""
        delta0 = relative_pose(self, poses)
        pts_p, covs6 = self._source_planar
        group = self.mesh.group(self.axis)
        lin, (found, mu, W6) = _linearize_local(self._local, pts_p, covs6, self.source.mask, delta0,
                                                self.min_voxel_points)
        lin = _all_reduce_linearized(lin, group)

        def err_fn(new_poses):
            r = planar.transform(relative_pose(self, new_poses), pts_p) - mu
            err = planar.weighted_error(r, W6, found)
            return all_reduce_sum(err.reshape(-1), group).reshape(err.shape)

        return lin, err_fn

    def linearize(self, poses: torch.Tensor) -> Linearized:
        lin, _ = self.linearize_with_error_fn(poses)
        return lin

    def error(self, poses: torch.Tensor) -> torch.Tensor:
        """The error at `poses`, correspondences searched there, summed over
        the ranks in one all-reduce."""
        delta = relative_pose(self, poses)
        pts_p, covs6 = self._source_planar
        found, mu, W6, pm = _local_corr(self._local, pts_p, covs6, self.source.mask, delta, self.min_voxel_points)
        err = planar.weighted_error(pm - mu, W6, found)
        return all_reduce_sum(err.reshape(1), self.mesh.group(self.axis))[0]


def make_vgicp_sharded_factor(target_key: int, source_key: int, svmap: ShardedVoxelMap, source: Frame, mesh: Mesh,
                              axis: Axis = "shard", min_voxel_points: float = 5.0,
                              fixed_target_pose: Optional[torch.Tensor] = None) -> VGICPShardedFactor:
    check_on(mesh.device, source.points)
    if fixed_target_pose is None:
        fixed_target_pose = torch.eye(4, dtype=torch.float32, device=mesh.device)
    return VGICPShardedFactor(
        voxelmaps=svmap,
        source=source,
        fixed_target_pose=fixed_target_pose,
        target_key=target_key,
        source_key=source_key,
        min_voxel_points=min_voxel_points,
        mesh=mesh,
        axis=axis,
    )


def collective_bytes_per_linearize() -> int:
    """The bytes one map-sharded linearization all-reduces: the Linearized
    payload (H_tt, H_ss, H_ts [6, 6], b_t, b_s [6], error, inliers) in f32."""
    return 4 * (3 * 36 + 2 * 6 + 2)
