"""Meshes of ranks, and placing frames and state on them.

Port of gtsam_points_tpu/parallel/sharding.py onto `torch.distributed`. A JAX
`Mesh` is an array of devices inside one program; here every mesh position is
a process (a rank) with a device of its own, and a collective runs over the
process group of the ranks it spans. `Mesh` holds the ranks in an array of
the mesh's shape, the axis names, this rank's device, and one process group
for every set of axes, made when the mesh is made. Several ranks may share
one card: the groups are plain `dist.new_group`s, not a `DeviceMesh`, which
assumes one device a rank.

`init_distributed` takes the place of `jax.distributed.initialize`: the
caller names the backend (gloo, or NCCL with one card a rank) and how the
ranks meet (`file://` or `tcp://localhost:<port>`). Nothing picks a backend
on its own.

`global_put` has no counterpart. It works around JAX's own check that every
process holds equal host values, which treats NaN != NaN (the voxel probe
tables hold int32 keys bitcast to f32, some of them NaN); `torch.distributed`
makes no such check.

`all_reduce_sum` is the one collective of the layer. `collectives` and
`bytes_reduced` count its calls and the bytes they reduced, so a run can say
what crossed between the ranks. With gloo it reduces CUDA tensors as they are
(gloo stages them through host memory itself).
"""

from __future__ import annotations

import datetime
import itertools
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from gtsam_points_tpu_torch._device import DeviceLike, check_on, resolve_device
from gtsam_points_tpu_torch.types.frame import Frame, _map_attrs

Axis = Union[str, Sequence[str]]

collectives = 0
bytes_reduced = 0

_COLLECTIVE_TIMEOUT_S = 120


def init_distributed(rank: int, world_size: int, init_method: str, backend: str,
                     device: DeviceLike = None) -> torch.device:
    """Join the default process group as `rank` of `world_size` and return
    this rank's device (default `cuda`; raises when CUDA is absent unless
    the caller asked for the CPU). A collective that waits longer than
    _COLLECTIVE_TIMEOUT_S raises instead of hanging: a rank that took
    another branch than the others ends the run rather than stalling it."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=_COLLECTIVE_TIMEOUT_S))
    return dev


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized; call init_distributed first")
    return dist.get_world_size()


def _names(axis: Axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


class Mesh:
    """Ranks [d0, d1, ...] with one axis name a dimension, and this rank's
    device. Making a mesh is collective: every rank of the default group
    makes it, with the same ranks and axes, in the same order as its other
    meshes (each set of axes gets its groups from `dist.new_group`, which
    every rank must enter). A rank outside the mesh holds it but can run
    nothing on it."""

    def __init__(self, ranks, axis_names: Sequence[str], device: DeviceLike):
        world = _world_size()
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"ranks of shape {self.ranks.shape} for axes {self.axis_names}")
        flat = self.ranks.ravel().tolist()
        if len(set(flat)) != len(flat) or min(flat) < 0 or max(flat) >= world:
            raise ValueError(f"mesh ranks {flat} are not distinct ranks of a world of {world}")
        self.device = torch.device(device)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, self.ranks.shape))
        me = dist.get_rank()
        where = np.argwhere(self.ranks == me)
        self.coords: Optional[Tuple[int, ...]] = tuple(int(c) for c in where[0]) if len(where) else None
        self._groups = {}
        nd = self.ranks.ndim
        for r in range(1, nd + 1):
            for dims in itertools.combinations(range(nd), r):
                # one group for each slice of the mesh along `dims`
                rest = [d for d in range(nd) if d not in dims]
                slices = np.transpose(self.ranks, rest + list(dims)).reshape(-1, int(np.prod([self.ranks.shape[d]
                                                                                               for d in dims])))
                for row in slices.tolist():
                    group = dist.new_group(row)
                    if me in row:
                        self._groups[frozenset(self.axis_names[d] for d in dims)] = group

    def _check_member(self) -> None:
        if self.coords is None:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh {self.ranks.tolist()}")

    def size(self, axis: Axis) -> int:
        """The number of ranks along the named axes together."""
        return int(np.prod([self.shape[n] for n in _names(axis)]))

    def index(self, axis: Axis) -> int:
        """This rank's position along the named axes together, the first name
        major: on a (host, chip) mesh, axis ("host", "chip") gives host x
        chips + chip, the order in which JAX splits an array over both."""
        self._check_member()
        i = 0
        for n in _names(axis):
            i = i * self.shape[n] + self.coords[self.axis_names.index(n)]
        return i

    def group(self, axis: Axis):
        """The process group of the ranks that share this rank's position on
        every axis but the named ones."""
        self._check_member()
        return self._groups[frozenset(_names(axis))]


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum `x` over the group's ranks, in place; every rank gets the same
    bits. Counted in `collectives` and `bytes_reduced`."""
    global collectives, bytes_reduced
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    collectives += 1
    bytes_reduced += x.numel() * x.element_size()
    return x


def make_mesh(n: Optional[int] = None, axis: str = "point", *, device: DeviceLike = None) -> Mesh:
    """A one-axis mesh of ranks 0..n-1 (default: the whole world), with this
    rank's device (default `cuda`; raises when CUDA is absent unless the
    caller asked for the CPU)."""
    dev = resolve_device(device)
    world = _world_size()
    n = world if n is None else n
    if not 0 < n <= world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    return Mesh(np.arange(n), (axis,), dev)


def make_mesh_2d(n_hosts: Optional[int] = None, chips_per_host: Optional[int] = None, axes=("host", "chip"),
                 *, device: DeviceLike = None) -> Mesh:
    """Two-level mesh: the leading axis across hosts, the trailing one over
    the cards of a host. Ranks are numbered host-major (rank = host x
    chips_per_host + chip), as launchers number them (node rank times
    processes a node plus local rank), which keeps each mesh row on one host:
    the order JAX's sort of devices by (process_index, id) gives. Nothing
    tells a rank how many hosts there are: `n_hosts` defaults to 1 and
    `chips_per_host` to the world over `n_hosts`."""
    dev = resolve_device(device)
    world = _world_size()
    n_hosts = 1 if n_hosts is None else n_hosts
    chips_per_host = world // n_hosts if chips_per_host is None else chips_per_host
    n = n_hosts * chips_per_host
    if not 0 < n <= world:
        raise ValueError(f"a mesh of {n_hosts} x {chips_per_host} ranks in a world of {world}")
    return Mesh(np.arange(n).reshape(n_hosts, chips_per_host), tuple(axes), dev)


def shard_frame(frame: Frame, mesh: Mesh, axis: str = "point") -> Frame:
    """This rank's contiguous slice of every per-point field: slice i of
    `mesh.size(axis)` for the rank at position i on the axis. The capacity
    must divide evenly. The frame must lie on the mesh's device."""
    check_on(mesh.device, frame.points)
    size, i = mesh.size(axis), mesh.index(axis)
    if frame.capacity % size:
        raise ValueError(f"frame capacity {frame.capacity} does not divide over {size} ranks on {axis!r}")
    k = frame.capacity // size
    return _map_attrs(frame, lambda x: x[i * k:(i + 1) * k])


def _broadcast(x: torch.Tensor, src: int, group, device: torch.device) -> torch.Tensor:
    y = x.to(device).contiguous().clone()
    if y.dtype == torch.bool:  # sent as bytes
        z = y.to(torch.uint8)
        dist.broadcast(z, src, group=group)
        return z.to(torch.bool)
    dist.broadcast(y, src, group=group)
    return y


def replicate(tree, mesh: Mesh):
    """The mesh's first rank's values of a tree of tensors (a tensor, a
    Frame, a NamedTuple such as a voxel map, a tuple, list or dict of them;
    None and other leaves pass through) on every rank's device. Every rank
    passes a tree of the same structure and shapes."""
    names = mesh.axis_names
    group, src = mesh.group(names), int(mesh.ranks.flat[0])

    def rep(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return _broadcast(x, src, group, mesh.device)
        if isinstance(x, Frame):
            return _map_attrs(x, rep)
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(rep(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(rep(v) for v in x)
        if isinstance(x, dict):
            return {k: rep(v) for k, v in x.items()}
        return x

    return rep(tree)
