"""Memory accounting, and the walk over nested state that it shares.

Port of gtsam_points_tpu/utils/memory.py (reference: the memory_usage()
methods on clouds and factors, e.g.
include/gtsam_points/factors/integrated_icp_factor.hpp:82-87). The JAX
module sums the leaves of a pytree; here the same leaves are the tensors
reached through dataclasses (a `Frame`, a factor), NamedTuples (a voxel
map), dicts (a frame's `aux`), lists and tuples. `optim/isam2.py` reads
factors with the same walk.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Tuple

import torch


def children(obj) -> Iterator[Tuple[str, object]]:
    """(name, value) of a dataclass's fields or a NamedTuple's."""
    if dataclasses.is_dataclass(obj):
        return ((f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj))
    return zip(obj._fields, obj)


def is_node(obj) -> bool:
    """A dataclass instance or a NamedTuple: a node whose fields are walked."""
    return (dataclasses.is_dataclass(obj) and not isinstance(obj, type)) or (
        isinstance(obj, tuple) and hasattr(obj, "_fields"))


def tensors(obj) -> Iterator[torch.Tensor]:
    """Every tensor `obj` holds, nested fields, dict values and items included."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif is_node(obj):
        for _, v in children(obj):
            yield from tensors(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from tensors(v)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from tensors(v)


def map_tensors(fn: Callable[[torch.Tensor], torch.Tensor], obj):
    """`obj` rebuilt with `fn` applied to every tensor `tensors` reaches: a
    dataclass by `dataclasses.replace` (its init fields), a NamedTuple by
    `_replace`, dicts, lists and tuples anew; anything else as it is."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: map_tensors(fn, getattr(obj, f.name))
                                          for f in dataclasses.fields(obj) if f.init})
    if is_node(obj):
        return obj._replace(**{name: map_tensors(fn, v) for name, v in children(obj)})
    if isinstance(obj, dict):
        return {k: map_tensors(fn, v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(map_tensors(fn, v) for v in obj)
    return obj


def nbytes(tree) -> int:
    """Total bytes of the tensors `tree` holds (wherever they lie)."""
    return sum(t.numel() * t.element_size() for t in tensors(tree))
