"""Small stateful utilities.

Port of gtsam_points_tpu/utils/stats.py: `RunningStatistics` (online mean
and variance in moment form, an immutable NamedTuple of tensors, used for
the eigenvalue gating of ops/incremental_covariance.py) and
`IndexedSlidingWindow` (a deque with stable absolute indexing, pure Python).
"""

from __future__ import annotations

from typing import Generic, List, NamedTuple, TypeVar

import torch

from gtsam_points_tpu_torch._device import DeviceLike, resolve_device

T = TypeVar("T")


class RunningStatistics(NamedTuple):
    """count () f32, total [...] and sq_total [...] of the values added."""

    count: torch.Tensor
    total: torch.Tensor
    sq_total: torch.Tensor

    @staticmethod
    def empty(shape=(), dtype=torch.float32, *, device: DeviceLike = None) -> "RunningStatistics":
        dev = resolve_device(device)
        z = torch.zeros(shape, dtype=dtype, device=dev)
        return RunningStatistics(count=torch.zeros((), dtype=torch.float32, device=dev), total=z, sq_total=z)

    def add(self, x: torch.Tensor) -> "RunningStatistics":
        return RunningStatistics(self.count + 1.0, self.total + x, self.sq_total + x * x)

    def mean(self) -> torch.Tensor:
        return self.total / torch.clamp(self.count, min=1.0)

    def var(self) -> torch.Tensor:
        m = self.mean()
        return self.sq_total / torch.clamp(self.count, min=1.0) - m * m

    def std(self) -> torch.Tensor:
        return torch.sqrt(torch.clamp(self.var(), min=0.0))


class IndexedSlidingWindow(Generic[T]):
    """Deque with stable absolute indexing: window[i] addresses the item by
    the index it got at insertion, also after older items were dropped."""

    def __init__(self, max_size: int):
        self.max_size = max_size
        self._items: List[T] = []
        self._first_index = 0

    def push(self, item: T) -> int:
        self._items.append(item)
        idx = self._first_index + len(self._items) - 1
        while len(self._items) > self.max_size:
            self._items.pop(0)
            self._first_index += 1
        return idx

    def __getitem__(self, index: int) -> T:
        i = index - self._first_index
        if i < 0 or i >= len(self._items):
            raise IndexError(f"index {index} outside window [{self._first_index}, {self.last_index}]")
        return self._items[i]

    def __contains__(self, index: int) -> bool:
        return self._first_index <= index <= self.last_index

    @property
    def first_index(self) -> int:
        return self._first_index

    @property
    def last_index(self) -> int:
        return self._first_index + len(self._items) - 1

    def __len__(self):
        return len(self._items)
