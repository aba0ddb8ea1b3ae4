"""Host-memory offload pool for state beyond device memory (keyframes, voxel maps).

Port of gtsam_points_tpu/utils/offload.py, the analogue of the reference's
OffloadableGPU LRU offloading (include/gtsam_points/types/offloadable.hpp:
19-50: touch / offload_gpu / reload_gpu with a global access clock): a long
mapping session gathers more keyframes and submaps than one card holds;
cold entries spill to host memory and come back on touch.

An `OffloadPool` owns named entries, each any object `memory.nbytes` walks
(a `Frame`, a voxel map, a dict of tensors), on the device or on the host.
`touch(name)` reloads and bumps the access clock; `ensure_budget()` spills
the least recently touched entries until the device-resident ones fit the
budget; `put()` spills to stay under it. A spill moves every tensor of the
entry to the host with `.to("cpu")`, a reload back with `.to(device)`: plain
synchronous copies (the reference spills with cudaMemcpyAsync on a stream).
"""

from __future__ import annotations

from typing import Dict, Optional

from gtsam_points_tpu_torch._device import DeviceLike, resolve_device
from gtsam_points_tpu_torch.utils.memory import map_tensors, nbytes


class _Entry:
    __slots__ = ("tree", "on_device", "last_access", "bytes")

    def __init__(self, tree, on_device: bool, last_access: int, num_bytes: int):
        self.tree = tree
        self.on_device = on_device
        self.last_access = last_access
        self.bytes = num_bytes


class OffloadPool:
    """LRU host-offload registry for device state.

    `device_budget_bytes` bounds the total bytes of the device-resident
    entries the pool manages (what lives outside the pool is the caller's
    headroom to leave). `device` defaults to `cuda`.
    """

    def __init__(self, device_budget_bytes: int, device: DeviceLike = None):
        self.budget = int(device_budget_bytes)
        self.device = resolve_device(device)
        self._entries: Dict[str, _Entry] = {}
        self._clock = 0

    # -- reference-API mirrors ------------------------------------------------

    def current_access_time(self) -> int:
        return self._clock

    def last_accessed_time(self, name: str) -> int:
        return self._entries[name].last_access

    def loaded_on_device(self, name: str) -> bool:
        return self._entries[name].on_device

    def memory_usage_device(self) -> int:
        return sum(e.bytes for e in self._entries.values() if e.on_device)

    # -- core -----------------------------------------------------------------

    def put(self, name: str, tree) -> None:
        """Register (or replace) a device-resident entry; spills cold entries
        if the budget would be exceeded."""
        self._clock += 1
        self._entries[name] = _Entry(tree, True, self._clock, nbytes(tree))
        self.ensure_budget()

    def touch(self, name: str):
        """Reload to the device if offloaded (reference: touch), bump the
        access clock, and return the device-resident entry."""
        e = self._entries[name]
        self._clock += 1
        e.last_access = self._clock
        if not e.on_device:
            e.tree = map_tensors(lambda x: x.to(self.device), e.tree)
            e.on_device = True
            self.ensure_budget(exempt=name)
        return e.tree

    def offload(self, name: str) -> bool:
        """Spill to host memory (reference: offload_gpu). True if a spill ran."""
        e = self._entries[name]
        if not e.on_device:
            return False
        e.tree = map_tensors(lambda x: x.to("cpu"), e.tree)
        e.on_device = False
        return True

    def reload(self, name: str) -> bool:
        """(reference: reload_gpu). True if an upload ran."""
        if self._entries[name].on_device:
            return False
        self.touch(name)
        return True

    def ensure_budget(self, exempt: Optional[str] = None) -> int:
        """Spill least-recently-touched device entries until under budget.
        Returns the number of entries spilled."""
        spilled = 0
        while self.memory_usage_device() > self.budget:
            candidates = [(e.last_access, n) for n, e in self._entries.items() if e.on_device and n != exempt]
            if not candidates:
                break
            _, victim = min(candidates)
            self.offload(victim)
            spilled += 1
        return spilled

    def remove(self, name: str) -> None:
        self._entries.pop(name, None)

    def names(self):
        return list(self._entries)
