"""Scoped profilers (reference: util/easy_profiler.hpp:13-100,
util/stopwatch.hpp:10-27, util/easy_profiler_cuda.hpp).

Port of gtsam_points_tpu/utils/profiling.py. CUDA work runs asynchronously,
so `EasyProfiler.push` synchronizes the device of the tensor it is given
before it reads the clock, and each segment's wall time covers the device
work enqueued in it. `trace` is the device-level analogue of the
reference's CUDA event profiler: a `torch.profiler` trace of CPU and CUDA
activity, written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from gtsam_points_tpu_torch._device import DeviceLike, resolve_device
from gtsam_points_tpu_torch.utils.memory import tensors


class Stopwatch:
    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - self.t0
        self.t0 = now
        return dt


class EasyProfiler:
    """push(label) records a segment boundary; the summary prints on exit.

    with EasyProfiler("align") as prof:
        prof.push("preprocess", block_on=frame.points); ...
        prof.push("optimize", block_on=result.poses); ...
    """

    def __init__(self, name: str = "profile", enabled: bool = True, sync: bool = True, out=None):
        self.name = name
        self.enabled = enabled
        self.sync = sync
        self.out = out
        self.marks: list[tuple[str, float]] = []

    def __enter__(self):
        self.push("begin")
        return self

    def push(self, label: str, block_on=None):
        """Mark the end of a segment at `label`. With `sync` on, first wait for
        the devices of the CUDA tensors `block_on` holds (a tensor or any
        nesting `memory.tensors` walks)."""
        if not self.enabled:
            return
        if block_on is not None and self.sync:
            for dev in {t.device for t in tensors(block_on) if t.is_cuda}:
                torch.cuda.synchronize(dev)
        self.marks.append((label, time.perf_counter()))

    def __exit__(self, *exc):
        self.push("end")
        if not self.enabled or len(self.marks) < 2:
            return False
        lines = [f"--- {self.name} ---"]
        for (l0, t0), (_, t1) in zip(self.marks[:-1], self.marks[1:]):
            lines.append(f"{l0:>24s}: {(t1 - t0) * 1e3:8.2f} ms")
        total = self.marks[-1][1] - self.marks[0][1]
        lines.append(f"{'total':>24s}: {total * 1e3:8.2f} ms")
        print("\n".join(lines), file=self.out)
        return False


@contextlib.contextmanager
def trace(log_dir: str, device: DeviceLike = None):
    """Device-level tracing context: with profiling.trace(dir): ...
    CPU and CUDA activity (CPU only with device="cpu"), written on exit as
    `dir/trace.json`, a Chrome trace. Raises without CUDA unless the caller
    passes device="cpu"."""
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
