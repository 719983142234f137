"""Timing on the card with CUDA events, and profiler traces.

``wall`` times each call of a function between two CUDA events on the
current stream, after warm-up, and reports the median, min and max;
``device_work`` profiles one step for its device time by kernel and the
device's idle share.  Both need a CUDA device: a measurement that finds
none raises instead of timing the CPU.  ``trace`` records a ``torch.profiler`` trace into a
directory (TensorBoard's format, a Chrome trace), and ``annotate`` names
a range in it (counterparts of ``tpucomp.utils.profiling.trace`` and
``annotate``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time
from typing import Callable

import torch


@dataclasses.dataclass
class WallResult:
    ms: list[float]            # one device time per timed call
    bytes_processed: int = 0

    @property
    def median_ms(self) -> float:
        return statistics.median(self.ms)

    @property
    def min_ms(self) -> float:
        return min(self.ms)

    @property
    def max_ms(self) -> float:
        return max(self.ms)

    @property
    def gbps(self) -> float:
        """bytes_processed / median time, in GB/s (1e9 bytes)."""
        return self.bytes_processed / 1e6 / self.median_ms

    def summary(self) -> dict:
        return {"median_ms": self.median_ms, "min_ms": self.min_ms, "max_ms": self.max_ms,
                "gbps": self.gbps}


def wall(fn: Callable, *args, iters: int = 5, warmup: int = 1, bytes_processed: int = 0,
         **kwargs) -> WallResult:
    """Device time of ``fn(*args, **kwargs)`` per call, from CUDA events."""
    if not torch.cuda.is_available():
        raise RuntimeError("wall() times CUDA work and needs a CUDA device")
    for _ in range(warmup):
        fn(*args, **kwargs)
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args, **kwargs)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return WallResult(times, bytes_processed)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the block, written into ``log_dir`` when
    it ends: host activity, and the card's when there is one."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield


def device_work(step: Callable, ranges=()) -> tuple[float, dict, dict[str, float]]:
    """One ``step()`` on the card under ``torch.profiler``: (the step's
    host-clock ms, ended by a synchronise, the median of 3 runs without the
    profiler; the profiler's averages by key; device ms by kernel).  Device
    work is the device-side entries (kernels, copies, fills), not the
    annotated ``ranges``, which the profiler also lists as device-side
    spans over their kernels, nor its own buffer requests.  The device's
    idle share of the step is 1 - sum(device ms) / wall ms; an empty
    dict means the profiler saw no device time (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("device_work() profiles CUDA work and needs a CUDA device")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    avg = {e.key: e for e in prof.key_averages()}
    work = {k: e.self_device_time_total / 1e3 for k, e in avg.items()
            if e.device_type != DeviceType.CPU and k not in ranges
            and not k.startswith("Activity Buffer") and e.self_device_time_total > 0}
    return statistics.median(walls), avg, work


annotate = torch.profiler.record_function  # ``with annotate(name):`` names a range in profiler traces
