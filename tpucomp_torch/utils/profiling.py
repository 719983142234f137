"""Timing on the card with CUDA events.

``wall`` times each call of a function between two CUDA events on the
current stream, after warm-up, and reports the median, min and max.  It
needs a CUDA device: a measurement that finds none raises instead of
timing the CPU.
"""

from __future__ import annotations

import dataclasses
import statistics
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
