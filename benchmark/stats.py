"""The benchmark's arithmetic: rates, tails, roofline bounds, busy time.

Plain functions on numbers, so the tests can hold each to hand-made inputs.
"""

from __future__ import annotations

import statistics

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3 at 700 W


def rate_gbps(bytes_per_call: int, calls: int, wall_s: float) -> float:
    """All the work over all the time: bytes of every call over the
    phase's wall, in GB/s (1e9 bytes)."""
    return bytes_per_call * calls / wall_s / 1e9


def p95(values: list[float]) -> tuple[float, int]:
    """The 95th percentile of ``values`` (``statistics.quantiles``,
    inclusive method) and how many values lie above it."""
    if len(values) == 1:
        return values[0], 0
    q = statistics.quantiles(values, n=20, method="inclusive")[18]
    return q, sum(v > q for v in values)


def roofline_s(bytes_read: int, bytes_written: int, peak_bytes_per_s: float = HBM_BYTES_PER_S) -> float:
    """The least time a stage could take on the card: every byte it must
    read read once and every byte it must write written once, at the HBM
    rate.  A codec does next to no arithmetic per byte, so bandwidth bounds it."""
    return (bytes_read + bytes_written) / peak_bytes_per_s


def union_length(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    return sum(e - s for s, e in merged(intervals))


def merged(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The union of [start, end) intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for s, e in sorted(i for i in intervals if i[1] > i[0]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(intervals: list[tuple[float, float]], start: float, end: float) -> list[tuple[float, float]]:
    """The parts of [start, end) that no interval covers."""
    out, cur = [], start
    for s, e in merged([(max(s, start), min(e, end)) for s, e in intervals]):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if end > cur:
        out.append((cur, end))
    return out
