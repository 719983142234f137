"""Uncompressed bytes compressed in the compress phase over that phase's
host-clock wall, which ends on a synchronise: all the work over all the
time, in GB/s (1e9 bytes)."""

from benchmark import stats


def read(run):
    p = run.phases.get("compress")
    if p is None or run.windows:
        return None
    return stats.rate_gbps(run.bytes_per_call, p.calls, p.wall_s)
