"""The 95th percentile of every compress call's latency in the phase,
from the call's start to its sizes on the host, in ms."""

from benchmark import stats


def read(run):
    p = run.phases.get("compress")
    if p is None or run.windows:
        return None
    return 1e3 * stats.p95(p.latencies_s)[0]
