"""The host time of each span of tpucomp_torch in one traced benchmark run.

    python3 scripts/torch_span_table.py --workload <cell> --seed <n> [--seconds 2]

Runs one cell of the benchmark once with tracing on (``benchmark.harness.
run_cell``, as ``benchmark/run.py --trace 1`` does) and prints its result
line; then, from the port's tracer (``tpucomp_torch/utils/profiling.py``),
one line for every span name the run recorded (``span_rows``): its count,
the median host time, self time, own cost, work and children's cost, in
us, and for a device-timed span the median of its CUDA-event time, in ms.  Last, what a
span costs on the host: with tracing off (a ``with span(...)`` around
nothing), and on (under ``torch.profiler``), in us a span.  Needs a CUDA
device, as the benchmark does.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def span_rows(records) -> list[dict]:
    """One row a span name, medians over its records: count; host us of the
    interval; self us (less the children's intervals); the span's own cost
    us (``SpanRecord.cost_ns``: its entry and exit, the tracer's, not the
    port's); work us (self less own cost: the port's host work in the span,
    the profiler's cost on its operations included); the children's own
    cost us, which lies in this span's interval outside theirs; device ms
    of a device-timed span."""
    children, children_cost = defaultdict(int), defaultdict(int)
    for s in records:
        if s.parent is not None and s.end_ns is not None:
            children[id(s.parent)] += s.end_ns - s.start_ns
            children_cost[id(s.parent)] += s.cost_ns()
    by_name = defaultdict(list)
    for s in records:
        if s.end_ns is not None:
            by_name[s.name].append(s)
    rows = []
    for name, recs in by_name.items():
        dev = [s.device_ms() for s in recs if s.events is not None]
        self_ns = [s.end_ns - s.start_ns - children[id(s)] for s in recs]
        rows.append({"span": name, "count": len(recs),
                     "host_us": statistics.median((s.end_ns - s.start_ns) / 1e3 for s in recs),
                     "self_us": statistics.median(self_ns) / 1e3,
                     "cost_us": statistics.median(s.cost_ns() / 1e3 for s in recs),
                     "work_us": statistics.median((t - s.cost_ns()) / 1e3 for s, t in zip(recs, self_ns)),
                     "children_cost_us": statistics.median(children_cost[id(s)] / 1e3 for s in recs),
                     "device_ms": statistics.median(dev) if dev else None})
    return sorted(rows, key=lambda r: r["span"])


def span_cost_us(n_off: int = 1_000_000, n_on: int = 20_000) -> tuple[float, float, float]:
    """Host us a ``with span(...)`` costs with tracing off, and on; and of
    that, a bare ``record_function`` range's cost on."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from tpucomp_torch.utils import profiling

    def per_span(n, ctx):
        t0 = time.perf_counter()
        for _ in range(n):
            with ctx("compress.api"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    off = per_span(n_off, profiling.span)
    with profile(activities=[ProfilerActivity.CPU]):
        on = per_span(n_on, profiling.span)
        bare = per_span(n_on, record_function)
    profiling.reset()
    return off, on, bare


def main(argv=None) -> int:
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch

    from benchmark import harness
    from tpucomp_torch.utils import profiling

    if not torch.cuda.is_available():
        print("torch_span_table.py runs the benchmark on a CUDA device and found none", file=sys.stderr)
        return 2
    profiling.reset()
    line = harness.run_cell(args.workload, args.seed, args.seconds, True, t0)
    print(json.dumps(line), flush=True)
    print(f"spans of {args.workload} (seed {args.seed}), {profiling.dropped()} dropped; "
          f"card {harness.smi('name,power.limit')}")
    for r in span_rows(profiling.spans()):
        dev = f", device {r['device_ms']:.4f} ms" if r["device_ms"] is not None else ""
        print(f"  {r['span']:<36} {r['count']:>6}  host {r['host_us']:10.2f}  self {r['self_us']:10.2f}  "
              f"own cost {r['cost_us']:6.2f}  work {r['work_us']:10.2f}  children's cost "
              f"{r['children_cost_us']:6.2f} us{dev}")
    off, on, bare = span_cost_us()
    print(f"a span's host cost: {off:.4f} us with tracing off, {on:.3f} us on, of which a bare "
          f"record_function range {bare:.3f} us")
    return 0 if line["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
