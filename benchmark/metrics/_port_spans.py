"""What the per-layer metrics read from the port's own tracer
(``tpucomp_torch.utils.profiling``): its span records and its kernels'
counters, recorded while a traced window's profiler ran.  Each function
returns None where the port recorded nothing of its kind, or has no
tracer, as a port from before it has not."""

from __future__ import annotations

import statistics


def _profiling():
    from tpucomp_torch.utils import profiling

    return profiling if hasattr(profiling, "spans") and hasattr(profiling, "counters") else None


def host_us(run, phase: str) -> float | None:
    """The host time a call spends in the port before its first kernel is
    launched, the median over the calls, in us: from the body of the call's
    outermost span of the port to the end of the body of its first
    ``<phase>.<codec>.….launch`` span, less the tracer's own cost of every
    span that entered or left in between (``SpanRecord.cost_ns``), so that
    the reading holds the port's host work and the profiler's cost on its
    operations and launches, but not the spans'."""
    profiling = _profiling()
    if profiling is None:
        return None
    prefix = f"{phase}.{run.entry.config['codec']}."
    calls = {}  # id(outermost span) -> [outermost span, its first launch, the call's records]
    for s in profiling.spans():  # in the order the spans opened
        root = s.root()
        call = calls.setdefault(id(root), [root, None, []])
        call[2].append(s)
        if call[1] is None and s.name.startswith(prefix) and s.name.endswith(".launch") and s.end_ns is not None:
            call[1] = s
    us = []
    for root, launch, records in calls.values():
        if launch is None:
            continue
        t0, t1 = root.open_ns, launch.close_ns
        tracer = sum(s.open_ns - s.start_ns for s in records if s is not root and s.start_ns < t1)
        tracer += sum(s.end_ns - s.close_ns for s in records if s.end_ns is not None and s.end_ns <= t1)
        us.append((t1 - t0 - tracer) / 1e3)
    return statistics.median(us) if us else None


def device_ms(name: str) -> float | None:
    """The median CUDA-event time of the device-timed spans named ``name``,
    in ms."""
    profiling = _profiling()
    if profiling is None:
        return None
    ms = [s.device_ms() for s in profiling.spans() if s.name == name and s.events is not None]
    return statistics.median(ms) if ms else None


def ns_per_seq(run, phase: str, step: str) -> float | None:
    """A kernel's device time a call over the sequences a call, in ns a
    sequence: the ``<codec>_<step>_kernel``'s time in the phase's traced
    window (``Window.op_s``) over the window's calls, divided by the
    kernels' ``<codec>.<step>.sequences`` counter over the
    ``<phase>.<codec>.<step>`` spans."""
    profiling = _profiling()
    w = run.windows.get(phase)
    if w is None or profiling is None:
        return None
    codec = run.entry.config["codec"]
    kernel_s = sum(v for k, v in w.op_s.items() if f"{codec}_{step}_kernel" in k)
    calls = sum(1 for s in profiling.spans() if s.name == f"{phase}.{codec}.{step}")
    sequences = profiling.counters().get(f"{codec}.{step}.sequences", 0)
    if not (kernel_s and calls and sequences):
        return None
    return 1e9 * (kernel_s / w.calls) / (sequences / calls)


def share_pct(part: str, whole: str) -> float | None:
    """100 x the kernels' counter ``part`` over their counter ``whole``, in %."""
    profiling = _profiling()
    if profiling is None:
        return None
    c = profiling.counters()
    return 100.0 * c.get(part, 0) / c[whole] if c.get(whole) else None
