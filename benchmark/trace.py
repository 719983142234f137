"""One ``torch.profiler`` window over back-to-back calls, reduced to what
the per-layer metrics read.

The window is a span of the benchmark's own (``<phase>.window``) that
ends on a synchronise, so every device operation of its calls lies in
it.  Inside it, each call is a ``<phase>.call`` span and its host read a
``<phase>.<read>`` span.  From the profiler's Chrome trace: the device
operations (kernels, copies, fills) in the window, the union of their
intervals (busy time), and each idle gap labelled by the innermost of the
benchmark's spans the host was in at the gap's middle.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import warnings
from collections import defaultdict

from benchmark import stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 200  # a templated kernel's name is cut to this many characters


@dataclasses.dataclass
class Window:
    calls: int
    window_s: float
    busy_s: float
    ops: int                    # device operations in the window
    op_s: dict                  # device seconds by operation name
    idle_s: dict                # idle seconds by the host span it fell in

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)


def span_factory(profiler_on: bool):
    """``record_function`` under the profiler; a no-op otherwise, so the
    untraced runs pay nothing for the spans."""
    if not profiler_on:
        return lambda name: contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function


def profile(phase: str, loop, warm):
    """Run ``loop(span)`` (whose result has ``calls``) inside a profiled
    ``<phase>.window`` span, after one call of ``warm()`` under the
    profiler but outside the window (the profiler's own start-up lands
    there); returns (loop's result, Window)."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with warnings.catch_warnings(), torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        warnings.simplefilter("ignore", UserWarning)  # "Profiler clears events at the end of each cycle"
        warm()
        torch.cuda.synchronize()
        with record_function(f"{phase}.window"):
            result = loop(span_factory(True))
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix=f"bench-trace-{phase}-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    return result, reduce(events, phase, result.calls)


def reduce(trace, phase: str, calls: int) -> Window:
    """A Chrome trace (a dict with ``traceEvents`` or a list of events,
    times in microseconds) reduced to the ``<phase>.window`` span's Window."""
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    complete = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
    win = [e for e in complete if e.get("cat") == "user_annotation" and e.get("name") == f"{phase}.window"]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} '{phase}.window' spans, not 1")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = []
    op_s = defaultdict(float)
    for e in complete:
        if e.get("cat") in DEVICE_CATS:
            s, d = float(e["ts"]), float(e["dur"])
            if s < w1 and s + d > w0:
                dev.append((max(s, w0), min(s + d, w1)))
                op_s[e["name"][:NAME_CHARS]] += d / 1e6
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in complete
             if e.get("cat") == "user_annotation" and e.get("name", "").startswith(f"{phase}.")
             and e["name"] != f"{phase}.window"]
    idle_s = defaultdict(float)
    for s, e in stats.gaps(dev, w0, w1):
        mid = (s + e) / 2
        inside = [sp for sp in spans if sp[0] <= mid < sp[1]]
        label = min(inside, key=lambda sp: sp[1] - sp[0])[2] if inside else f"{phase}.between_calls"
        idle_s[label] += (e - s) / 1e6
    return Window(calls=calls, window_s=(w1 - w0) / 1e6, busy_s=stats.union_length(dev) / 1e6, ops=len(dev),
                  op_s=dict(op_s), idle_s=dict(idle_s))
