"""The port's tracer, timing on the card with CUDA events, and profiler traces.

Tracing is on exactly while a ``torch.profiler`` records (``trace`` below,
or any ``torch.profiler.profile``); there is no flag of its own.  While it
is on:

- ``span(name)`` opens a ``record_function`` range, which lands in the
  profiler's Chrome trace on the device trace's clock beside the kernels it
  launches, and keeps a record (``SpanRecord``: name, parent, and four
  host stamps: before and after the span's own entry, before and after its
  own exit, so that a reader can take the tracer's cost out of an
  interval); ``device=`` a CUDA device adds a pair of CUDA events on that
  device's current stream, whose elapsed time (``SpanRecord.device_ms``) is
  the stream's time across the span's work, read only when asked;
- ``counter_ptr(name, device)`` gives a kernel wrapper the address of a
  counter in a small int64 buffer on the device, which the kernel adds to;
  the buffer is made and zeroed at the first launch made while tracing is
  on.

Off, ``span`` returns one shared null context after a single check of
``torch.autograd.profiler._is_profiler_enabled`` (which the profiler sets),
and ``counter_ptr`` gives None, which the kernels
take as "count nothing": no record, no range, no event, no device buffer.

``spans()``, ``counters()`` (which copies the device counters to the host
then, and only then) and ``dropped()`` read what was recorded; records are
kept up to ``MAX_RECORDS`` and counted past it; ``reset()`` clears records
and counters.  Records accumulate across profiler sessions until then.

The spans are named ``<phase>.<layer>[.<step>]``, the phase being
``compress`` or ``decompress``:

=====================================  ==============================================================
layer                                  spans
=====================================  ==============================================================
batch API (``lowlevel/api.py``)        ``compress.api``, ``decompress.api``
managers (``highlevel/manager.py``)    ``compress.manager`` (``.stage``, ``.assemble``, device-timed);
                                       ``decompress.manager.open`` (``create_manager``'s header read);
                                       ``decompress.manager`` (``.read_header``, ``.slice``,
                                       device-timed); on the card ``.assemble`` and ``.slice`` hold
                                       the copy kernel's ``.launch``
codec routing (``codecs/*.py``)        ``<phase>.lz4``, ``<phase>.snappy``, ``<phase>.cascaded``
kernel wrappers (``kernels/*_cuda.py``) ``compress.<lz4|snappy>.table``, ``compress.<codec>.encode``,
                                       ``decompress.<codec>.decode``, each with a ``.launch`` child
                                       around the foreign call alone
=====================================  ==============================================================

The device counters (``COUNTERS``): ``cascaded.encode.chunks`` (chunks the
encode kernel ran through its pipeline), ``cascaded.encode.chunks_discarded``
(those of them in partitions that then fell back raw),
``cascaded.encode.partitions_raw`` (non-empty partitions stored raw),
``cascaded.decode.chunks`` (chunks the decode kernel ran through its
pipeline), ``cascaded.decode.partitions_raw`` (non-empty partitions it
copied raw), ``lz4.encode.sequences`` / ``snappy.encode.sequences``
(sequences the encode walk emitted), ``lz4.decode.sequences`` (sequences the decode walk
completed), ``lz4.decode.handoffs`` (the ring slots the LZ4 decode kernel's walker warp
filled for its copier warp) and ``lz4.decode.walker_waits`` (the fills at which the
walker found the ring full and waited on the copier), ``snappy.decode.elements`` (elements the decode walk
completed), and the match-table kernel's, for rows of up to 64 KB (LZ4
and Snappy alike): ``lz.table.positions`` (the valid positions it grouped)
and ``lz.table.large_bucket_positions`` (those in buckets of more than 32,
which it sorts); the managers' copy kernel's ``manager.pack.bytes`` and
``manager.unpack.bytes`` (the stream bytes each entry point copied: an
artifact's ``comp_data_size`` a sound call).

``wall`` times each call of a function between two CUDA events on the
current stream, after warm-up, and reports the median, min and max; it
needs a CUDA device and raises without one instead of timing the CPU.
``trace`` records a ``torch.profiler`` trace into a directory
(TensorBoard's format, a Chrome trace), and ``annotate`` names a range in
it (counterparts of ``tpucomp.utils.profiling.trace`` and ``annotate``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import threading
import time
from typing import Callable

import torch
import torch.autograd.profiler as _autograd_profiler

MAX_RECORDS = 1 << 17  # span records kept; later ones are counted in dropped()
COUNTERS = (
    "cascaded.encode.chunks",
    "cascaded.encode.chunks_discarded",
    "cascaded.encode.partitions_raw",
    "cascaded.decode.chunks",
    "cascaded.decode.partitions_raw",  # the kernel adds to the slot after cascaded.decode.chunks
    "lz4.encode.sequences",
    "lz4.decode.sequences",
    "lz4.decode.handoffs",  # the kernel adds to the two slots after lz4.decode.sequences
    "lz4.decode.walker_waits",
    "snappy.encode.sequences",
    "snappy.decode.elements",
    "lz.table.positions",
    "lz.table.large_bucket_positions",  # the kernel adds to the slot after lz.table.positions
    "manager.pack.bytes",
    "manager.unpack.bytes",
)
_SLOT = {name: i for i, name in enumerate(COUNTERS)}
_NULL = contextlib.nullcontext()


@dataclasses.dataclass(eq=False, slots=True)
class SpanRecord:
    name: str
    parent: SpanRecord | None
    start_ns: int                 # host clock, time.perf_counter_ns, before the span's entry
    end_ns: int | None = None     # after its exit; None while the span is open
    events: tuple | None = None   # (start, end) CUDA events of a device-timed span
    open_ns: int | None = None    # after its entry: the body starts
    close_ns: int | None = None   # before its exit: the body has ended

    def cost_ns(self) -> int:
        """The host time the span's own entry and exit took (the range, the
        record, the events): the tracer's cost, not the port's work."""
        return self.open_ns - self.start_ns + self.end_ns - self.close_ns

    def device_ms(self) -> float | None:
        """The stream's time across the span, in ms (waits for the end
        event); None for a span that was not device-timed."""
        if self.events is None:
            return None
        self.events[1].synchronize()
        return self.events[0].elapsed_time(self.events[1])

    def root(self) -> SpanRecord:
        s = self
        while s.parent is not None:
            s = s.parent
        return s


class _Tracer:
    """What was recorded while tracing was on: span records and the device
    counter buffers, one per device."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()  # each thread's stack of open spans
        self.records: list[SpanRecord] = []
        self.dropped = 0
        self.buffers: dict[torch.device, torch.Tensor] = {}

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s


_tracer = _Tracer()


class _Span:
    __slots__ = ("name", "stream", "range", "record")

    def __init__(self, name: str, device: torch.device | None):
        self.name = name
        timed = device is not None and device.type == "cuda"
        self.stream = torch.cuda.current_stream(device) if timed else None

    def __enter__(self):
        stack = _tracer.stack()
        name = self.name
        if name.startswith("."):  # relative to the innermost open span
            name = stack[-1].name + name if stack else name[1:]
        # the host interval holds the span's own cost, so a parent's self time holds none of it
        rec = SpanRecord(name, stack[-1] if stack else None, time.perf_counter_ns())
        self.range = torch.profiler.record_function(name)
        self.range.__enter__()
        if self.stream is not None:
            rec.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            rec.events[0].record(self.stream)
        with _tracer.lock:
            if len(_tracer.records) < MAX_RECORDS:
                _tracer.records.append(rec)
            else:
                _tracer.dropped += 1
        stack.append(rec)
        self.record = rec
        rec.open_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc):
        rec = self.record
        rec.close_ns = time.perf_counter_ns()
        _tracer.stack().pop()
        if rec.events is not None:
            rec.events[1].record(self.stream)
        self.range.__exit__(*exc)
        rec.end_ns = time.perf_counter_ns()
        return False


def span(name: str, device: torch.device | None = None):
    """A span of the port named ``name`` (see the module's docstring; a
    name that starts with ``.`` follows the innermost open span's:
    ``.launch`` inside ``compress.lz4.encode`` is
    ``compress.lz4.encode.launch``, and ``launch`` outside any).
    ``device``: a CUDA device times the span's work on that device's
    current stream with CUDA events (a CPU device or None does not).  Off,
    the shared null context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, device)


def counter_ptr(name: str, device: torch.device) -> int | None:
    """The address of device counter ``name`` (one of ``COUNTERS``) on
    ``device``, for a kernel to add to, or None while tracing is off (the
    kernels then count nothing).  The device's buffer is made, zeroed, at
    the first call made while tracing is on."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    buf = _tracer.buffers.get(device)
    if buf is None:
        buf = _tracer.buffers[device] = torch.zeros(len(COUNTERS), dtype=torch.int64, device=device)
    return buf.data_ptr() + buf.element_size() * _SLOT[name]


def spans() -> list[SpanRecord]:
    """The span records, in the order the spans opened."""
    with _tracer.lock:
        return list(_tracer.records)


def counters() -> dict[str, int]:
    """The device counters summed over devices (copied from the devices
    now), or an empty dict where no device buffer was made."""
    with _tracer.lock:
        buffers = list(_tracer.buffers.values())
    out = {}
    for buf in buffers:
        for name, v in zip(COUNTERS, buf.tolist()):
            out[name] = out.get(name, 0) + v
    return out


def dropped() -> int:
    """Spans not recorded because ``MAX_RECORDS`` were."""
    return _tracer.dropped


def reset() -> None:
    """Clears the records, the dropped count and every counter (the device
    buffers go, and are made anew at the next traced launch)."""
    with _tracer.lock:
        _tracer.records.clear()
        _tracer.dropped = 0
        _tracer.buffers.clear()


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
    it ends: host activity, and the card's when there is one.  The port's
    spans are on inside it."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield


annotate = torch.profiler.record_function  # ``with annotate(name):`` names a range in profiler traces
