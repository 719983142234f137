"""The Snappy decode kernel's device time a call over the elements its walk
completed a call, in ns an element: ``snappy_decode_kernel``'s time in the
decompress window (``Window.op_s``; the rewrite kernel that follows it is
not counted) over the window's calls, divided by the kernel's
``snappy.decode.elements`` counter over the ``decompress.snappy.decode``
spans (``benchmark/metrics/_port_spans.py`` reads ``.sequences`` only)."""

from benchmark.metrics import _port_spans as port_spans


def read(run):
    profiling = port_spans._profiling()
    w = run.windows.get("decompress")
    if w is None or profiling is None:
        return None
    kernel_s = sum(v for k, v in w.op_s.items() if "snappy_decode_kernel" in k)
    calls = sum(1 for s in profiling.spans() if s.name == "decompress.snappy.decode")
    elements = profiling.counters().get("snappy.decode.elements", 0)
    if not (kernel_s and calls and elements):
        return None
    return 1e9 * (kernel_s / w.calls) / (elements / calls)
