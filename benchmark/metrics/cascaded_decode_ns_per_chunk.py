"""The Cascaded decode kernel's device time a call over the chunks it ran
through its pipeline a call, in ns a chunk: ``cascaded_decode_kernel``'s
time in the decompress window (``Window.op_s``, either instantiation) over
the window's calls, divided by the kernel's ``cascaded.decode.chunks``
counter over the ``decompress.cascaded.decode`` spans.  None where the
port has no such counter (``benchmark/metrics/_port_spans.py`` reads
``.sequences`` only)."""

from benchmark.metrics import _port_spans as port_spans


def read(run):
    profiling = port_spans._profiling()
    w = run.windows.get("decompress")
    if w is None or profiling is None:
        return None
    kernel_s = sum(v for k, v in w.op_s.items() if "cascaded_decode_kernel" in k)
    calls = sum(1 for s in profiling.spans() if s.name == "decompress.cascaded.decode")
    chunks = profiling.counters().get("cascaded.decode.chunks", 0)
    if not (kernel_s and calls and chunks):
        return None
    return 1e9 * (kernel_s / w.calls) / (chunks / calls)
