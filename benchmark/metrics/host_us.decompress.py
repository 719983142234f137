"""`host_us.decompress.<codec>`: the host time a decompress call spends in the
port before its first kernel is launched, less the tracer's own cost, median
over the traced calls, in us (``benchmark/metrics/_port_spans.py``)."""

from benchmark.metrics import _port_spans as port_spans


def read(run):
    return port_spans.host_us(run, "decompress")
