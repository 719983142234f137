"""The device time of the manager's ``compress.manager.assemble`` span a call:
the median CUDA-event time over the traced compress calls, in ms
(``benchmark/metrics/_port_spans.py``)."""

from benchmark.metrics import _port_spans as port_spans


def read(run):
    return port_spans.device_ms("compress.manager.assemble")
