"""`<codec>_encode_ns_per_seq`: the encode kernel's device time a call over the
sequences its walk emitted a call (the kernel's ``<codec>.encode.sequences``
counter), in ns a sequence (``benchmark/metrics/_port_spans.py``)."""

from benchmark.metrics import _port_spans as port_spans


def read(run):
    return port_spans.ns_per_seq(run, "compress", "encode")
