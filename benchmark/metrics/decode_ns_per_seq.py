"""`<codec>_decode_ns_per_seq`: the decode kernel's device time a call over the
sequences its walk completed a call (the kernel's ``<codec>.decode.sequences``
counter), in ns a sequence (``benchmark/metrics/_port_spans.py``)."""

from benchmark.metrics import _port_spans as port_spans


def read(run):
    return port_spans.ns_per_seq(run, "decompress", "decode")
