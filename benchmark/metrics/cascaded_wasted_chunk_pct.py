"""The Cascaded encode work that the raw fallback throws away: 100 x the
chunks the encode kernel ran through its pipeline in partitions that then
fell back raw (``cascaded.encode.chunks_discarded``) over all the chunks it
ran (``cascaded.encode.chunks``), counted in the kernel while tracing was
on, in % (``benchmark/metrics/_port_spans.py``)."""

from benchmark.metrics import _port_spans as port_spans


def read(run):
    return port_spans.share_pct("cascaded.encode.chunks_discarded", "cascaded.encode.chunks")
